"""Chunk-prefix attention partials for chunked prefill: plain versions
and the CUDA kernel wrappers.

Counterparts of ``repro.kernels.vwr_decode``'s
``vwr_chunk_prefix_attend_p`` and ``vwr_chunk_prefix_attend_q8_p``
(both kernels in ``csrc/vwr_chunk_prefix.cu``).  One prompt chunk's
queries ``(KV, C*G, D)`` — the C chunk tokens' G query heads of each KV
head, kv-major — attend the prompt's J prior pages of an
``(n_pages, page_size, KV, D)`` pool: logical page j is physical page
``table[j]`` with ``counts[j]`` valid keys (0 masks the page).  The int8
pools carry fp32 ``(n_pages, KV)`` scales.  Returns the unnormalized
fp32 partials ``(o_tilde, m, l)``; a row with no valid key gives
``m = -1e30, l = 0, o_tilde = 0``, which ``models.attention.
merge_partials`` folds into the chunk's causal self partial as an exact
no-op.  The kernels take a head dim D in {32, 64, 128}; a narrower D
(the reduced configs' 16) is zero-padded to the next of those, query and
pools, on each call, with the scale of the true width
(``widths.at_widths``): acceptable at reduced widths, and nothing is
copied at D 64 or 128.

Kernels 6 and 8 have two kernels each, and ``chunk_variant`` picks one
per call: ``"wgmma"`` (bf16 queries at D 32 / 64 / 128, pages of a
multiple of 8 rows: 64 chunk rows a block as wgmma's M, 64-key tiles from
the page walk ``key_tiles``, P as two bf16 terms, the table cut into
``chunk_plan``'s splits, one block a split, merged by the row group's
last block in the same launch; over kernel 8's int8 pools each tile lands
in int8 and is converted exactly to bf16, each score column takes scale
times its page's k scale in fp32 and P its page's v scale before the
split; ``chunk_wgmma_emulation`` is the arithmetic in plain PyTorch) or
``"fma"`` (fp32 queries, pages off 8: the FMA kernel).
``build.VARIANTS`` counts both variants of each.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, widths
from repro_torch.kernels.vwr_decode import SMS, bf16_terms, combine_partials

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
# kernel 6's wgmma variant (csrc CW_*): query rows a block, key slots a
# tile, its page rows (a multiple of 8), at most CHUNK_MAX_SPLITS splits
# (the last block reads every split's partial); chunk_plan aims at
# CHUNK_BLOCKS blocks (measured on the H100 against 1 and 2 an SM,
# PERF.md)
CHUNK_ROWS, CHUNK_KEYS, WGMMA_PAGE_ROWS = 64, 64, 8
CHUNK_MAX_SPLITS = 32
CHUNK_BLOCKS = 4 * SMS

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _chunk_partials(q, k, v, counts, scale):
    """q: (KV, CG, D); k, v: (J, ps, KV, D) fp32 gathered pages; counts:
    (J,) valid keys per page; ``scale`` 1/sqrt(D) unless given."""
    KV, CG, D = q.shape
    J, ps = k.shape[:2]
    f32 = dict(dtype=torch.float32, device=q.device)
    if J * ps == 0:
        return (torch.zeros((KV, CG, D), **f32),
                torch.full((KV, CG), NEG_INF, **f32),
                torch.zeros((KV, CG), **f32))
    qf = q.float() * (1.0 / D ** 0.5 if scale is None else scale)
    s = torch.einsum("hcd,thd->hct", qf, k.reshape(J * ps, KV, D))
    valid = (torch.arange(ps, device=q.device)[None, :]
             < counts[:, None]).reshape(J * ps)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    o_t = torch.einsum("hct,thd->hcd", p, v.reshape(J * ps, KV, D))
    return o_t, m, p.sum(-1)


def vwr_chunk_prefix_attend_ref(q, k_pool, v_pool, table, counts, *,
                                scale=None):
    """Plain version.  q: (KV, C*G, D); k_pool, v_pool: (n_pages,
    page_size, KV, D); table, counts: (J,) int — the chunk's prior page
    j is physical page ``table[j]`` (clamped to [0, n_pages)) with
    ``counts[j]`` valid keys.  Returns fp32 (o_tilde (KV, C*G, D),
    m (KV, C*G), l (KV, C*G))."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    return _chunk_partials(q, k_pool[tbl].float(), v_pool[tbl].float(),
                           counts, scale)


def vwr_chunk_prefix_attend_q8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   table, counts, *, scale=None):
    """Plain version over int8 pools (n_pages, page_size, KV, D) with
    fp32 (n_pages, KV) scales: the gathered pages are dequantized, then
    as ``vwr_chunk_prefix_attend_ref``."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    k = k_pool[tbl].float() * k_scale[tbl][:, None, :, None]
    v = v_pool[tbl].float() * v_scale[tbl][:, None, :, None]
    return _chunk_partials(q, k, v, counts, scale)


def _cdiv(a, b):
    return -(-a // b)


def chunk_variant(CG, D, page_size, dtype):
    """The kernel that serves a ``vwr_chunk_prefix_attend`` or
    ``vwr_chunk_prefix_attend_q8`` call at the kernel's widths (after
    ``widths.at_widths``): "wgmma" for bf16 queries (bf16 or int8 pools)
    at D 32, 64 or 128 with pages of a multiple of 8 rows, else "fma".
    A one-token chunk (8 rows at G 8) takes "wgmma" too: measured on the
    H100 at 16 pages, 0.013 ms against the FMA kernel's 0.050 (PERF.md)."""
    if (dtype == torch.bfloat16 and D in HEAD_DIMS and CG > 0
            and page_size > 0 and page_size % WGMMA_PAGE_ROWS == 0):
        return "wgmma"
    return "fma"


@functools.lru_cache(maxsize=4096)
def chunk_plan(KV, CG, J, page_size):
    """(nsplit, table entries a split) of the wgmma variant: the J prior
    pages in nsplit splits of whole key tiles (64 / page_size pages a
    tile, or a page of ceil(page_size / 64) tiles), as many as bring the
    KV * ceil(CG / 64) row blocks near ``CHUNK_BLOCKS`` blocks (at most
    ``CHUNK_MAX_SPLITS``, at most one a tile of full pages), sized evenly
    so that no split starts at or past J.  J 0 gives one split (the empty
    partial)."""
    groups = KV * _cdiv(CG, CHUNK_ROWS)
    if page_size <= CHUNK_KEYS:
        per_tile = CHUNK_KEYS // page_size
        n_tiles = _cdiv(J, per_tile)
    else:
        per_page = _cdiv(page_size, CHUNK_KEYS)
        n_tiles = J * per_page
    want = min(CHUNK_MAX_SPLITS, max(1, _cdiv(CHUNK_BLOCKS, groups)),
               max(1, n_tiles))
    tiles = max(1, _cdiv(n_tiles, want))
    jps = (tiles * per_tile if page_size <= CHUNK_KEYS
           else _cdiv(tiles, per_page))
    return (_cdiv(J, jps) if J else 1), jps


def key_tiles(table, counts, page_size, keys=CHUNK_KEYS):
    """The wgmma variants' walk over a table (kernel 6's 64-key tiles,
    kernel 12's 32): a list of key tiles, each ``keys`` pool rows (page *
    page_size + row), -1 for a masked slot.  A tile holds ``keys // seg``
    segments of ``seg = min(page_size, keys)`` rows of one page each;
    count-0 pages are skipped; entries are clamped to [0, n_pages) by the
    caller (common.cuh next_tile)."""
    seg = min(page_size, keys)
    rows = []
    for j, page in enumerate(table):
        cnt = min(int(counts[j]), page_size)
        for o in range(0, max(cnt, 0), seg):
            rows.append([page * page_size + o + i if o + i < cnt else -1
                         for i in range(seg)])
    per = keys // seg
    tiles = []
    for t in range(0, len(rows), per):
        tile = [r for seg_rows in rows[t:t + per] for r in seg_rows]
        tiles.append(tile + [-1] * (keys - len(tile)))
    return tiles


def chunk_wgmma_emulation(q, k_pool, v_pool, table, counts, plan=None,
                          terms=2, scales=None):
    """The wgmma variant's arithmetic in plain PyTorch (the tests hold it
    against ``vwr_chunk_prefix_attend_ref`` and the JAX op): per split
    (``chunk_plan``'s unless ``plan`` is given) the split's pages walked
    into 64-key tiles (``key_tiles``), scores (q . k) * scale of the bf16
    values in fp32, masked per slot, an fp32 online softmax, P as
    ``terms`` bf16 terms against V; the splits merged in split order
    (``combine_partials``).  ``scales``: kernel 8's int8 pools with their
    (n_pages, KV) (k_scale, v_scale): the int8 values exact in bf16, each
    score column times scale * its page's k scale, P times its column's v
    scale before the split into terms, l over the unscaled P.  Returns
    fp32 (o_tilde (KV, C*G, D), m (KV, C*G), l (KV, C*G))."""
    KV, CG, D = q.shape
    n_pages, ps = k_pool.shape[:2]
    J = table.shape[0]
    scale = 1.0 / D ** 0.5
    nsplit, jps = plan or chunk_plan(KV, CG, J, ps)
    qf = q.bfloat16().float()
    kf, vf = (t.bfloat16().float().reshape(n_pages * ps, KV, D)
              for t in (k_pool, v_pool))
    tbl = table.long().clamp(0, n_pages - 1).tolist()
    cnt = counts.tolist()
    f32 = dict(dtype=torch.float32, device=q.device)
    splits = []
    for sp in range(nsplit):
        j0, j1 = sp * jps, min(J, (sp + 1) * jps)
        o = torch.zeros((KV, CG, D), **f32)
        m = torch.full((KV, CG), NEG_INF, **f32)
        l = torch.zeros((KV, CG), **f32)
        for tile in key_tiles(tbl[j0:j1], cnt[j0:j1], ps):
            idx = torch.tensor([max(t, 0) for t in tile], device=q.device)
            ok = torch.tensor([t >= 0 for t in tile], device=q.device)
            kc, vc = kf[idx], vf[idx]
            # a slot's factors (KV, 1, keys): scale, and its page's scales
            sk = torch.full((KV, 1, len(tile)), scale, **f32)
            vs = torch.ones((KV, 1, len(tile)), **f32)
            if scales is not None:
                page = idx // ps
                sk = (scale * scales[0].float()[page]).T[:, None]
                vs = scales[1].float()[page].T[:, None]
            sc = torch.einsum("hcd,thd->hct", qf, kc) * sk
            sc = torch.where(ok, sc, NEG_INF)
            mx = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - mx)
            p = torch.where(ok, torch.exp(sc - mx[..., None]), 0.0)
            pv = sum(torch.einsum("hct,thd->hcd", t, vc)
                     for t in bf16_terms(p * vs, terms))
            o, m, l = o * corr[..., None] + pv, mx, l * corr + p.sum(-1)
        splits.append((o, m, l))
    return combine_partials(splits)


def _chunk_launch(kernel, q, k_pool, v_pool, table, counts, scales):
    scale = 1.0 / q.shape[-1] ** 0.5
    return widths.at_widths(
        lambda q, k_pool, v_pool: _chunk_kernel(
            kernel, q, k_pool, v_pool, table, counts, scales, scale),
        [((q, k_pool, v_pool), HEAD_DIMS)], kernel)


def _chunk_kernel(kernel, q, k_pool, v_pool, table, counts, scales, scale):
    KV, CG, D = q.shape
    n_pages, ps, KVp, Dp = k_pool.shape
    J = table.shape[0]
    if KVp != KV or Dp != D or n_pages < 1:
        raise ValueError(f"{kernel}: needs q (KV, C*G, D) against pools "
                         f"(n_pages>=1, ps, KV, D) and a (J,) table; got q "
                         f"{tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"table {tuple(table.shape)}")
    pool_dt = torch.int8 if scales else q.dtype
    build.check_operands(kernel, q.dtype, q=(q, (KV, CG, D)))
    build.check_operands(kernel, pool_dt, k_pool=(k_pool, k_pool.shape),
                         v_pool=(v_pool, k_pool.shape))
    build.check_operands(kernel, torch.int32, table=(table, (J,)),
                         counts=(counts, (J,)))
    if scales:
        build.check_operands(kernel, torch.float32,
                             k_scale=(scales[0], (n_pages, KV)),
                             v_scale=(scales[1], (n_pages, KV)))
    return chunk_launch(q, k_pool, v_pool, table, counts,
                        chunk_variant(CG, D, ps, q.dtype), scale=scale,
                        scales=scales)


def _launch_fma(kernel, q, k_pool, v_pool, table, counts, scales, scale,
                code):
    KV, CG, D = q.shape
    n_pages, ps = k_pool.shape[:2]
    J = table.shape[0]
    f32 = dict(dtype=torch.float32, device=q.device)
    o_t = torch.empty((KV, CG, D), **f32)
    m = torch.empty((KV, CG), **f32)
    l = torch.empty((KV, CG), **f32)
    ptrs = [q, k_pool, v_pool, *scales, table, counts, o_t, m, l]
    lib, fn = build.kernel_fn("vwr_chunk_prefix", f"{kernel}_launch",
                              [_VP] * len(ptrs) + [_I] * 6
                              + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), CG, J, n_pages, ps, KV, D,
             scale, code, build.stream_of(q))
    build.check(lib, err, kernel)
    return o_t, m, l


def chunk_launch(q, k_pool, v_pool, table, counts, kind, plan=None,
                 scale=None, scales=()):
    """One launch of kernel 6's variant ``kind`` ("wgmma" or "fma") on
    operands ``vwr_chunk_prefix_attend`` checked, with ``chunk_plan``'s
    plan unless ``plan`` is given; with ``scales`` (the int8 pools'
    (k_scale, v_scale)) kernel 8's, on operands
    ``vwr_chunk_prefix_attend_q8`` checked.  chip_smoke.py times the
    variants and plans against each other through it."""
    KV, CG, D = q.shape
    n_pages, ps = k_pool.shape[:2]
    J = table.shape[0]
    scale = 1.0 / D ** 0.5 if scale is None else scale
    kernel = "vwr_chunk_prefix_attend" + ("_q8" if scales else "")
    if kind == "fma":
        out = _launch_fma(kernel, q, k_pool, v_pool, table, counts, scales,
                          scale, build.dtype_code(q.dtype))
    else:
        nsplit, jps = plan or chunk_plan(KV, CG, J, ps)
        groups = KV * _cdiv(CG, CHUNK_ROWS)
        stream = build.stream_of(q)
        ws = build.split_workspace(
            q.device, stream, groups * nsplit * CHUNK_ROWS * (D + 2))
        counters = build.split_counters(q.device, stream, groups)
        f32 = dict(dtype=torch.float32, device=q.device)
        out = (torch.empty((KV, CG, D), **f32),
               torch.empty((KV, CG), **f32), torch.empty((KV, CG), **f32))
        ptrs = [q, k_pool, v_pool, *scales, table, counts, *out, ws,
                counters]
        lib, fn = build.kernel_fn("vwr_chunk_prefix", f"{kernel}_wgmma_launch",
                                  [_VP] * len(ptrs) + [_I] * 8 + [_F, _VP])
        err = fn(*(t.data_ptr() for t in ptrs), CG, J, n_pages, ps, KV, D,
                 nsplit, jps, scale, stream)
        build.check(lib, err, kernel)
    build.count_launch(kernel, kind)
    return out


def vwr_chunk_prefix_attend(q, k_pool, v_pool, table, counts):
    """q: (KV, C*G, D) kv-major; k_pool, v_pool: (n_pages, page_size, KV,
    D) in q's dtype; table, counts: (J,) int32.  Returns fp32
    (o_tilde, m, l) as ``vwr_chunk_prefix_attend_ref``; the kernel also
    clamps each table entry it reads."""
    if q.device.type == "cpu":
        return vwr_chunk_prefix_attend_ref(q, k_pool, v_pool, table,
                                           counts)
    return _chunk_launch("vwr_chunk_prefix_attend", q, k_pool, v_pool,
                         table, counts, ())


def vwr_chunk_prefix_attend_q8(q, k_pool, v_pool, k_scale, v_scale, table,
                               counts):
    """``vwr_chunk_prefix_attend`` over int8 pools with fp32
    (n_pages, KV) scales; q stays in the model dtype."""
    if q.device.type == "cpu":
        return vwr_chunk_prefix_attend_q8_ref(q, k_pool, v_pool, k_scale,
                                              v_scale, table, counts)
    return _chunk_launch("vwr_chunk_prefix_attend_q8", q, k_pool, v_pool,
                         table, counts, (k_scale, v_scale))
