"""Absorbed-MLA flash-decode partials against a dense latent cache or
latent page pools, and a prompt chunk's partials against its prior latent
pages: plain versions and the CUDA kernel wrappers.

Counterparts of ``repro.kernels.vwr_decode``'s ``vwr_mla_flash_decode_p``,
``vwr_mla_flash_decode_q8_p``, ``vwr_mla_paged_flash_decode_p``,
``vwr_mla_paged_flash_decode_q8_p``, ``vwr_mla_chunk_prefix_attend_p``
and ``vwr_mla_chunk_prefix_attend_q8_p`` (all six in
``csrc/vwr_mla_decode.cu``).  The queries come folded through ``wk_b``
(``models.mla.mla_absorbed_queries``): ``q_abs`` (B, H, r) and
``q_rope`` (B, H, rope), fp32.  A key's score is
``(q_abs . c_kv + q_rope . k_rope) * scale`` and its value is the latent
row ``c_kv`` itself, so the two caches are read once each, as separate
operands.

The dense cache is ``c_kv`` (B, T, r) / ``k_rope`` (B, T, rope) whose
first position has global index ``pos0``; positions with
``pos0 + idx < cur_len`` are valid.  The pools are (n_pages, page_size,
r) / (n_pages, page_size, rope): logical page j of slot b is the
physical page ``table[b, j]`` (clamped to [0, n_pages)) holding
``counts[b, j]`` valid keys, 0 masking the page.  A chunk's C tokens
(``q_abs`` (C, H, r)) share one (J,) table and counts: the decode
contract of the pools with every token reading the same pages.  int8
caches carry fp32
scales, one a sequence (B,) for the dense cache and one a page
(n_pages,) for the pools, separately for the latent and the rope part.

Returns the unnormalized fp32 partials ``(o_tilde (B, H, r), m (B, H),
l (B, H))``; a head with no valid key gives ``m = -1e30, l = 0,
o_tilde = 0``.  The kernels take r in {32, ..., 512} and rope in {32,
64}; a narrower r or rope (the reduced configs' 16 and 8) is zero-padded
to the next of those, queries and caches, on each call (zeros change no
score, and the padded latent columns of o_tilde are sliced off): on the
pools of a reduced config that copies the whole pool a call, which is
acceptable at reduced widths.  Nothing is copied at DeepSeek-V3's r 512,
rope 64.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.

Kernels 10, 11, 13 and 14 have two kernels each, and ``decode_variant``
picks one per call: ``"wgmma"`` (bf16 and int8 caches and pools at r
128 / 256 / 512, rope 32 / 64, pages of a multiple of 8 rows: 64 of a
sequence's heads as wgmma rows, the fp32 queries and P each split into
two bf16 terms, the keys in 32-slot tiles of the sequence's table row or
slab; ``mla_decode_plan`` cuts a row group's keys into splits, one block
a split, merged by the group's last block in the same launch, and its
output columns into column blocks; over kernel 13's int8 pools and
kernel 14's int8 slab the terms are kernel 15's fp16 ones, P's power of
two taken per split, from its own pages' scales or its sequence's;
``decode_split_emulation`` is its arithmetic in plain PyTorch) or
``"fma"`` (fp32 caches and every other width: fp32 FMAs).

Kernels 12 and 15 have two kernels each, and ``chunk_variant`` picks one
per call: ``"wgmma"`` (bf16 or int8 pools at r 128 / 256 / 512, rope
32 / 64, pages of a multiple of 8 rows: the chunk's C*H rows as wgmma
rows, the fp32 queries and P each split into two bf16 terms; on int8
pools two fp16 terms of each query row and of P scaled by powers of two,
the keys converted to fp16 exactly and their page scales applied in fp32
outside the products; ``chunk_split_emulation`` is its arithmetic in
plain PyTorch) or ``"fma"`` (fp32 pools and every other width: the decode
body, fp32 FMAs).  ``build.VARIANTS`` counts the variants of kernels 10
to 15.  The split partials and counters are
``build.split_workspace`` / ``split_counters``, one buffer per (device,
stream).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, widths
from repro_torch.kernels.vwr_chunk import key_tiles
from repro_torch.kernels.vwr_decode import (SMS, bf16_terms, combine_partials,
                                            pow2_up)

NEG_INF = -1e30
# the kernel holds a lane's share of r and rope in registers: r / 32
# and rope / 32 latent and rope features a lane
RANKS = (32, 64, 128, 256, 512)
ROPES = (32, 64)
# the wgmma variant of kernels 10-12 and 15: its widths, its page rows (a
# multiple of 8: the TMA boxes of a page land on whole 8-row swizzle
# atoms), its key tile, its query rows a block
WGMMA_RANKS = (128, 256, 512)
WGMMA_PAGE_ROWS = 8
CHUNK_KEYS = 32
DECODE_ROWS = 64
# mla_decode_plan (kernels 10 and 11): at most DECODE_BLOCKS blocks (one
# an SM: a block takes ~227 KB of shared memory), at most
# DECODE_MAX_SPLITS key splits (csrc FIN_SPLITS), and of those plans the
# one its cost model puts first.  The model's us, measured on the H100 at
# DeepSeek-V3's widths (PERF.md §6): a 32-key tile's score TILE_US
# (PAGED_US more through a block table) and its P c_kv products PV_US a
# 512 columns; a block's o_tilde out O_US a 512 columns; a split's merge
# MERGE_US and MERGE_US_KB a KB of partials the group's last block reads.
DECODE_BLOCKS = SMS
DECODE_MAX_SPLITS = 32
TILE_US, PAGED_US, PV_US, O_US = 2.6, 0.7, 0.85, 4.1
MERGE_US, MERGE_US_KB = 3.3, 0.022

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def mla_partials(q_abs, q_rope, ckv, kr, valid, scale: float):
    """The plain arithmetic: q_abs (B, H, r), q_rope (B, H, rope); ckv
    (B, T, r), kr (B, T, rope) in any dtype; valid (B or 1, T) bool."""
    ckv, kr = ckv.float(), kr.float()
    s = torch.einsum("bhr,btr->bht", q_abs.float(), ckv)
    s = s + torch.einsum("bhk,btk->bht", q_rope.float(), kr)
    s = torch.where(valid[:, None, :], s * scale, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    return torch.einsum("bht,btr->bhr", p, ckv), m, p.sum(-1)


def vwr_mla_flash_decode_ref(q_abs, q_rope, c_kv, k_rope, cur_len, pos0=0,
                             *, scale: float):
    """Plain version of kernel 10: c_kv (B, T, r), k_rope (B, T, rope)."""
    T = c_kv.shape[1]
    valid = pos0 + torch.arange(T, device=c_kv.device) < cur_len
    return mla_partials(q_abs, q_rope, c_kv, k_rope, valid[None], scale)


def vwr_mla_flash_decode_q8_ref(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                                krope_scale, cur_len, pos0=0, *,
                                scale: float):
    """Plain version of kernel 14: the int8 caches dequantized with their
    fp32 (B,) scales, then as ``vwr_mla_flash_decode_ref``."""
    ckv = c_kv.float() * ckv_scale[:, None, None]
    kr = k_rope.float() * krope_scale[:, None, None]
    return vwr_mla_flash_decode_ref(q_abs, q_rope, ckv, kr, cur_len, pos0,
                                    scale=scale)


def _gather_pages(pool, table):
    """(n_pages, ps, X) pool -> (B, J*ps, X) the table's pages (clamped)."""
    B, J = table.shape
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    return pool[tbl].reshape(B, J * pool.shape[1], pool.shape[2]), tbl


def _page_valid(counts, ps):
    B, J = counts.shape
    return (torch.arange(ps, device=counts.device)[None, None, :]
            < counts[..., None]).reshape(B, J * ps)


def vwr_mla_paged_flash_decode_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                   table, counts, *, scale: float):
    """Plain version of kernel 11: gathers only the tables' pages."""
    ckv, _ = _gather_pages(ckv_pool, table)
    kr, _ = _gather_pages(krope_pool, table)
    return mla_partials(q_abs, q_rope, ckv, kr,
                        _page_valid(counts, ckv_pool.shape[1]), scale)


def vwr_mla_paged_flash_decode_q8_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                      ckv_scale, krope_scale, table, counts,
                                      *, scale: float):
    """Plain version of kernel 13: the gathered int8 pages dequantized
    with their fp32 (n_pages,) scales, then as the bf16 version."""
    ckv, tbl = _gather_pages(ckv_pool, table)
    kr, _ = _gather_pages(krope_pool, table)
    ps = ckv_pool.shape[1]
    ckv = ckv.float() * ckv_scale[tbl].repeat_interleave(ps, 1)[..., None]
    kr = kr.float() * krope_scale[tbl].repeat_interleave(ps, 1)[..., None]
    return mla_partials(q_abs, q_rope, ckv, kr, _page_valid(counts, ps),
                        scale)


def vwr_mla_chunk_prefix_attend_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                    table, counts, *, scale: float):
    """Plain version of kernel 12: q_abs (C, H, r), q_rope (C, H, rope)
    against the (J,) table's pages, as one (1, C*H) row block of kernel
    11's plain version.  Returns fp32 (o_tilde (C, H, r), m (C, H),
    l (C, H))."""
    C, H, r = q_abs.shape
    o, m, l = vwr_mla_paged_flash_decode_ref(
        q_abs.reshape(1, C * H, r), q_rope.reshape(1, C * H, -1), ckv_pool,
        krope_pool, table[None], counts[None], scale=scale)
    return o.reshape(C, H, r), m.reshape(C, H), l.reshape(C, H)


def vwr_mla_chunk_prefix_attend_q8_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                       ckv_scale, krope_scale, table, counts,
                                       *, scale: float):
    """Plain version of kernel 15: kernel 12's over the table's int8 pages
    dequantized with their fp32 (n_pages,) scales."""
    C, H, r = q_abs.shape
    o, m, l = vwr_mla_paged_flash_decode_q8_ref(
        q_abs.reshape(1, C * H, r), q_rope.reshape(1, C * H, -1), ckv_pool,
        krope_pool, ckv_scale, krope_scale, table[None], counts[None],
        scale=scale)
    return o.reshape(C, H, r), m.reshape(C, H), l.reshape(C, H)


def chunk_variant(r, rope, page_size, dtype):
    """The kernel that serves a ``vwr_mla_chunk_prefix_attend`` (bf16 or
    fp32 pools) or ``_q8`` (int8 pools) call at the kernel's widths
    (after ``widths.at_widths``): "wgmma" or "fma"."""
    if (str(dtype) in ("torch.bfloat16", "torch.int8") and r in WGMMA_RANKS
            and rope in ROPES and page_size % WGMMA_PAGE_ROWS == 0
            and page_size > 0):
        return "wgmma"
    return "fma"


def _cdiv(a, b):
    return -(-a // b)


def decode_variant(r, rope, H, page_size, dtype):
    """The kernel that serves a ``vwr_mla_flash_decode`` (``page_size``
    None: the dense cache), ``vwr_mla_paged_flash_decode`` or either's
    ``_q8`` call at the kernel's widths (after ``widths.at_widths``;
    ``dtype`` the cache's): "wgmma" for bf16 caches and pools and int8
    caches (kernel 14) and pools (kernel 13) at r 128, 256 or 512 and rope
    32 or 64, with pages of a multiple of 8 rows (any H: the rows past H
    in a sequence's last block of 64 are masked), else "fma" (fp32 caches,
    the reduced configs' padded widths)."""
    paged = page_size is not None
    if (dtype in (torch.bfloat16, torch.int8) and r in WGMMA_RANKS
            and rope in ROPES and H > 0
            and (not paged or (page_size > 0
                               and page_size % WGMMA_PAGE_ROWS == 0))):
        return "wgmma"
    return "fma"


def decode_columns(r):
    """The column blocks the wgmma kernel has an instance for at rank r:
    a warpgroup's half of a block takes >= 64 columns."""
    return tuple(c for c in (1, 2, 4) if r // c >= 2 * DECODE_ROWS)


@functools.lru_cache(maxsize=4096)
def mla_decode_plan(B, H, n, page_size=None, r=512):
    """(nsplit, per, ncol) of the wgmma variant: each of the B *
    ceil(H / 64) row groups' keys in nsplit splits of ``per`` table
    entries (pools, n = J, pages of ``page_size``) or ``per`` keys (dense,
    ``page_size`` None, n = n_keys) and its output columns in ncol column
    blocks.  Splits are whole 32-key tiles, sized evenly so that no split
    starts at or past n; of the plans within ``DECODE_BLOCKS`` blocks (one
    a group if even that is more) the cheapest by the cost model above,
    every table entry counted full.  Sized from shapes alone: the pools'
    from the table's (B, J), never from the counts (the paged step stays
    capturable).  n 0 gives one split (the empty partial)."""
    groups = B * _cdiv(H, DECODE_ROWS)
    if page_size is None:                     # keys a tile
        unit, n_tiles = CHUNK_KEYS, _cdiv(n, CHUNK_KEYS)
    elif page_size <= CHUNK_KEYS:             # whole pages a tile
        unit = CHUNK_KEYS // page_size
        n_tiles = _cdiv(n, unit)
    else:                                     # tiles a page
        unit, n_tiles = None, n * _cdiv(page_size, CHUNK_KEYS)
    tile_us = TILE_US + (0.0 if page_size is None else PAGED_US)
    best = None
    for ncol in decode_columns(r) or (1,):
        w = r / (512 * ncol)                  # a block's share of 512
        for k in range(1, min(DECODE_MAX_SPLITS, max(1, n_tiles)) + 1):
            tiles = max(1, _cdiv(n_tiles, k))
            per = (tiles * unit if unit else
                   _cdiv(tiles, _cdiv(page_size, CHUNK_KEYS)))
            nsplit = _cdiv(n, per) if n else 1
            blocks = groups * nsplit * ncol
            if blocks > DECODE_BLOCKS and (nsplit, ncol) != (1, 1):
                continue
            cost = tiles * (tile_us + PV_US * w) + O_US * w
            if nsplit > 1:
                cost += MERGE_US + MERGE_US_KB * nsplit * DECODE_ROWS * w * 2
            plan = (cost, blocks, (nsplit, per, ncol))
            best = plan if best is None or plan < best else best
    return best[2]


# kernels 15 and 13's fp16 terms: each query row (and P) is scaled by the
# power of two that brings its largest magnitude into [2^14, 2^15)
# (``pow2_up``): inside fp16's range, with lo = fp16(x - hi) still a
# normal number for every element down to 2^-17 of the largest
def _f16_terms(x, up):
    """x (fp32) as two fp16 terms of x * up, hi = fp16(x up) and lo =
    fp16(x up - hi), each returned as fp32 and divided by up again (both
    exact: up is a power of two)."""
    xs = x * up
    hi = xs.half().float()
    return hi / up, (xs - hi).half().float() / up


def _f16_query_terms(xa, xr):
    """The query rows xa (rows, r), xr (rows, rope), times scale, as two
    fp16 terms each, every row scaled by the power of two of its largest
    |x| over both parts (``_f16_terms``)."""
    up = pow2_up(torch.maximum(xa.abs().amax(-1), xr.abs().amax(-1)))
    return _f16_terms(xa, up[:, None]), _f16_terms(xr, up[:, None])


def chunk_key_tiles(table, counts, page_size):
    """The wgmma variant's walk over the table: ``vwr_chunk.key_tiles``
    with tiles of ``CHUNK_KEYS`` slots."""
    return key_tiles(table, counts, page_size, CHUNK_KEYS)


def _online_tiles(qa, qr, ckv, kr, tiles, p_terms, scales=None):
    """The wgmma kernel's loop over its key tiles for a block of query
    rows: qa, qr the query terms ((rows, r), (rows, rope) each), ckv, kr
    the keys as (N, r) / (N, rope) rows, each tile a list of row indices
    (-1: a masked slot); scores in fp32 from the terms' products, masked
    per slot, an fp32 online softmax, P as ``p_terms`` against c_kv.
    ``scales``: the int8 pools' (ckv_scale, krope_scale, page_size).
    Returns fp32 (o_tilde (rows, r), m (rows,), l (rows,))."""
    dev = dict(device=ckv.device)
    rows, r = qa[0].shape[0], ckv.shape[1]
    m = torch.full((rows,), NEG_INF, **dev)
    l = torch.zeros(rows, **dev)
    o = torch.zeros(rows, r, **dev)
    for tile in tiles:
        idx = torch.tensor([max(t, 0) for t in tile], **dev)
        ok = torch.tensor([t >= 0 for t in tile], **dev)
        kc, kp = ckv[idx], kr[idx]
        s_lat = sum(q @ kc.T for q in qa)
        s_rope = sum(q @ kp.T for q in qr)
        cs = torch.ones(len(tile), **dev)
        if scales is not None:
            # a masked slot's page scale: 0 (no segment) or its page's
            ckv_scale, krope_scale, ps = scales
            pages = idx // ps
            cs = torch.where(ok, ckv_scale.float()[pages], 0.0)
            s_lat = s_lat * cs[None]
            s_rope = s_rope * torch.where(ok, krope_scale.float()[pages],
                                          0.0)[None]
        s = torch.where(ok[None], s_lat + s_rope, NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - mx)
        p = torch.where(ok[None], torch.exp(s - mx[:, None]), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + sum(t @ kc for t in p_terms(p * cs[None]))
        m = mx
    return o, m, l


def chunk_split_emulation(q_abs, q_rope, ckv_pool, krope_pool, table, counts,
                          ckv_scale=None, krope_scale=None, *, scale: float):
    """The wgmma variant's arithmetic in plain PyTorch (the tests hold it
    against ``vwr_mla_chunk_prefix_attend_ref`` and its q8 sibling): the
    queries times scale and P each as two bf16 terms against the bf16
    pools' values, fp32 products and sums, an fp32 online softmax over the
    kernel's key tiles.  With the int8 pools' (n_pages,) scales the terms
    are fp16 (each query row, and P, scaled by the power of two
    ``pow2_up`` gives), the int8 values exact in fp16, a key's latent and
    rope sums each take their page's scale in fp32 and P takes the latent
    one before its split, while l sums the unscaled P.  Returns fp32
    (o_tilde (C, H, r), m (C, H), l (C, H))."""
    C, H, r = q_abs.shape
    n_pages, ps = ckv_pool.shape[:2]
    q8 = ckv_scale is not None
    xa = q_abs.float().reshape(C * H, r) * scale
    xr = q_rope.float().reshape(C * H, -1) * scale
    if q8:
        # int8 pools: fp16 terms, each row scaled by its power of two
        qa, qr = _f16_query_terms(xa, xr)
        # P times the latent scale, scaled by the power of two of the
        # largest scale of a counted page
        cs_pages = torch.where(counts > 0, ckv_scale.float()[
            table.long().clamp(0, n_pages - 1)], 0.0)
        p_up = pow2_up(cs_pages.amax() if cs_pages.numel()
                       else torch.zeros(()))
        p_terms = lambda p: _f16_terms(p, p_up)   # noqa: E731
    else:
        qa, qr = bf16_terms(xa), bf16_terms(xr)
        p_terms = bf16_terms
    ckv = ckv_pool.bfloat16().float().reshape(n_pages * ps, r)
    kr = krope_pool.bfloat16().float().reshape(n_pages * ps, -1)
    tbl = table.long().clamp(0, n_pages - 1).tolist()
    tiles = chunk_key_tiles(tbl, counts.tolist(), ps)
    o, m, l = _online_tiles(qa, qr, ckv, kr, tiles, p_terms,
                            (ckv_scale, krope_scale, ps) if q8 else None)
    return o.reshape(C, H, r), m.reshape(C, H), l.reshape(C, H)


def split_p_up(ckv_scale, table, counts, k0, k1):
    """Kernel 13's power of two for P in the key split of entries [k0,
    k1) of one sequence's table row (``table`` / ``counts`` lists, pages
    clamped): ``pow2_up`` of the largest latent scale of a counted page
    among them."""
    cs = [abs(float(ckv_scale[t])) for t, c in zip(table[k0:k1],
                                                    counts[k0:k1]) if c > 0]
    return pow2_up(torch.tensor(max(cs, default=0.0)))


def slab_p_up(ckv_scale, b, k0, k1):
    """Kernel 14's power of two for P in the key split [k0, k1) of
    sequence b's slab: ``pow2_up`` of b's latent scale if the split has a
    key (1 if not)."""
    return pow2_up(torch.tensor(abs(float(ckv_scale[b])) if k1 > k0
                                else 0.0))


def decode_split_emulation(q_abs, q_rope, c_kv, k_rope, table=None,
                           counts=None, cur_len=None, pos0=0, plan=None,
                           ckv_scale=None, krope_scale=None, terms=2, *,
                           scale: float):
    """The wgmma variant of kernels 10, 11 and 13 in plain PyTorch (the
    tests hold it against ``vwr_mla_flash_decode_ref`` /
    ``vwr_mla_paged_flash_decode_ref`` / its q8 sibling and the JAX ops):
    each sequence's rows, the queries times scale and P as two bf16 terms
    against the bf16 keys, per key split (``mla_decode_plan``'s unless
    ``plan`` is given) an fp32 online softmax over the kernel's 32-slot
    tiles (the pools: the page walk ``chunk_key_tiles`` over the split's
    table entries; the dense cache: 32 keys of the slab a tile, masked
    past the split's keys), the splits merged in split order
    (``combine_partials``), P as ``terms`` terms (two, or hi alone).  The
    column blocks change no value.  Dense:
    c_kv (B, T, r) with the keys ``pos0 + idx < cur_len`` valid; pools:
    (n_pages, page_size, r) through ``table`` / ``counts`` (B, J).  With
    the int8 pools' (n_pages,) scales (kernel 13) or the int8 slab's (B,)
    ones (kernel 14) the terms are kernel 15's: fp16, each query row
    scaled by its power of two, P times its key's latent scale and the
    split's own power of two (``split_p_up`` over the split's pages,
    ``slab_p_up`` from the split's sequence) before its split, l over the
    unscaled P, each key's latent and rope sums times their page's or
    sequence's scales.  Returns fp32 (o_tilde (B, H, r), m (B, H),
    l (B, H))."""
    B, H, r = q_abs.shape
    q8 = ckv_scale is not None
    xa = q_abs.float() * scale
    xr = q_rope.float() * scale
    lead, rows = c_kv.shape[:2]
    ckv = c_kv.bfloat16().float().reshape(lead * rows, r)
    kr = k_rope.bfloat16().float().reshape(lead * rows, -1)
    if table is None:
        n = max(0, min(rows, int(cur_len) - int(pos0)))
        nsplit, per, _ = plan or mla_decode_plan(B, H, n, None, r)
    else:
        n = table.shape[1]
        nsplit, per, _ = plan or mla_decode_plan(B, H, n, rows, r)
        tbl = table.long().clamp(0, lead - 1).tolist()
        cnt = counts.tolist()
    outs = []
    for b in range(B):
        qa, qr = (_f16_query_terms(xa[b], xr[b]) if q8
                  else (bf16_terms(xa[b]), bf16_terms(xr[b])))
        parts = []
        for sp in range(nsplit):
            k0, k1 = sp * per, min(n, (sp + 1) * per)
            p_terms, scales = (lambda p: bf16_terms(p, terms)), None
            if table is None:
                tiles = [[b * rows + k if k < k1 else -1
                          for k in range(t0, t0 + CHUNK_KEYS)]
                         for t0 in range(k0, k1, CHUNK_KEYS)]
            else:
                tiles = chunk_key_tiles(tbl[b][k0:k1], cnt[b][k0:k1], rows)
            if q8:
                up = (slab_p_up(ckv_scale, b, k0, k1) if table is None
                      else split_p_up(ckv_scale, tbl[b], cnt[b], k0, k1))
                p_terms = (lambda p, up=up:  # noqa: E731
                           _f16_terms(p, up)[:terms])
                scales = (ckv_scale, krope_scale, rows)
            parts.append(_online_tiles(qa, qr, ckv, kr, tiles, p_terms,
                                       scales))
        outs.append(combine_partials(parts))
    return tuple(torch.stack(t) for t in zip(*outs))



# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

def check_shapes(kernel, q_abs, q_rope, ckv, kr, index):
    """Raise unless q_abs (B, H, r) and q_rope (B, H, rope) meet latent /
    rope caches (B or n_pages, T or page_size, r / rope); ``index`` ()
    for the dense cache, whose lead must be B."""
    B, H, r0 = q_abs.shape
    lead = ckv.shape[:2]
    if (q_rope.shape[:2] != (B, H) or ckv.shape != (*lead, r0)
            or kr.shape != (*lead, q_rope.shape[2])
            or (not index and lead[0] != B) or lead[0] < 1):
        raise ValueError(
            f"{kernel}: needs q_abs (B, H, r) and q_rope (B, H, rope) "
            f"against latent/rope caches (B or n_pages, T or page_size, "
            f"r / rope); got q_abs {tuple(q_abs.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, c_kv {tuple(ckv.shape)}, k_rope "
            f"{tuple(kr.shape)}")


def _launch(kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale):
    """Check the operands' shapes and launch ``kernel`` at the widths it
    takes (``widths.at_widths``: r and rope zero-padded, o_tilde sliced
    back); ``index`` is (table, counts) for the pools, (B, J) a sequence
    or (J,) shared by the B chunk tokens, () for the dense cache
    (``n_keys`` valid keys from row 0 of each sequence's slab)."""
    check_shapes(kernel, q_abs, q_rope, ckv, kr, index)
    return widths.at_widths(
        lambda q_abs, ckv, q_rope, kr: _kernel(
            kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale),
        [((q_abs, ckv), RANKS), ((q_rope, kr), ROPES)], kernel)


def _kernel(kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale):
    B, H, r = q_abs.shape
    rope = q_rope.shape[2]
    paged = bool(index)
    lead = ckv.shape[:2]
    build.check_operands(kernel, torch.float32, q_abs=(q_abs, (B, H, r)),
                         q_rope=(q_rope, (B, H, rope)))
    cache_dt = torch.int8 if scales else ckv.dtype
    code = 0 if scales else build.dtype_code(cache_dt)
    build.check_operands(kernel, cache_dt, c_kv=(ckv, ckv.shape),
                         k_rope=(kr, kr.shape))
    if scales:
        build.check_operands(kernel, torch.float32,
                             ckv_scale=(scales[0], (lead[0],)),
                             krope_scale=(scales[1], (lead[0],)))
    J = 0
    if paged:
        J = index[0].shape[-1]
        # a chunk's B tokens share one (J,) table, a sequence has its row
        rows = () if kernel.startswith("vwr_mla_chunk") else (B,)
        build.check_operands(kernel, torch.int32,
                             table=(index[0], (*rows, J)),
                             counts=(index[1], (*rows, J)))
    if not kernel.startswith("vwr_mla_chunk"):   # kernels 10, 11, 13, 14
        return mla_decode_launch(
            q_abs, q_rope, ckv, kr, index, n_keys,
            decode_variant(r, rope, H, lead[1] if paged else None,
                           ckv.dtype), scale=scale, scales=scales)
    kind = chunk_variant(r, rope, lead[1], ckv.dtype)
    out = _entry(kernel, "_wgmma_launch" if kind == "wgmma" else "_launch",
                 q_abs, q_rope, ckv, kr, scales, index, n_keys, scale, code)
    build.count_launch(kernel, kind)
    return out


def _outputs(q_abs):
    B, H, r = q_abs.shape
    f32 = dict(dtype=torch.float32, device=q_abs.device)
    return (torch.empty((B, H, r), **f32), torch.empty((B, H), **f32),
            torch.empty((B, H), **f32))


def _entry(kernel, entry, q_abs, q_rope, ckv, kr, scales, index, n_keys,
           scale, code):
    """One launch of the C entry point ``kernel + entry`` (the FMA kernel,
    or kernel 12 / 15's wgmma variant) on operands ``_kernel`` checked."""
    B, H, r = q_abs.shape
    lead = ckv.shape[:2]
    out = _outputs(q_abs)
    ptrs = [q_abs, q_rope, ckv, kr, *scales, *index, *out]
    lib, fn = build.kernel_fn("vwr_mla_decode", kernel + entry,
                              [_VP] * len(ptrs) + [_I] * 7
                              + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), B, H, r, q_rope.shape[2],
             lead[0], lead[1], index[0].shape[-1] if index else n_keys,
             scale, code, build.stream_of(q_abs))
    build.check(lib, err, kernel)
    return out


def mla_decode_launch(q_abs, q_rope, ckv, kr, index, n_keys, kind,
                      plan=None, *, scale: float, scales=()):
    """One launch of kernel 10's (``index`` (): the dense cache, ``n_keys``
    valid keys a slab) or kernel 11's (``index`` (table, counts)) variant
    ``kind`` ("wgmma" or "fma") on operands their wrappers checked, at the
    kernel's widths, with ``mla_decode_plan``'s plan unless ``plan``
    (nsplit, per, ncol) is given; with ``scales`` (the int8 caches'
    (ckv_scale, krope_scale)) kernel 14's or kernel 13's.  chip_smoke.py
    times the variants and plans against each other through it."""
    kernel = ("vwr_mla_paged_flash_decode" if index
              else "vwr_mla_flash_decode") + ("_q8" if scales else "")
    if kind == "fma":
        out = _entry(kernel, "_launch", q_abs, q_rope, ckv, kr, scales,
                     index, n_keys, scale,
                     0 if scales else build.dtype_code(ckv.dtype))
    else:
        B, H, r = q_abs.shape
        lead = ckv.shape[:2]
        n = index[0].shape[1] if index else n_keys
        nsplit, per, ncol = plan or mla_decode_plan(
            B, H, n, lead[1] if index else None, r)
        groups = B * _cdiv(H, DECODE_ROWS)
        stream = build.stream_of(q_abs)
        ws = build.split_workspace(q_abs.device, stream,
                                   groups * nsplit * DECODE_ROWS
                                   * (r + 2 * ncol))
        counters = build.split_counters(q_abs.device, stream, groups * ncol)
        out = _outputs(q_abs)
        ptrs = [q_abs, q_rope, ckv, kr, *scales, *index, *out, ws,
                counters]
        lib, fn = build.kernel_fn("vwr_mla_decode", kernel + "_wgmma_launch",
                                  [_VP] * len(ptrs) + [_I] * 10
                                  + [_F, _VP])
        err = fn(*(t.data_ptr() for t in ptrs), B, H, r, q_rope.shape[2],
                 lead[0], lead[1], n, nsplit, per, ncol, scale, stream)
        build.check(lib, err, kernel)
    build.count_launch(kernel, kind)
    return out


def vwr_mla_flash_decode(q_abs, q_rope, c_kv, k_rope, cur_len: int,
                         pos0: int = 0, *, scale: float):
    """Kernel 10.  q_abs (B, H, r), q_rope (B, H, rope) fp32; c_kv
    (B, T, r), k_rope (B, T, rope) bf16 or fp32; ``cur_len`` and
    ``pos0`` host integers on the kernel path.  Returns fp32 (o_tilde,
    m, l) as ``vwr_mla_flash_decode_ref``."""
    if q_abs.device.type == "cpu":
        return vwr_mla_flash_decode_ref(q_abs, q_rope, c_kv, k_rope,
                                        cur_len, pos0, scale=scale)
    n_keys = max(0, min(c_kv.shape[1], int(cur_len) - int(pos0)))
    return _launch("vwr_mla_flash_decode", q_abs, q_rope, c_kv, k_rope,
                   (), (), n_keys, scale)


def vwr_mla_flash_decode_q8(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                            krope_scale, cur_len: int, pos0: int = 0, *,
                            scale: float):
    """Kernel 14: kernel 10 over int8 caches with fp32 (B,) scales; on
    the card ``decode_variant`` picks the kernel (wgmma at the widths it
    takes)."""
    if q_abs.device.type == "cpu":
        return vwr_mla_flash_decode_q8_ref(q_abs, q_rope, c_kv, k_rope,
                                           ckv_scale, krope_scale, cur_len,
                                           pos0, scale=scale)
    n_keys = max(0, min(c_kv.shape[1], int(cur_len) - int(pos0)))
    return _launch("vwr_mla_flash_decode_q8", q_abs, q_rope, c_kv, k_rope,
                   (ckv_scale, krope_scale), (), n_keys, scale)


def vwr_mla_paged_flash_decode(q_abs, q_rope, ckv_pool, krope_pool, table,
                               counts, *, scale: float):
    """Kernel 11.  Pools (n_pages, page_size, r / rope) bf16 or fp32;
    table, counts (B, J) int32.  The kernel clamps each table entry it
    reads, so no clamped copy of the table is made."""
    if q_abs.device.type == "cpu":
        return vwr_mla_paged_flash_decode_ref(q_abs, q_rope, ckv_pool,
                                              krope_pool, table, counts,
                                              scale=scale)
    return _launch("vwr_mla_paged_flash_decode", q_abs, q_rope, ckv_pool,
                   krope_pool, (), (table, counts), 0, scale)


def vwr_mla_paged_flash_decode_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                  ckv_scale, krope_scale, table, counts, *,
                                  scale: float):
    """Kernel 13: kernel 11 over int8 pools with fp32 (n_pages,) scales."""
    if q_abs.device.type == "cpu":
        return vwr_mla_paged_flash_decode_q8_ref(
            q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale,
            table, counts, scale=scale)
    return _launch("vwr_mla_paged_flash_decode_q8", q_abs, q_rope, ckv_pool,
                   krope_pool, (ckv_scale, krope_scale), (table, counts), 0,
                   scale)


def vwr_mla_chunk_prefix_attend(q_abs, q_rope, ckv_pool, krope_pool, table,
                                counts, *, scale: float):
    """Kernel 12.  q_abs (C, H, r), q_rope (C, H, rope) fp32, a prompt
    chunk's absorbed queries; pools (n_pages, page_size, r / rope) bf16 or
    fp32; table, counts (J,) int32 the chunk's prior pages, shared by its
    C tokens (the kernel clamps each entry it reads).  Returns fp32
    (o_tilde (C, H, r), m (C, H), l (C, H)).  On the card ``chunk_variant``
    picks the kernel (wgmma on bf16 pools at the widths it takes)."""
    if q_abs.device.type == "cpu":
        return vwr_mla_chunk_prefix_attend_ref(q_abs, q_rope, ckv_pool,
                                               krope_pool, table, counts,
                                               scale=scale)
    return _launch("vwr_mla_chunk_prefix_attend", q_abs, q_rope, ckv_pool,
                   krope_pool, (), (table, counts), 0, scale)


def vwr_mla_chunk_prefix_attend_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                   ckv_scale, krope_scale, table, counts, *,
                                   scale: float):
    """Kernel 15: kernel 12 over int8 pools with fp32 (n_pages,) scales;
    on the card ``chunk_variant`` picks the kernel (wgmma at the widths
    it takes)."""
    if q_abs.device.type == "cpu":
        return vwr_mla_chunk_prefix_attend_q8_ref(
            q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale,
            table, counts, scale=scale)
    return _launch("vwr_mla_chunk_prefix_attend_q8", q_abs, q_rope,
                   ckv_pool, krope_pool, (ckv_scale, krope_scale),
                   (table, counts), 0, scale)
