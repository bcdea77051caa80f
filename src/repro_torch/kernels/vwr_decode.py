"""Flash-decode partials against a dense KV cache or a paged pool:
plain versions and the CUDA kernel wrappers.

Counterparts of ``repro.kernels.vwr_decode``'s ``vwr_flash_decode_p``
and ``vwr_flash_decode_q8_p`` (both in ``csrc/vwr_decode.cu``; the int8
cache carries one fp32 scale a (batch, KV head) row),
``vwr_paged_flash_decode_p`` and
``vwr_paged_flash_decode_q8_p`` (both in ``csrc/vwr_paged_decode.cu``).
The paged kernels walk a slot's block table: logical page j is the
physical page ``table[slot, j]`` of an ``(n_pages, page_size, KV, D)``
pool, with ``counts[slot, j]`` valid keys; the int8 pools carry fp32
``(n_pages, KV)`` scales.

The dense kernel takes one query group (the G heads that share a KV
head) against the cache slab that starts at global position ``pos0``;
positions ``idx`` with ``pos0 + idx < cur_len`` are valid.
Returns the unnormalized fp32 partials ``(o_tilde, m, l)`` — the
distributed-FlashDecoding combine contract, as every kernel here
does; a group with no valid position gives ``m = -1e30, l = 0,
o_tilde = 0``.  The dense kernel reads the cache in its native
``(B, T, KV, D)`` layout (no transpose) and stops at the last valid
position.

The kernels take a head dim D in {32, 64, 128} and at most 16 query
rows (G) a KV head.  ``widths.at_widths`` zero-pads a narrower D
(the reduced configs' 16) to the next of those, with the scale of the
true width, and launches a larger G in slices of 16 rows; on a paged
pool of a reduced config that pads the whole pool on each call, which
is acceptable at reduced widths.  Nothing is copied at D 64 or 128 and
G <= 16.

Kernels 4 and 9 have two kernels each, and ``decode_variant`` picks one
per call: ``"split"`` (bf16 queries at D 32 / 64 / 128: each (batch, KV
head) group's keys cut into ``decode_plan``'s splits, one block a split,
the products on mma.sync with P as two bf16 terms, the splits merged by
the group's last block in the same launch; over kernel 9's int8 cache
the keys are converted exactly to bf16 and the values to fp16, the
scores take scale * k_scale in fp32, P is two fp16 terms and each
split's o_tilde takes v_scale; ``decode_split_emulation`` is the
arithmetic in plain PyTorch) or ``"fma"`` (fp32 queries: the FMA
kernel).  Kernel 5 has two as well,
and ``paged_variant`` picks one: ``"mma"`` (bf16 queries at D 32 / 64
/ 128, any page size: kernel 4's split kernel over the block table, each
slot's table entries cut into ``paged_plan``'s splits from the table's
shape alone, 64-slot tiles of logical keys that resolve their own
entries, masked per key; over kernel 7's int8 pools each warp stages and
converts its own 16-slot slice with its slots' page scales, each score
takes scale * its page's k scale, P its page's v scale and the split's
power of two before two fp16 terms; ``paged_mma_emulation`` is the
arithmetic) or ``"fma"`` (fp32 queries: the FMA kernel).
``build.VARIANTS`` counts both variants of kernels 4, 5, 7 and 9.
The split variants' partials and counters are ``build.split_workspace``
/ ``split_counters``, one buffer per (device, stream).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, widths

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
# kernel 4's split variant (csrc SP_*): a block stages 64-key tiles and
# each of its 4 warps scores a 16-key slice of a tile; a split holds whole
# slices.  decode_plan aims at DECODE_BLOCKS blocks with splits of at
# least DECODE_MIN_KEYS keys (a split's merge costs ~2 us, more than the
# extra blocks save at fewer keys: measured on the H100, PERF.md) and at
# most DECODE_MAX_SPLITS splits a group (the last block reads every
# split's partial; csrc FIN_SPLITS).
SMS = 132                  # streaming multiprocessors of an H100 SXM
SPLIT_TILE, SPLIT_SLICE, SPLIT_WARPS = 64, 16, 4
DECODE_BLOCKS = 2 * SMS
DECODE_MIN_KEYS = 256
DECODE_MAX_SPLITS = 32
# kernel 5's mma variant (csrc SD_*, kernel 4's tiles and slices):
# paged_plan cuts a slot's table into at most DECODE_BLOCKS // (B*KV)
# splits of at least PAGED_MIN_KEYS key slots (three slices), the plans
# measured fastest on the H100 at the Scheduler's tables (PERF.md)
PAGED_MIN_KEYS = 48

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def vwr_flash_decode_ref(q, k, v, cur_len, pos0=0, *, scale=None):
    """Plain version.  q: (B*KV, G, D); k, v: (B, T, KV, D); ``scale``
    1/sqrt(D) unless given.  Returns fp32 (o_tilde (B*KV, G, D),
    m (B*KV, G), l (B*KV, G))."""
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qf = q.float().reshape(B, KV, G, D) * scale
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    valid = pos0 + torch.arange(T, device=q.device) < cur_len
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    o_t = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return (o_t.reshape(BKV, G, D), m.reshape(BKV, G),
            p.sum(-1).reshape(BKV, G))


def vwr_flash_decode_q8_ref(q, k, v, k_scale, v_scale, cur_len, pos0=0, *,
                            scale=None):
    """Plain version of the int8 kernel: k, v int8 (B, T, KV, D) with
    fp32 (B*KV,) scales, dequantized, then as ``vwr_flash_decode_ref``."""
    B, T, KV, _ = k.shape
    kf = k.float() * k_scale.reshape(B, 1, KV, 1)
    vf = v.float() * v_scale.reshape(B, 1, KV, 1)
    return vwr_flash_decode_ref(q, kf, vf, cur_len, pos0, scale=scale)


def _cdiv(a, b):
    return -(-a // b)


def decode_variant(dtype, D, G):
    """The kernel that serves a ``vwr_flash_decode`` or
    ``vwr_flash_decode_q8`` call at the kernel's widths (after
    ``widths.at_widths``): "split" for bf16 queries (bf16 or int8 caches)
    at D 32, 64 or 128 and G <= 16, else "fma"."""
    if dtype == torch.bfloat16 and D in HEAD_DIMS and G <= MAX_GROUP:
        return "split"
    return "fma"


@functools.lru_cache(maxsize=4096)
def decode_plan(BKV, n_keys):
    """(nsplit, keys a split) of the split variant: a group's n_keys keys
    in nsplit splits of whole 16-key slices, as many as bring the B*KV
    groups near ``DECODE_BLOCKS`` blocks, each of at least
    ``DECODE_MIN_KEYS`` keys and at most ``DECODE_MAX_SPLITS`` of them,
    sized evenly so that no split starts at or past n_keys.  Short caches
    (a decode step's ~150 keys) take one split; n_keys 0 gives one split
    (the group's empty partial)."""
    slices = max(1, _cdiv(n_keys, SPLIT_SLICE))
    want = min(DECODE_MAX_SPLITS, max(1, _cdiv(DECODE_BLOCKS, BKV)),
               max(1, n_keys // DECODE_MIN_KEYS))
    per = _cdiv(slices, want)
    return _cdiv(slices, per), SPLIT_SLICE * per


def paged_variant(dtype, D, G):
    """The kernel that serves a ``vwr_paged_flash_decode`` or
    ``vwr_paged_flash_decode_q8`` call at the kernel's widths (after
    ``widths.at_widths``): "mma" for bf16 queries (bf16 or int8 pools) at
    D 32, 64 or 128 and G <= 16 (any page size), else "fma" (fp32
    queries)."""
    if dtype == torch.bfloat16 and D in HEAD_DIMS and G <= MAX_GROUP:
        return "mma"
    return "fma"


@functools.lru_cache(maxsize=4096)
def paged_plan(BKV, J, page_size):
    """(nsplit, table entries a split) of the mma variant: a slot's J
    table entries in nsplit splits of whole entries, so each key belongs
    to one split by construction.  Sized from the table's J * page_size
    key slots, never from the counts (no host copy of them, so the paged
    step stays capturable): at most ``DECODE_BLOCKS`` blocks in all (one
    wave of the B*KV groups' splits), each split of at least
    ``PAGED_MIN_KEYS`` slots, at most ``DECODE_MAX_SPLITS`` of them, sized
    evenly so that no split starts at or past J.  tinyllama's Scheduler
    tables (32 groups, J 16 or 18 at pages of 16) take 4 or 6 splits,
    qwen's (128 groups) 2, a 2048-key table 8; J 0 gives one split (the
    empty partial)."""
    want = min(DECODE_MAX_SPLITS, max(1, DECODE_BLOCKS // BKV),
               max(1, J * page_size // PAGED_MIN_KEYS))
    jps = max(1, _cdiv(J, want))
    return max(1, _cdiv(J, jps)), jps


def combine_partials(parts):
    """The flash combine of fp32 partials ``[(o_tilde, m, l), ...]`` in
    list order: m = max m_s, each weighted by exp(m_s - m), or 0 where
    m_s = -1e30 (no valid key).  The split kernels' merge."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    o, l = 0.0, 0.0
    for o_s, m_s, l_s in parts:
        w = torch.where(m_s > NEG_INF / 2, torch.exp(m_s - m), 0.0)
        o = o + o_s * w[..., None]
        l = l + l_s * w
    return o, m, l


def bf16_terms(x, terms=2):
    """x (fp32) as ``terms`` bf16 terms, hi = bf16(x) and lo = bf16(x -
    hi) (the wgmma / mma.sync kernels' two, or hi alone), each returned
    as fp32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float())[:terms]


def f16_terms(x, terms=2):
    """x (fp32, in [0, 1]: P) as ``terms`` fp16 terms, hi = fp16(x) and lo =
    fp16(x - hi) (kernel 9's split variant), each returned as fp32."""
    hi = x.half().float()
    return (hi, (x - hi).half().float())[:terms]


def decode_split_emulation(q, k, v, cur_len, pos0=0, plan=None, terms=2,
                           scales=None, p_terms=None):
    """The split variant's arithmetic in plain PyTorch (the tests hold it
    against ``vwr_flash_decode_ref`` and the JAX op): per split
    (``decode_plan``'s unless ``plan`` is given), 64-key tiles whose 16-key
    slices go to 4 warps; each warp keeps an fp32 online softmax over its
    slices with the scores (q . k) * scale of the bf16 values and P as
    ``terms`` bf16 terms against V; the warps merge in warp order into the
    split's partial, the splits in split order (``combine_partials``).
    ``scales``: kernel 9's int8 cache with its (B*KV,) (k_scale, v_scale):
    the int8 values exact in bf16 and fp16, each score (q . k8) times
    scale * k scale, P as fp16 terms (``f16_terms``; ``p_terms`` sets the
    splitter), and each split's merged o_tilde times the v scale (both
    scales constant over a group).  Returns fp32 (o_tilde (B*KV, G, D),
    m (B*KV, G), l (B*KV, G))."""
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    scale = 1.0 / D ** 0.5
    n = max(0, min(T, int(cur_len) - int(pos0)))
    nsplit, kps = plan or decode_plan(BKV, n)
    qf = q.bfloat16().float()
    kf, vf = (t.bfloat16().float().permute(0, 2, 1, 3).reshape(BKV, T, D)
              for t in (k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    sk = torch.full((BKV, 1, 1), scale, **f32)
    vs = torch.ones((BKV, 1, 1), **f32)
    if scales is not None:
        sk = (scale * scales[0].float()).reshape(BKV, 1, 1)
        vs = scales[1].float().reshape(BKV, 1, 1)
    p_terms = p_terms or (f16_terms if scales is not None else bf16_terms)
    empty = (torch.zeros((BKV, G, D), **f32),
             torch.full((BKV, G), NEG_INF, **f32), torch.zeros((BKV, G), **f32))
    splits = []
    for sp in range(nsplit):
        k0, k1 = sp * kps, min(n, (sp + 1) * kps)
        warps = [empty] * SPLIT_WARPS
        for t0 in range(k0, k1, SPLIT_TILE):
            for w in range(SPLIT_WARPS):
                s0 = t0 + SPLIT_SLICE * w
                if s0 >= k1:
                    continue
                keys = slice(s0, min(s0 + SPLIT_SLICE, k1))
                o, m, l = warps[w]
                sc = torch.einsum("bgd,btd->bgt", qf, kf[:, keys]) * sk
                mx = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - mx)
                p = torch.exp(sc - mx[..., None])
                pv = sum(torch.einsum("bgt,btd->bgd", t, vf[:, keys])
                         for t in p_terms(p, terms))
                warps[w] = (o * corr[..., None] + pv, mx,
                            l * corr + p.sum(-1))
        o, m, l = combine_partials(warps)
        splits.append((o * vs, m, l))
    return combine_partials(splits)


def _dense_launch(kernel, q, k, v, scales, cur_len, pos0):
    scale = 1.0 / q.shape[-1] ** 0.5
    return widths.at_widths(
        lambda q, k, v: _dense_kernel(kernel, q, k, v, scales, cur_len,
                                      pos0, scale),
        [((q, k, v), HEAD_DIMS)], kernel, max_group=MAX_GROUP)


def _dense_kernel(kernel, q, k, v, scales, cur_len, pos0, scale):
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    if BKV != B * KV:
        raise ValueError(f"{kernel}: needs q (B*KV, G, D), got q "
                         f"{tuple(q.shape)} and cache {tuple(k.shape)}")
    build.check_operands(kernel, q.dtype, q=(q, (BKV, G, D)))
    build.check_operands(kernel, torch.int8 if scales else q.dtype,
                         k=(k, (B, T, KV, D)), v=(v, (B, T, KV, D)))
    if scales:
        build.check_operands(kernel, torch.float32,
                             k_scale=(scales[0], (BKV,)),
                             v_scale=(scales[1], (BKV,)))
    n_keys = max(0, min(T, int(cur_len) - int(pos0)))
    return decode_launch(q, k, v, n_keys, decode_variant(q.dtype, D, G),
                         scale=scale, scales=scales)


def _launch_fma(kernel, q, k, v, scales, n_keys, scale, code):
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    o_t = torch.empty((BKV, G, D), **f32)
    m = torch.empty((BKV, G), **f32)
    l = torch.empty((BKV, G), **f32)
    ptrs = [q, k, v, *scales, o_t, m, l]
    lib, fn = build.kernel_fn("vwr_decode", f"{kernel}_launch",
                              [_VP] * len(ptrs) + [_I] * 6 + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), B, T, KV, G, D, n_keys,
             scale, code, build.stream_of(q))
    build.check(lib, err, kernel)
    return o_t, m, l


def decode_launch(q, k, v, n_keys, kind, plan=None, scale=None, scales=()):
    """One launch of kernel 4's variant ``kind`` ("split" or "fma") on
    operands ``vwr_flash_decode`` checked, keys 0 .. n_keys - 1 valid, with
    ``decode_plan``'s plan unless ``plan`` is given; with ``scales`` (the
    int8 cache's (k_scale, v_scale)) kernel 9's, on operands
    ``vwr_flash_decode_q8`` checked.  chip_smoke.py times the variants and
    plans against each other through it."""
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    scale = 1.0 / D ** 0.5 if scale is None else scale
    kernel = "vwr_flash_decode" + ("_q8" if scales else "")
    if kind == "fma":
        out = _launch_fma(kernel, q, k, v, scales, n_keys, scale,
                          build.dtype_code(q.dtype))
    else:
        nsplit, kps = plan or decode_plan(BKV, n_keys)
        stream = build.stream_of(q)
        ws = build.split_workspace(q.device, stream,
                                   BKV * nsplit * G * (D + 2))
        counters = build.split_counters(q.device, stream, BKV)
        f32 = dict(dtype=torch.float32, device=q.device)
        out = (torch.empty((BKV, G, D), **f32),
               torch.empty((BKV, G), **f32), torch.empty((BKV, G), **f32))
        ptrs = [q, k, v, *scales, *out, ws, counters]
        lib, fn = build.kernel_fn("vwr_decode", f"{kernel}_split_launch",
                                  [_VP] * len(ptrs) + [_I] * 8 + [_F, _VP])
        err = fn(*(t.data_ptr() for t in ptrs), B, T, KV, G, D, n_keys,
                 nsplit, kps, scale, stream)
        build.check(lib, err, kernel)
    build.count_launch(kernel, kind)
    return out


def vwr_flash_decode(q, k, v, cur_len: int, pos0: int = 0):
    """q: (B*KV, G, D) one token's heads, kv-major; k, v: (B, T, KV, D);
    ``cur_len`` and ``pos0`` are host integers on the kernel path.
    Returns fp32 (o_tilde, m, l) as ``vwr_flash_decode_ref``."""
    if q.device.type == "cpu":
        return vwr_flash_decode_ref(q, k, v, cur_len, pos0)
    return _dense_launch("vwr_flash_decode", q, k, v, (), cur_len, pos0)


def vwr_flash_decode_q8(q, k, v, k_scale, v_scale, cur_len: int,
                        pos0: int = 0):
    """``vwr_flash_decode`` over an int8 cache k, v (B, T, KV, D) with
    fp32 (B*KV,) scales, one a (batch, KV head) row; q stays bf16 or
    fp32."""
    if q.device.type == "cpu":
        return vwr_flash_decode_q8_ref(q, k, v, k_scale, v_scale, cur_len,
                                       pos0)
    return _dense_launch("vwr_flash_decode_q8", q, k, v, (k_scale, v_scale),
                         cur_len, pos0)


# ----------------------------------------------------------------------
# paged pools: kernels 5 and 7 (csrc/vwr_paged_decode.cu)
# ----------------------------------------------------------------------

def _paged_partials(q, k, v, counts, scale):
    """q: (B*KV, G, D); k, v: (B, J, ps, KV, D) fp32 gathered pages;
    counts: (B, J) valid keys per logical page; ``scale`` 1/sqrt(D)
    unless given."""
    BKV, G, D = q.shape
    B, J, ps, KV, _ = k.shape
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qf = q.float().reshape(B, KV, G, D) * scale
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.reshape(B, J * ps, KV, D))
    valid = (torch.arange(ps, device=q.device)[None, None, :]
             < counts[..., None]).reshape(B, 1, 1, J * ps)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    o_t = torch.einsum("bhgt,bthd->bhgd", p, v.reshape(B, J * ps, KV, D))
    return (o_t.reshape(BKV, G, D), m.reshape(BKV, G),
            p.sum(-1).reshape(BKV, G))


def vwr_paged_flash_decode_ref(q, k_pool, v_pool, table, counts, *,
                               scale=None):
    """Plain version of the paged kernel.  q: (B*KV, G, D); k_pool,
    v_pool: (n_pages, page_size, KV, D); table, counts: (B, J) int —
    logical page j of slot b is physical page ``table[b, j]`` (clamped
    to [0, n_pages)) with ``counts[b, j]`` valid keys (0 masks the
    page).  Returns fp32 (o_tilde (B*KV, G, D), m (B*KV, G),
    l (B*KV, G))."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    return _paged_partials(q, k_pool[tbl].float(), v_pool[tbl].float(),
                           counts, scale)


def vwr_paged_flash_decode_q8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                  table, counts, *, scale=None):
    """Plain version of the int8-pool kernel: k_pool, v_pool int8
    (n_pages, page_size, KV, D) with fp32 (n_pages, KV) scales,
    dequantized page by page, then as ``vwr_paged_flash_decode_ref``."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    k = k_pool[tbl].float() * k_scale[tbl][:, :, None, :, None]
    v = v_pool[tbl].float() * v_scale[tbl][:, :, None, :, None]
    return _paged_partials(q, k, v, counts, scale)


def pow2_up(amax):
    """The power of two that brings amax (>= 0) into [2^14, 2^15), 1 for
    0 (common.cuh pow2_up): x times it and its fp16 terms stay inside
    fp16's normal range for every |x| within 2^-17 of amax."""
    e = torch.frexp(amax)[1]
    return torch.where(amax > 0, torch.ldexp(torch.ones_like(amax),
                                             (15 - e).clamp(max=126)), 1.0)


def split_p_up(v_counted, x0, x1):
    """Kernel 7's power of two for P in the split of logical key slots
    [x0, x1), a (B*KV,) tensor: ``pow2_up`` of each group's largest v
    scale of a counted page among them (``v_counted`` (B*KV, J * ps):
    each slot's page v scale, 0 where its page holds no valid key)."""
    return pow2_up(v_counted[:, x0:x1].amax(-1) if x1 > x0
                   else v_counted.new_zeros(v_counted.shape[0]))


def paged_mma_emulation(q, k_pool, v_pool, table, counts, plan=None,
                        terms=2, scales=None, p_terms=None):
    """The mma variant's arithmetic in plain PyTorch (the tests hold it
    against ``vwr_paged_flash_decode_ref`` and the JAX op): per split
    (``paged_plan``'s unless ``plan`` is given) the split's table entries
    as logical key slots (entry j, row o; masked past ``counts[b, j]``,
    pages clamped to [0, n_pages)) in 64-slot tiles whose 16-slot slices
    go to 4 warps; a warp skips a slice without a valid key and keeps an
    fp32 online softmax over the others with the scores (q . k) * scale
    of the bf16 values and P as ``terms`` bf16 terms against V; the warps
    merge in warp order into the split's partial, the splits in split
    order (``combine_partials``).  ``scales``: kernel 7's int8 pools with
    their (n_pages, KV) (k_scale, v_scale): the int8 values exact in 16
    bits, each score (q . k8) times scale * its page's k scale, P (after
    l) times its page's v scale and the split's power of two
    (``split_p_up``) before ``terms`` fp16 terms (``f16_terms``;
    ``p_terms`` sets the splitter), and the split's merged o_tilde divided
    by that power of two.  Returns fp32 (o_tilde
    (B*KV, G, D), m (B*KV, G), l (B*KV, G))."""
    BKV, G, D = q.shape
    n_pages, ps, KV, _ = k_pool.shape
    B, J = table.shape
    scale = 1.0 / D ** 0.5
    nsplit, jps = plan or paged_plan(BKV, J, ps)
    tbl = table.long().clamp(0, n_pages - 1)
    qf = q.bfloat16().float()

    def by_group(t):        # (B, J, ...) per slot -> (B*KV, J * ps) per key
        return (t.float().repeat_interleave(ps, 1).permute(0, 2, 1)
                .reshape(BKV, J * ps))
    kf, vf = (t[tbl].bfloat16().float().reshape(B, J * ps, KV, D)
              .permute(0, 2, 1, 3).reshape(BKV, J * ps, D)
              for t in (k_pool, v_pool))
    valid = (torch.arange(ps, device=q.device) < counts[..., None].long()
             ).reshape(B, 1, J * ps).expand(B, KV, J * ps).reshape(BKV, -1)
    f32 = dict(dtype=torch.float32, device=q.device)
    sk = torch.full((BKV, J * ps), scale, **f32)
    vs = torch.ones((BKV, J * ps), **f32)
    if scales is not None:
        sk = scale * by_group(scales[0][tbl])
        vs = by_group(scales[1][tbl])
        counted = (counts > 0)[..., None].expand(B, J, KV)
        v_counted = by_group(torch.where(counted, scales[1][tbl].abs(), 0.0))
    p_terms = p_terms or (f16_terms if scales is not None else bf16_terms)
    empty = (torch.zeros((BKV, G, D), **f32),
             torch.full((BKV, G), NEG_INF, **f32), torch.zeros((BKV, G), **f32))
    splits = []
    for sp in range(nsplit):
        x0, x1 = sp * jps * ps, min(J, (sp + 1) * jps) * ps
        pup = torch.ones((BKV, 1, 1), **f32)
        if scales is not None:
            pup = split_p_up(v_counted, x0, x1).reshape(BKV, 1, 1)
        warps = [empty] * SPLIT_WARPS
        for t0 in range(x0, x1, SPLIT_TILE):
            for w in range(SPLIT_WARPS):
                keys = slice(t0 + SPLIT_SLICE * w,
                             min(t0 + SPLIT_SLICE * (w + 1), x1))
                ok = valid[:, keys]
                if keys.start >= x1 or not bool(ok.any()):
                    continue
                live = ok.any(-1)                     # groups with a key
                o, m, l = warps[w]
                sc = (torch.einsum("bgd,btd->bgt", qf, kf[:, keys])
                      * sk[:, None, keys])
                sc = torch.where(ok[:, None], sc, NEG_INF)
                mx = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - mx)
                p = torch.where(ok[:, None], torch.exp(sc - mx[..., None]),
                                0.0)
                pv = sum(torch.einsum("bgt,btd->bgd", t, vf[:, keys])
                         for t in p_terms(p * (vs[:, None, keys] * pup),
                                          terms))
                keep = live[:, None]
                warps[w] = (torch.where(keep[..., None],
                                        o * corr[..., None] + pv, o),
                            torch.where(keep, mx, m),
                            torch.where(keep, l * corr + p.sum(-1), l))
        o, m, l = combine_partials(warps)
        splits.append((o * (1.0 / pup), m, l))
    return combine_partials(splits)


def _paged_launch(kernel, q, k_pool, v_pool, table, counts, scales):
    scale = 1.0 / q.shape[-1] ** 0.5
    return widths.at_widths(
        lambda q, k_pool, v_pool: _paged_kernel(
            kernel, q, k_pool, v_pool, table, counts, scales, scale),
        [((q, k_pool, v_pool), HEAD_DIMS)], kernel, max_group=MAX_GROUP)


def _paged_kernel(kernel, q, k_pool, v_pool, table, counts, scales, scale):
    BKV, G, D = q.shape
    n_pages, ps, KV, Dp = k_pool.shape
    B, J = table.shape
    if BKV != B * KV or Dp != D or n_pages < 1:
        raise ValueError(f"{kernel}: needs q (B*KV, G, D) against pools "
                         f"(n_pages>=1, ps, KV, D) and a (B, J) table; got "
                         f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"table {tuple(table.shape)}")
    pool_dt = torch.int8 if scales else q.dtype
    build.check_operands(kernel, q.dtype, q=(q, (BKV, G, D)))
    build.check_operands(kernel, pool_dt, k_pool=(k_pool, k_pool.shape),
                         v_pool=(v_pool, k_pool.shape))
    build.check_operands(kernel, torch.int32,
                         table=(table, (B, J)), counts=(counts, (B, J)))
    if scales:   # kernel 7
        build.check_operands(kernel, torch.float32,
                             k_scale=(scales[0], (n_pages, KV)),
                             v_scale=(scales[1], (n_pages, KV)))
    return paged_launch(q, k_pool, v_pool, table, counts,
                        paged_variant(q.dtype, D, G), scale=scale,
                        scales=scales)


def _paged_fma(kernel, q, k_pool, v_pool, table, counts, scales, scale,
               code):
    BKV, G, D = q.shape
    n_pages, ps, KV, _ = k_pool.shape
    B, J = table.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    o_t = torch.empty((BKV, G, D), **f32)
    m = torch.empty((BKV, G), **f32)
    l = torch.empty((BKV, G), **f32)
    ptrs = [q, k_pool, v_pool, *scales, table, counts, o_t, m, l]
    lib, fn = build.kernel_fn("vwr_paged_decode", f"{kernel}_launch",
                              [_VP] * len(ptrs) + [_I] * 7
                              + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), B, J, n_pages, ps, KV, G, D,
             scale, code, build.stream_of(q))
    build.check(lib, err, kernel)
    return o_t, m, l


def paged_launch(q, k_pool, v_pool, table, counts, kind, plan=None,
                 scale=None, scales=()):
    """One launch of kernel 5's variant ``kind`` ("mma" or "fma") on
    operands ``vwr_paged_flash_decode`` checked, with ``paged_plan``'s
    plan unless ``plan`` is given; with ``scales`` (the int8 pools'
    (k_scale, v_scale)) kernel 7's, on operands
    ``vwr_paged_flash_decode_q8`` checked.  chip_smoke.py times the
    variants and plans against each other through it."""
    BKV, G, D = q.shape
    n_pages, ps, KV, _ = k_pool.shape
    B, J = table.shape
    scale = 1.0 / D ** 0.5 if scale is None else scale
    kernel = "vwr_paged_flash_decode" + ("_q8" if scales else "")
    if kind == "fma":
        out = _paged_fma(kernel, q, k_pool, v_pool, table, counts, scales,
                         scale, build.dtype_code(q.dtype))
    else:
        nsplit, jps = plan or paged_plan(BKV, J, ps)
        stream = build.stream_of(q)
        ws = build.split_workspace(q.device, stream,
                                   BKV * nsplit * G * (D + 2))
        counters = build.split_counters(q.device, stream, BKV)
        f32 = dict(dtype=torch.float32, device=q.device)
        out = (torch.empty((BKV, G, D), **f32),
               torch.empty((BKV, G), **f32), torch.empty((BKV, G), **f32))
        ptrs = [q, k_pool, v_pool, *scales, table, counts, *out, ws,
                counters]
        lib, fn = build.kernel_fn("vwr_paged_decode", f"{kernel}_mma_launch",
                                  [_VP] * len(ptrs) + [_I] * 9 + [_F, _VP])
        err = fn(*(t.data_ptr() for t in ptrs), B, J, n_pages, ps, KV, G, D,
                 nsplit, jps, scale, stream)
        build.check(lib, err, kernel)
    build.count_launch(kernel, kind)
    return out


def vwr_paged_flash_decode(q, k_pool, v_pool, table, counts):
    """q: (B*KV, G, D) kv-major; k_pool, v_pool: (n_pages, page_size,
    KV, D) in q's dtype; table, counts: (B, J) int32.  Returns fp32
    (o_tilde, m, l) as ``vwr_paged_flash_decode_ref``; the kernel clamps
    each table entry it reads, so no clamped copy of the table is made."""
    if q.device.type == "cpu":
        return vwr_paged_flash_decode_ref(q, k_pool, v_pool, table, counts)
    return _paged_launch("vwr_paged_flash_decode", q, k_pool, v_pool,
                         table, counts, ())


def vwr_paged_flash_decode_q8(q, k_pool, v_pool, k_scale, v_scale, table,
                              counts):
    """``vwr_paged_flash_decode`` over int8 pools with fp32 (n_pages, KV)
    scales; q stays in the model dtype."""
    if q.device.type == "cpu":
        return vwr_paged_flash_decode_q8_ref(q, k_pool, v_pool, k_scale,
                                             v_scale, table, counts)
    return _paged_launch("vwr_paged_flash_decode_q8", q, k_pool, v_pool,
                         table, counts, (k_scale, v_scale))
