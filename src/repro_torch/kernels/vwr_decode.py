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

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, widths

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16

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
    code = build.dtype_code(q.dtype)
    build.check_operands(kernel, q.dtype, q=(q, (BKV, G, D)))
    build.check_operands(kernel, torch.int8 if scales else q.dtype,
                         k=(k, (B, T, KV, D)), v=(v, (B, T, KV, D)))
    if scales:
        build.check_operands(kernel, torch.float32,
                             k_scale=(scales[0], (BKV,)),
                             v_scale=(scales[1], (BKV,)))
    n_keys = max(0, min(T, int(cur_len) - int(pos0)))
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
    build.count_launch(kernel)
    return o_t, m, l


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
    code = build.dtype_code(q.dtype)
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
    if scales:
        build.check_operands(kernel, torch.float32,
                             k_scale=(scales[0], (n_pages, KV)),
                             v_scale=(scales[1], (n_pages, KV)))
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
    build.count_launch(kernel)
    return o_t, m, l


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
