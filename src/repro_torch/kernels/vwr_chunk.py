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
no-op.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _chunk_partials(q, k, v, counts):
    """q: (KV, CG, D); k, v: (J, ps, KV, D) fp32 gathered pages; counts:
    (J,) valid keys per page."""
    KV, CG, D = q.shape
    J, ps = k.shape[:2]
    f32 = dict(dtype=torch.float32, device=q.device)
    if J * ps == 0:
        return (torch.zeros((KV, CG, D), **f32),
                torch.full((KV, CG), NEG_INF, **f32),
                torch.zeros((KV, CG), **f32))
    qf = q.float() * (1.0 / D ** 0.5)
    s = torch.einsum("hcd,thd->hct", qf, k.reshape(J * ps, KV, D))
    valid = (torch.arange(ps, device=q.device)[None, :]
             < counts[:, None]).reshape(J * ps)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    o_t = torch.einsum("hct,thd->hcd", p, v.reshape(J * ps, KV, D))
    return o_t, m, p.sum(-1)


def vwr_chunk_prefix_attend_ref(q, k_pool, v_pool, table, counts):
    """Plain version.  q: (KV, C*G, D); k_pool, v_pool: (n_pages,
    page_size, KV, D); table, counts: (J,) int — the chunk's prior page
    j is physical page ``table[j]`` (clamped to [0, n_pages)) with
    ``counts[j]`` valid keys.  Returns fp32 (o_tilde (KV, C*G, D),
    m (KV, C*G), l (KV, C*G))."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    return _chunk_partials(q, k_pool[tbl].float(), v_pool[tbl].float(),
                           counts)


def vwr_chunk_prefix_attend_q8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   table, counts):
    """Plain version over int8 pools (n_pages, page_size, KV, D) with
    fp32 (n_pages, KV) scales: the gathered pages are dequantized, then
    as ``vwr_chunk_prefix_attend_ref``."""
    tbl = table.long().clamp(0, k_pool.shape[0] - 1)
    k = k_pool[tbl].float() * k_scale[tbl][:, None, :, None]
    v = v_pool[tbl].float() * v_scale[tbl][:, None, :, None]
    return _chunk_partials(q, k, v, counts)


def _chunk_launch(kernel, q, k_pool, v_pool, table, counts, scales):
    KV, CG, D = q.shape
    n_pages, ps, KVp, Dp = k_pool.shape
    J = table.shape[0]
    code = build.dtype_code(q.dtype)
    if KVp != KV or Dp != D or D not in HEAD_DIMS or n_pages < 1:
        raise ValueError(f"{kernel}: needs q (KV, C*G, D in {HEAD_DIMS}) "
                         f"against pools (n_pages>=1, ps, KV, D) and a "
                         f"(J,) table; got q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(table.shape)}")
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
    f32 = dict(dtype=torch.float32, device=q.device)
    o_t = torch.empty((KV, CG, D), **f32)
    m = torch.empty((KV, CG), **f32)
    l = torch.empty((KV, CG), **f32)
    ptrs = [q, k_pool, v_pool, *scales, table, counts, o_t, m, l]
    lib, fn = build.kernel_fn("vwr_chunk_prefix", f"{kernel}_launch",
                              [_VP] * len(ptrs) + [_I] * 6
                              + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), CG, J, n_pages, ps, KV, D,
             1.0 / D ** 0.5, code, build.stream_of(q))
    build.check(lib, err, kernel)
    build.count_launch(kernel)
    return o_t, m, l


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
