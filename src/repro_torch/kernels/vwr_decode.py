"""Flash-decode partials against a dense KV cache: plain version and
the CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_decode.vwr_flash_decode_p``; the
kernel is ``csrc/vwr_decode.cu``.  One query group (the G heads that
share a KV head) against the cache slab that starts at global position
``pos0``; positions ``idx`` with ``pos0 + idx < cur_len`` are valid.
Returns the unnormalized fp32 partials ``(o_tilde, m, l)`` — the
distributed-FlashDecoding combine contract; a group with no valid
position gives ``m = -1e30, l = 0, o_tilde = 0``.  The kernel reads the
cache in its native ``(B, T, KV, D)`` layout (no transpose) and stops at
the last valid position.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def vwr_flash_decode_ref(q, k, v, cur_len, pos0=0):
    """Plain version.  q: (B*KV, G, D); k, v: (B, T, KV, D).  Returns
    fp32 (o_tilde (B*KV, G, D), m (B*KV, G), l (B*KV, G))."""
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    qf = q.float().reshape(B, KV, G, D) * (1.0 / D ** 0.5)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    valid = pos0 + torch.arange(T, device=q.device) < cur_len
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    o_t = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return (o_t.reshape(BKV, G, D), m.reshape(BKV, G),
            p.sum(-1).reshape(BKV, G))


def vwr_flash_decode(q, k, v, cur_len: int, pos0: int = 0):
    """q: (B*KV, G, D) one token's heads, kv-major; k, v: (B, T, KV, D);
    ``cur_len`` and ``pos0`` are host integers on the kernel path.
    Returns fp32 (o_tilde, m, l) as ``vwr_flash_decode_ref``."""
    if q.device.type == "cpu":
        return vwr_flash_decode_ref(q, k, v, cur_len, pos0)
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    if BKV != B * KV or G > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"vwr_flash_decode: needs q (B*KV, G<={MAX_GROUP}"
                         f", D in {HEAD_DIMS}), got q {tuple(q.shape)} "
                         f"and cache {tuple(k.shape)}")
    build.check_operands("vwr_flash_decode", q.dtype, q=(q, (BKV, G, D)),
                         k=(k, (B, T, KV, D)), v=(v, (B, T, KV, D)))
    n_keys = max(0, min(T, int(cur_len) - int(pos0)))
    f32 = dict(dtype=torch.float32, device=q.device)
    o_t = torch.empty((BKV, G, D), **f32)
    m = torch.empty((BKV, G), **f32)
    l = torch.empty((BKV, G), **f32)
    lib, fn = build.kernel_fn("vwr_decode", "vwr_flash_decode_launch",
                              [_VP] * 6 + [_I] * 6 + [_F, _I, _VP])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_t.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, T, KV, G, D, n_keys,
             1.0 / D ** 0.5, build.dtype_code(q.dtype), build.stream_of(q))
    build.check(lib, err, "vwr_flash_decode")
    build.count_launch("vwr_flash_decode")
    return o_t, m, l
