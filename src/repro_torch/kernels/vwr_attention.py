"""Causal flash attention with zero-copy GQA: plain version and the
CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_attention.vwr_attention_p``; the
kernel is ``csrc/vwr_attention.cu``.  Scale ``1/sqrt(D)`` is applied to
q in fp32, query head h reads KV head ``h // G`` (G = H // KV), and the
output is ``acc / max(l, 1e-30)``.  The kernel reads the native
``(B, S, H, D)`` / ``(B, S, KV, D)`` layouts: the JAX wrapper's
``(B*H, S, D)`` flatten is index arithmetic inside the kernel, so no
transpose or padding pass is made.

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


def vwr_attention_ref(q, k, v):
    """Plain version: dense causal softmax attention in fp32.
    q: (B, S, H, D); k, v: (B, S, KV, D).  Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, D) * (1.0 / D ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def vwr_attention(q, k, v):
    """Causal attention.  q: (B, S, H, D); k, v: (B, S, KV, D) with KV
    dividing H.  Returns (B, S, H, D) in q.dtype."""
    if q.device.type == "cpu":
        return vwr_attention_ref(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV == 0 or H % KV or D not in HEAD_DIMS:
        raise ValueError(f"vwr_attention: needs KV | H and D in "
                         f"{HEAD_DIMS}, got H={H} KV={KV} D={D}")
    build.check_operands("vwr_attention", q.dtype, q=(q, (B, S, H, D)),
                         k=(k, (B, S, KV, D)), v=(v, (B, S, KV, D)))
    out = torch.empty_like(q)
    lib, fn = build.kernel_fn("vwr_attention", "vwr_attention_launch",
                              [_VP] * 4 + [_I] * 5 + [_F, _I, _VP])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, H, KV, D, 1.0 / D ** 0.5, build.dtype_code(q.dtype),
             build.stream_of(q))
    build.check(lib, err, "vwr_attention")
    build.count_launch("vwr_attention")
    return out
