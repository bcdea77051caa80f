"""Depthwise NHWC conv2d (the paper's low-reuse case): the plain version
and the CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_depthwise.vwr_depthwise_p``; the
kernel is ``csrc/vwr_depthwise.cu``.  ``out[n, i, j, c] = sum over
(kj, ki) of x[n, i+kj, j+ki, c] * w[kj, ki, c]``: no reduction across
channels, no bias, no activation; the products summed in fp32, one cast
to x's dtype.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VP, _I = ctypes.c_void_p, ctypes.c_int


def vwr_depthwise_ref(x, w):
    """Plain version: x (N, H, W, C), w (KH, KW, C), stride 1, VALID;
    the KH * KW shifted products summed in fp32, one cast.  Returns
    (N, H-KH+1, W-KW+1, C)."""
    KH, KW, _ = w.shape
    Ho, Wo = x.shape[1] - KH + 1, x.shape[2] - KW + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], Ho, Wo, x.shape[3]), dtype=torch.float32,
                      device=x.device)
    for kj in range(KH):
        for ki in range(KW):
            acc += xf[:, kj:kj + Ho, ki:ki + Wo] * wf[kj, ki]
    return acc.to(x.dtype)


def vwr_depthwise(x, w):
    """x: (N, H, W, C); w: (KH, KW, C).  Returns (N, H-KH+1, W-KW+1, C)
    in x.dtype."""
    N, H, W, C = x.shape
    KH, KW, Cw = w.shape
    if Cw != C or KH > H or KW > W:
        raise ValueError(f"vwr_depthwise: needs w (KH<=H, KW<=W, C) for x "
                         f"(N, H, W, C); got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return vwr_depthwise_ref(x, w)
    build.check_operands("vwr_depthwise", x.dtype, x=(x, (N, H, W, C)),
                         w=(w, (KH, KW, C)))
    out = torch.empty((N, H - KH + 1, W - KW + 1, C), dtype=x.dtype,
                      device=x.device)
    lib, fn = build.kernel_fn("vwr_depthwise", "vwr_depthwise_launch",
                              [_VP] * 3 + [_I] * 7 + [_VP])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, KH, KW,
             build.dtype_code(x.dtype), build.stream_of(x))
    build.check(lib, err, "vwr_depthwise")
    build.count_launch("vwr_depthwise")
    return out
