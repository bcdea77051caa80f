"""Direct NHWC conv2d with a fused bias + activation epilogue: the plain
version and the CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_conv2d.vwr_conv2d_p``; the kernel is
``csrc/vwr_conv2d.cu`` (an implicit GEMM that stages each halo'd input
tile once in shared memory and reads it once per tap: no im2col).  Both
sum every tap's products in fp32 and apply the epilogue (bias, then the
activation: relu, gelu in its tanh form as ``jax.nn.gelu``, or silu) to
the fp32 sum before one cast to x's dtype.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vwr_matmul import ACT_CODES, ACTIVATIONS

_VP, _I = ctypes.c_void_p, ctypes.c_int


def vwr_conv2d_ref(x, w, bias=None, *, activation=None):
    """Plain version: x (N, H, W, C), w (KH, KW, C, F), stride 1, VALID;
    the KH * KW shifted products summed in fp32, then bias (F,) and the
    activation, one cast.  Returns (N, H-KH+1, W-KW+1, F)."""
    KH, KW, _, F = w.shape
    Ho, Wo = x.shape[1] - KH + 1, x.shape[2] - KW + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], Ho, Wo, F), dtype=torch.float32,
                      device=x.device)
    for kj in range(KH):
        for ki in range(KW):
            acc += torch.einsum("nhwc,cf->nhwf",
                                xf[:, kj:kj + Ho, ki:ki + Wo], wf[kj, ki])
    if bias is not None:
        acc += bias.float()
    if activation is not None:
        acc = ACTIVATIONS[activation](acc)
    return acc.to(x.dtype)


def vwr_conv2d(x, w, bias=None, *, activation=None):
    """``act(conv2d(x, w) + bias)`` in one pass.

    x: (N, H, W, C); w: (KH, KW, C, F); bias: (F,) or None; activation
    in {None, 'relu', 'gelu', 'silu'}.  Returns (N, H-KH+1, W-KW+1, F)
    in x.dtype."""
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    N, H, W, C = x.shape
    KH, KW, Cw, F = w.shape
    if Cw != C or KH > H or KW > W:
        raise ValueError(f"vwr_conv2d: needs w (KH<=H, KW<=W, C, F) for x "
                         f"(N, H, W, C); got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return vwr_conv2d_ref(x, w, bias, activation=activation)
    build.check_operands("vwr_conv2d", x.dtype, x=(x, (N, H, W, C)),
                         w=(w, (KH, KW, C, F)), bias=(bias, (F,)))
    out = torch.empty((N, H - KH + 1, W - KW + 1, F), dtype=x.dtype,
                      device=x.device)
    lib, fn = build.kernel_fn("vwr_conv2d", "vwr_conv2d_launch",
                              [_VP] * 4 + [_I] * 9 + [_VP])
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             N, H, W, C, KH, KW, F, build.dtype_code(x.dtype),
             ACT_CODES[activation], build.stream_of(x))
    build.check(lib, err, "vwr_conv2d")
    build.count_launch("vwr_conv2d")
    return out
