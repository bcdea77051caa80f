"""Fused-epilogue matmul and fused swiglu: plain versions and the CUDA
kernel wrappers.

Counterpart of ``repro.kernels.vwr_matmul`` (``vwr_matmul_p``,
``vwr_swiglu_p``); the kernels are ``csrc/vwr_matmul.cu``.  Both keep
fp32 accumulators and apply the whole epilogue to them before one cast:
``act(x @ w + bias) + residual`` and ``silu(x @ wg) * (x @ wi)``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "silu": F.silu,
}
_ACT_CODES = {None: 0, "relu": 1, "silu": 2, "gelu": 3}

_VP, _I = ctypes.c_void_p, ctypes.c_int


def vwr_matmul_ref(x, w, bias=None, residual=None, *, activation=None):
    """Plain version: fp32 product, epilogue bias -> act -> residual,
    one cast to x.dtype."""
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = ACTIVATIONS[activation](out)
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def vwr_swiglu_ref(x, wg, wi):
    """Plain version: ``silu(g) * h`` on the fp32 products, then the
    cast (the kernel's order; the 'torch' swiglu op casts silu(g)
    first, as the JAX 'xla' op does)."""
    xf = x.float()
    return (F.silu(xf @ wg.float()) * (xf @ wi.float())).to(x.dtype)


def vwr_matmul(x, w, bias=None, residual=None, *, activation=None):
    """``act(x @ w + bias) + residual`` in one pass.

    x: (M, K); w: (K, N); bias: (1, N) or None; residual: (M, N) or
    None; activation in {None, 'relu', 'silu', 'gelu'}.  Returns (M, N)
    in x.dtype."""
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return vwr_matmul_ref(x, w, bias, residual, activation=activation)
    M, K = x.shape
    N = w.shape[1]
    build.check_operands("vwr_matmul", x.dtype, x=(x, (M, K)),
                         w=(w, (K, N)), bias=(bias, (1, N)),
                         residual=(residual, (M, N)))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, fn = build.kernel_fn("vwr_matmul", "vwr_matmul_launch",
                              [_VP] * 5 + [_I] * 5 + [_VP])
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if residual is None else residual.data_ptr(),
             out.data_ptr(), M, N, K, build.dtype_code(x.dtype),
             _ACT_CODES[activation], build.stream_of(x))
    build.check(lib, err, "vwr_matmul")
    build.count_launch("vwr_matmul")
    return out


def vwr_swiglu(x, wg, wi):
    """``silu(x @ wg) * (x @ wi)`` in one pass: one staged x tile feeds
    both products.  x: (M, K); wg, wi: (K, N).  Returns (M, N) in
    x.dtype."""
    if x.device.type == "cpu":
        return vwr_swiglu_ref(x, wg, wi)
    M, K = x.shape
    N = wg.shape[1]
    build.check_operands("vwr_swiglu", x.dtype, x=(x, (M, K)),
                         wg=(wg, (K, N)), wi=(wi, (K, N)))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, fn = build.kernel_fn("vwr_matmul", "vwr_swiglu_launch",
                              [_VP] * 4 + [_I] * 4 + [_VP])
    err = fn(x.data_ptr(), wg.data_ptr(), wi.data_ptr(), out.data_ptr(),
             M, N, K, build.dtype_code(x.dtype), build.stream_of(x))
    build.check(lib, err, "vwr_swiglu")
    build.count_launch("vwr_swiglu")
    return out
