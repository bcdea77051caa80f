"""Depthwise NHWC conv2d (the paper's low-reuse case): the plain version
and the CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_depthwise.vwr_depthwise_p``; the
kernel is ``csrc/vwr_depthwise.cu``.  ``out[n, i, j, c] = sum over
(kj, ki) of x[n, i+kj, j+ki, c] * w[kj, ki, c]``: no reduction across
channels, no bias, no activation; the products summed in fp32, one cast
to x's dtype.

Two kernels, and ``dw_variant`` picks one per call: ``"stream"`` (3 x 3
taps and C a multiple of 8, every depthwise layer of the paper's suite:
one block an image, channel block and strip of output rows, the strip's
input rows streamed once through a ring of ``DW_RING`` rows in shared
memory while each thread's 8 channels accumulate three output rows;
``dw_plan`` sizes the blocks from the shape) or ``"tile"`` (other taps,
C off 8: the 8 x 16 halo tile).  Both sum each output's products in the
same (kj, ki) order in fp32 FMAs.  ``build.VARIANTS`` counts both;
``dw_launch`` forces a variant and a plan.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vwr_matmul import SMS

_VP, _I = ctypes.c_void_p, ctypes.c_int

# the row-streamed kernel (csrc DS_*): 3 x 3 taps, C a multiple of 8;
# 8 channels a thread, one output column each, at most DW_THREADS a block
# (two blocks an SM) in dw_plan's tiles; DW_RING input rows in shared
# memory; channel blocks of DW_CBS; dw_plan aims at one wave of DW_BLOCKS
# blocks with strips of at least DW_MIN_ROWS output rows
DW_TAPS = 3
DW_THREADS = 256
DW_RING = 10
DW_CBS = (64, 32, 16, 8)
DW_BLOCKS = 2 * SMS
DW_MIN_ROWS = 4


def _cdiv(a, b):
    return -(-a // b)


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


def dw_variant(C, KH, KW):
    """The kernel that serves a ``vwr_depthwise`` call: "stream" (the
    row-streamed strips) for 3 x 3 taps and C a multiple of 8 (16-byte
    copies of 8-channel runs), every stride-1 layer of the paper's suite;
    else "tile" (1 x 1, 5 x 5, 7 x 7 or non-square taps, ragged C)."""
    if KH == KW == DW_TAPS and C % 8 == 0:
        return "stream"
    return "tile"


@functools.lru_cache(maxsize=1024)
def dw_plan(N, H, W, C, KH, KW):
    """(cb, sh, tw) of the row-streamed kernel: channel blocks of cb, strips
    of sh output rows, column tiles of tw output columns (tw * cb / 8
    threads, at most ``DW_THREADS``: the whole output width where it fits,
    else balanced tiles, each with its KW - 1 halo columns).  The widest
    channel block of ``DW_CBS`` (at most C rounded up to 8) whose grid
    reaches ``DW_BLOCKS`` blocks with strips of at least ``DW_MIN_ROWS``
    rows, the strips as high as that allows (each input row is read
    (sh + KH - 1) / sh times); at N 1 that trades channels a block, then
    strip height, for blocks, down to cb 8."""
    Ho, Wo = H - KH + 1, W - KW + 1
    c8 = 8 * max(1, _cdiv(C, 8))
    plan = None
    for cb in sorted({min(cb, c8) for cb in DW_CBS}, reverse=True):
        tiles = _cdiv(Wo, DW_THREADS // (cb // 8))
        tw = _cdiv(Wo, tiles)
        base = N * _cdiv(C, cb) * tiles
        strips = min(Ho, max(1, DW_BLOCKS // base))
        plan = (cb, _cdiv(Ho, strips), tw)
        if plan[1] >= min(DW_MIN_ROWS, Ho):
            break
    return plan


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
    return dw_launch(x, w, dw_variant(C, KH, KW))


def dw_launch(x, w, kind, plan=None):
    """One launch of variant ``kind`` ("stream" or "tile") on operands
    ``vwr_depthwise`` checked, with ``dw_plan``'s plan unless ``plan``
    (cb, sh, tw) is given; chip_smoke.py times the plans against each
    other through it."""
    N, H, W, C = x.shape
    KH, KW, _ = w.shape
    out = torch.empty((N, H - KH + 1, W - KW + 1, C), dtype=x.dtype,
                      device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    tail = (build.dtype_code(x.dtype), build.stream_of(x))
    if kind == "tile":
        lib, fn = build.kernel_fn("vwr_depthwise", "vwr_depthwise_launch",
                                  [_VP] * 3 + [_I] * 7 + [_VP])
        err = fn(*ptrs, N, H, W, C, KH, KW, *tail)
    else:
        lib, fn = build.kernel_fn("vwr_depthwise",
                                  "vwr_depthwise_stream_launch",
                                  [_VP] * 3 + [_I] * 10 + [_VP])
        err = fn(*ptrs, N, H, W, C, KH, KW,
                 *(plan or dw_plan(N, H, W, C, KH, KW)), *tail)
    build.check(lib, err, "vwr_depthwise")
    build.count_launch("vwr_depthwise", kind)
    return out
