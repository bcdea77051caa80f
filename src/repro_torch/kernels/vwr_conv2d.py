"""Direct NHWC conv2d with a fused bias + activation epilogue: the plain
version and the CUDA kernel wrapper.

Counterpart of ``repro.kernels.vwr_conv2d.vwr_conv2d_p``; the kernels
are ``csrc/vwr_conv2d.cu``, implicit GEMMs without an im2col buffer.  All
sum every tap's products in fp32 and apply the epilogue (bias, then the
activation: relu, gelu in its tanh form as ``jax.nn.gelu``, or silu) to
the fp32 sum before one cast to x's dtype.

``variant`` picks the kernel of a call from its shape, type and the
operands' alignment: ``"wgmma"`` (bf16 with C and F multiples of 8: the
output pixels flattened across images as the GEMM's rows, wgmma tiles fed
by cp.async gathers and TMA, the K steps split across blocks where the
tiles alone leave most SMs idle, ``plan``) or ``"tile"`` (fp32, and the
bf16 shapes the first cannot take: a 4 x 16-pixel tile of one image with
its halo staged once a channel chunk, WMMA / FMA).  Both are hand-written
kernels of this repository; neither is the plain version.
``build.VARIANTS`` counts the launches of each.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.vwr_matmul import ACT_CODES, ACTIVATIONS, SMS

_VP, _I = ctypes.c_void_p, ctypes.c_int

SLICE = 64          # channels a K step of the wgmma variant (128 bytes)
STAGES = 4          # csrc STAGES: the ring of K steps
SMEM_LIMIT = 232448  # dynamic shared memory a block can have
# The plan's rules, measured on the H100 (PERF.md, the plan table of
# chip_smoke.py): 128-row tiles where they give every SM two tiles; below
# SMS output tiles the K steps are split toward ~SMS blocks, at least
# MIN_STEPS steps a split (each split adds a partial the last block of
# the tile reads back), on 64-filter tiles past a 2-way split.
MIN_STEPS = 8


def _cdiv(a, b):
    return -(-a // b)


def variant(N, H, W, C, KH, KW, F, dtype, aligned):
    """The kernel that serves a ``vwr_conv2d`` call: "wgmma" or "tile".
    ``aligned``: every operand's address is a multiple of 16 bytes.  The
    wgmma variant gathers 16-byte runs of channels and reads the weights
    by TMA (16-byte rows): C and F must be multiples of 8.  fp32 calls,
    shapes that break this, and empty outputs take the tile kernel."""
    if (str(dtype) != "torch.bfloat16" or not aligned or C % 8 or F % 8
            or min(N, H - KH + 1, W - KW + 1, F) <= 0):
        return "tile"
    return "wgmma"


def smem_bytes(bm, bn):
    """Dynamic shared memory of a wgmma block (csrc WgShape::SMEM)."""
    return 1024 + STAGES * (bm * 128 + bn * 128) + 2 * STAGES * 8


def plan(N, H, W, C, KH, KW, F):
    """(bm, bn, nsplit, kt_split) of the wgmma variant.  The GEMM has M =
    N * H_out * W_out rows, F columns and KH * KW * ceil(C / 64) K steps.
    bn is 64 for F <= 64, else 128; bm 128 where 128-row tiles give every
    SM two tiles, else 64.  Below SMS tiles the K steps are split into
    balanced slices of at least MIN_STEPS, toward ~SMS blocks; a split
    wider than 2 takes 64-filter tiles: the last block of a tile sums
    nsplit partials of it, so narrow tiles keep that serial tail short."""
    M = N * (H - KH + 1) * (W - KW + 1)
    kt = KH * KW * _cdiv(C, SLICE)

    def split(bn):
        tiles = _cdiv(M, bm) * _cdiv(F, bn)
        if tiles >= SMS:
            return 1
        return _cdiv(kt, max(MIN_STEPS, kt // _cdiv(SMS, tiles)))

    bn = 64 if F <= 64 else 128
    bm = 128 if _cdiv(M, 128) * _cdiv(F, bn) >= 2 * SMS else 64
    nsplit = split(bn)
    if nsplit > 2:
        bn = 64
        nsplit = split(bn)
    return bm, bn, nsplit, _cdiv(kt, nsplit)


def scratch_sizes(N, H, W, C, KH, KW, F, plan_):
    """(workspace floats, counters) a wgmma launch of ``plan_`` needs: the
    nsplit fp32 partials of the (M, F) output (none unsplit) and one
    counter an output tile."""
    bm, bn, nsplit, _ = plan_
    M = N * (H - KH + 1) * (W - KW + 1)
    return (nsplit * M * F if nsplit > 1 else 0,
            _cdiv(M, bm) * _cdiv(F, bn))


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
    return launch(x, w, bias, activation,
                  variant(N, H, W, C, KH, KW, F, x.dtype, True))


def launch(x, w, bias, activation, kind, plan_=None):
    """One launch of variant ``kind`` on operands ``vwr_conv2d`` checked
    (every one contiguous and 16-byte aligned); ``vwr_conv2d`` passes
    ``variant``'s choice.  With no ``plan_`` the wgmma variant takes
    ``autotune.conv_plan``'s: ``plan``'s unless a tuning pass persisted
    another.  chip_smoke.py also times other plans through it."""
    if kind != "tile" and plan_ is None:
        plan_ = autotune.conv_plan(x, w, bias, activation)
    N, H, W, C = x.shape
    KH, KW, _, F = w.shape
    out = torch.empty((N, H - KH + 1, W - KW + 1, F), dtype=x.dtype,
                      device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    if kind == "tile":
        lib, fn = build.kernel_fn("vwr_conv2d", "vwr_conv2d_launch",
                                  [_VP] * 4 + [_I] * 9 + [_VP])
        err = fn(*ptrs, N, H, W, C, KH, KW, F, build.dtype_code(x.dtype),
                 ACT_CODES[activation], build.stream_of(x))
    else:
        n_ws, n_counters = scratch_sizes(N, H, W, C, KH, KW, F, plan_)
        ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
              if n_ws else None)
        stream = build.stream_of(x)
        counters = build.split_counters(x.device, stream, n_counters)
        lib, fn = build.kernel_fn("vwr_conv2d", "vwr_conv2d_wgmma_launch",
                                  [_VP] * 6 + [_I] * 12 + [_VP])
        err = fn(*ptrs, None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), N, H, W, C, KH, KW, F, *plan_,
                 ACT_CODES[activation], stream)
    build.check(lib, err, "vwr_conv2d")
    build.count_launch("vwr_conv2d", kind)
    return out
