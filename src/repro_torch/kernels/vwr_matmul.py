"""Fused-epilogue matmul and fused swiglu: plain versions and the CUDA
kernel wrappers.

Counterpart of ``repro.kernels.vwr_matmul`` (``vwr_matmul_p``,
``vwr_swiglu_p``); the kernels are ``csrc/vwr_matmul.cu``.  Both keep
fp32 accumulators and apply the whole epilogue to them before one cast:
``act(x @ w + bias) + residual`` and ``silu(x @ wg) * (x @ wi)``.

``variant`` picks one of ``vwr_matmul``'s three kernels per call from
the shape, the type and the operands' alignment: ``"splitk"`` (bf16, M
at most ``SPLITK_MAX_M``: decode steps stream the weight, split along K
over the SMs), ``"wgmma"`` (bf16, larger M: wgmma tiles fed by TMA) and
``"gemm"`` (fp32, and every bf16 shape whose K or N is not a multiple of
8, which TMA and 16-byte loads cannot take: the WMMA / FMA tile kernel).
``swiglu_variant`` picks one of ``vwr_swiglu``'s two: ``"wgmma"`` for
every bf16 shape the tiles take (at M 1-2 they stream the weights as
fast as a split-K kernel would, PERF.md), else ``"gemm"``.  Its two
weights are one product ``x @ [wg | wi]`` of width 2N cut into strips
that hold the same output columns of both (``swiglu_tile_plan``), so
each strip applies ``silu(g) * h`` to its own fp32 sums;
``swiglu_split_emulation`` is that layout in plain PyTorch.
Each is a hand-written kernel of this repository; none is the plain
version.  ``build.VARIANTS`` counts the launches of each beside
``build.LAUNCHES["vwr_matmul"]`` / ``["vwr_swiglu"]``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune, build

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "silu": F.silu,
}
# the csrc/common.cuh Act codes of the fused epilogues
ACT_CODES = {None: 0, "relu": 1, "silu": 2, "gelu": 3}

_VP, _I = ctypes.c_void_p, ctypes.c_int

# The crossover: bf16 calls with M at or below it stream the weight split
# along K, larger ones take wgmma tiles (measured on the H100 at M 1-72,
# PERF.md: split-K wins at 1 and 4, the tiles from 5).
SPLITK_MAX_M = 4
SMS = 132                  # streaming multiprocessors of an H100 SXM
SPLITK_BN, SPLITK_ROWS = 128, 16   # csrc SK_BN, SK_ROWS
SPLITK_X_FLOATS = 8192     # x's staged slice: 32 KB of fp32
TILE_BN, TILE_BK = 128, 64     # csrc TG_BN, TG_BK


def variant(M, N, K, dtype, aligned):
    """The kernel that serves a ``vwr_matmul`` call: "splitk", "wgmma" or
    "gemm".  ``aligned``: every operand's address is a multiple of 16
    bytes.  The two bf16 variants read 16-byte rows (TMA's rule, and the
    split-K kernel's 16-byte weight loads): K and N must be multiples of
    8.  fp32 calls, shapes that break this, and empty products take
    today's tile kernel ("gemm"), which is hand-written too."""
    if (str(dtype) != "torch.bfloat16" or not aligned or K % 8 or N % 8
            or min(M, N, K) == 0):
        return "gemm"
    return "splitk" if M <= SPLITK_MAX_M else "wgmma"


def swiglu_variant(M, N, K, dtype, aligned):
    """The kernel that serves a ``vwr_swiglu`` call (wg, wi: (K, N)):
    "wgmma" wherever ``variant`` would take a bf16 variant, else
    "gemm"."""
    return "gemm" if variant(M, N, K, dtype, aligned) == "gemm" else "wgmma"


def _cdiv(a, b):
    return -(-a // b)


def splitk_plan(M, N, K):
    """(mt, nsplit, ksplit) of the split-K variant: M tiles of mt rows
    (the next power of two, at most 8), K cut into nsplit slices of ksplit
    rows (a multiple of 16, at least 64, x's slice within 32 KB) so that
    M tiles x 128-column strips x slices reach ~1 block an SM (measured
    against 2 and 4, PERF.md)."""
    mt = min(8, 1 << (M - 1).bit_length())
    blocks = _cdiv(M, mt) * _cdiv(N, SPLITK_BN)
    ksplit = _cdiv(_cdiv(K, max(1, _cdiv(SMS, blocks))),
                   SPLITK_ROWS) * SPLITK_ROWS
    ksplit = min(max(ksplit, 64), SPLITK_X_FLOATS // mt)
    return mt, _cdiv(K, ksplit), ksplit


def tile_plan(M, N, K):
    """(bm, nsplit, kt_split) of the wgmma variant.  Up to 128 rows: one
    128-row tile a column strip, so the weight is read once, and K split
    to bring the blocks near 64 (at least 4 steps of 64 a slice).  Past
    128 rows: 128-row tiles where they alone give every SM a tile, else
    64-row ones, and no split (the partials' round trip costs more than
    the idle SMs at these shapes)."""
    kt = _cdiv(K, TILE_BK)
    if M <= 128:
        bm, tiles = 128, _cdiv(N, TILE_BN)
        nsplit = max(1, min(64 // tiles, kt // 4))
    else:
        bm = 128 if _cdiv(M, 128) * _cdiv(N, TILE_BN) >= SMS else 64
        nsplit = 1
    kt_split = _cdiv(kt, nsplit)
    return bm, _cdiv(kt, kt_split), kt_split


# output columns a strip of vwr_swiglu's wgmma variant: 64 (boxes of wg and
# wi side by side in one n128 product) or 128 (two n128 products)
SWIGLU_TILE_BNS = (64, 128)


def swiglu_tile_plan(M, N, K):
    """(bm, bn, nsplit, kt_split) of vwr_swiglu's wgmma variant.  Up to
    128 rows: tile_plan of the product ``x @ [wg | wi]`` (width 2N) in
    strips of bn = 64 output columns, 128 accumulator columns [g | h], on
    one 64-row tile up to 64 rows.  Past 128 rows: 128-row tiles on strips
    of 128 output columns (two n128 products: x read half as often), K
    whole.  Measured on the H100 (PERF.md): 128-column strips 0.069 /
    0.022 ms against 0.074 / 0.027 at 512x2048x5632 / 512x1024x2816, a
    64-row tile 0.028 against 0.031 at M 8."""
    if M > 128:
        return 128, 128, 1, _cdiv(K, TILE_BK)
    bm, nsplit, kt_split = tile_plan(M, 2 * N, K)
    return (64 if M <= 64 else bm), 64, nsplit, kt_split


_ENTRIES = {"splitk": "vwr_matmul_splitk_launch",
            "wgmma": "vwr_matmul_tile_launch"}


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
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return vwr_matmul_ref(x, w, bias, residual, activation=activation)
    M, K = x.shape
    N = w.shape[1]
    build.check_operands("vwr_matmul", x.dtype, x=(x, (M, K)),
                         w=(w, (K, N)), bias=(bias, (1, N)),
                         residual=(residual, (M, N)))
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, bias, residual)
                  if t is not None)
    return launch(x, w, bias, residual, activation,
                  variant(M, N, K, x.dtype, aligned))


def launch(x, w, bias, residual, activation, kind, plan=None):
    """One launch of variant ``kind`` on operands ``vwr_matmul`` checked;
    ``vwr_matmul`` passes ``variant``'s choice.  With no ``plan`` a split-K
    or wgmma launch takes ``autotune.matmul_plan``'s: the rule's
    (``splitk_plan`` / ``tile_plan``) unless a tuning pass persisted
    another of the same variant.  chip_smoke.py also times the variants,
    and other plans, against each other through it."""
    if kind != "gemm" and plan is None:
        plan = autotune.matmul_plan(kind, x, w, bias, residual, activation)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr())
    stream = build.stream_of(x)
    tail = (ACT_CODES[activation], stream)
    if kind == "gemm":
        lib, fn = build.kernel_fn("vwr_matmul", "vwr_matmul_launch",
                                  [_VP] * 5 + [_I] * 5 + [_VP])
        err = fn(*ptrs, M, N, K, build.dtype_code(x.dtype), *tail)
    else:
        bn = SPLITK_BN if kind == "splitk" else TILE_BN
        tile, nsplit, depth = plan
        n_counters = _cdiv(M, tile) * _cdiv(N, bn)
        ws = (torch.empty((nsplit, M, N), dtype=torch.float32,
                          device=x.device) if nsplit > 1 else None)
        counters = build.split_counters(x.device, stream, n_counters)
        lib, fn = build.kernel_fn("vwr_matmul", _ENTRIES[kind],
                                  [_VP] * 7 + [_I] * 7 + [_VP])
        err = fn(*ptrs, None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), M, N, K, tile, nsplit, depth, *tail)
    build.check(lib, err, "vwr_matmul")
    build.count_launch("vwr_matmul", kind)
    return out


def encode_us(x, w, reps=1000, weights=1):
    """Host microseconds the wgmma variant spends encoding its tensor maps
    a call (the mean of ``reps``), at x (M, K) and ``weights`` maps of w
    (K, N) on the card: 1 for ``vwr_matmul``, 2 for ``vwr_swiglu``'s wg
    and wi."""
    M, K = x.shape
    N = w.shape[1]
    lib = build.library("vwr_matmul")
    fn = lib.vwr_matmul_encode_ns
    fn.argtypes = [_VP, _VP] + [_I] * 6
    fn.restype = ctypes.c_double
    bm = (tile_plan(M, N, K) if weights == 1
          else swiglu_tile_plan(M, N, K))[0]
    ns = fn(x.data_ptr(), w.data_ptr(), M, N, K, bm, weights, reps)
    if ns < 0:
        raise RuntimeError("vwr_matmul: cuTensorMapEncodeTiled failed")
    return ns / 1e3


def swiglu_split_emulation(x, wg, wi, plan=None):
    """The wgmma variant's layout in plain PyTorch, in fp32: a strip of
    ``bn`` output columns holds wg's and wi's columns side by side, K is
    sliced by the plan (``swiglu_tile_plan``'s unless ``plan`` is given)
    into slices of kt_split 64-deep steps, each slice's product is a
    partial summed in split order, then ``silu(g) * h`` and one cast to
    x.dtype.  The order of the sums inside a slice is torch's, not the
    kernel's."""
    M, K = x.shape
    N = wg.shape[1]
    _, bn, nsplit, kt_split = plan or swiglu_tile_plan(M, N, K)
    depth = kt_split * TILE_BK
    xf, gf, hf = x.float(), wg.float(), wi.float()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    for n0 in range(0, N, bn):
        cols = slice(n0, min(N, n0 + bn))
        w = torch.cat([gf[:, cols], hf[:, cols]], 1)
        acc = torch.zeros(M, w.shape[1], device=x.device)
        for s in range(nsplit):
            ks = slice(s * depth, min(K, (s + 1) * depth))
            acc = acc + xf[:, ks] @ w[ks]
        g, h = acc.split(cols.stop - n0, 1)
        out[:, cols] = F.silu(g) * h
    return out.to(x.dtype)


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
    # check_operands raised unless every operand is 16-byte aligned
    return swiglu_launch(x, wg, wi, swiglu_variant(M, N, K, x.dtype, True))


def swiglu_launch(x, wg, wi, kind, plan=None):
    """One launch of vwr_swiglu's variant ``kind`` on operands
    ``vwr_swiglu`` checked; with no ``plan`` the wgmma variant takes
    ``autotune.swiglu_plan``'s: ``swiglu_tile_plan``'s unless a tuning
    pass persisted another.  chip_smoke.py times the variants and plans
    against each other through it."""
    if kind != "gemm" and plan is None:
        plan = autotune.swiglu_plan(x, wg, wi)
    M, K = x.shape
    N = wg.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), wg.data_ptr(), wi.data_ptr(), out.data_ptr())
    if kind == "gemm":
        lib, fn = build.kernel_fn("vwr_matmul", "vwr_swiglu_launch",
                                  [_VP] * 4 + [_I] * 4 + [_VP])
        err = fn(*ptrs, M, N, K, build.dtype_code(x.dtype),
                 build.stream_of(x))
    else:
        bm, bn, nsplit, kt_split = plan
        ws = (torch.empty((nsplit, M, 2 * N), dtype=torch.float32,
                          device=x.device) if nsplit > 1 else None)
        stream = build.stream_of(x)
        counters = build.split_counters(x.device, stream,
                                        _cdiv(M, bm) * _cdiv(N, bn))
        lib, fn = build.kernel_fn("vwr_matmul", "vwr_swiglu_tile_launch",
                                  [_VP] * 6 + [_I] * 7 + [_VP])
        err = fn(*ptrs, None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), M, N, K, bm, bn, nsplit, kt_split,
                 stream)
    build.check(lib, err, "vwr_swiglu")
    build.count_launch("vwr_swiglu", kind)
    return out
