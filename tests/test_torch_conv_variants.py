"""The rule that picks ``vwr_conv2d``'s kernel for a call, and the plan of
its wgmma variant (tiles, and the split of the K steps across blocks).

The rule and the plan are plain Python, so they are held here on the
CPU: every stride-1 layer of the paper's suite maps to the wgmma variant
in bf16, fp32 and channel or filter counts off a multiple of 8 map to the
halo-tile kernel, every plan covers the K steps exactly within a block's
shared memory, and the batch-1 layers' plans put enough blocks on the
card.  The kernels themselves run on the card (``cuda``-marked cases in
``test_torch_conv.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import provet_cnn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_conv2d as K  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
LAYERS = [l for l in provet_cnn.LAYERS if l.stride == 1 and not l.depthwise]


def _shape(layer, n):
    return (n, layer.H_in, layer.W_in, layer.C_in, layer.K, layer.K,
            layer.C_out)


def _steps(N, H, W, C, KH, KW, F):
    return KH * KW * -(-C // K.SLICE)


@pytest.mark.parametrize("n", [1, 32])
@pytest.mark.parametrize("layer", LAYERS, ids=[l.name for l in LAYERS])
def test_suite_layers_take_wgmma_in_bf16(layer, n):
    assert K.variant(*_shape(layer, n), BF16, True) == "wgmma"


@pytest.mark.parametrize("n", [1, 32])
@pytest.mark.parametrize("layer", LAYERS, ids=[l.name for l in LAYERS])
def test_suite_layers_take_the_tile_kernel_in_fp32(layer, n):
    assert K.variant(*_shape(layer, n), F32, True) == "tile"


@pytest.mark.parametrize("N,H,W,C,KH,KW,F,dtype,aligned", [
    (2, 13, 11, 7, 3, 3, 5, BF16, True),     # the JAX tests' ragged shapes
    (1, 12, 10, 3, 5, 5, 9, BF16, True),
    (1, 10, 40, 64, 3, 3, 130, BF16, True),  # F off 8
    (1, 43, 43, 3, 7, 7, 64, BF16, True),    # C off 8
    (1, 9, 9, 64, 3, 3, 64, BF16, False),    # an operand off 16 bytes
    (1, 9, 9, 64, 3, 3, 64, F32, True),
    (0, 9, 9, 64, 3, 3, 64, BF16, True),     # empty outputs
    (1, 9, 9, 64, 3, 3, 0, BF16, True),
])
def test_fp32_ragged_and_unaligned_take_the_tile_kernel(
        N, H, W, C, KH, KW, F, dtype, aligned):
    assert K.variant(N, H, W, C, KH, KW, F, dtype, aligned) == "tile"


def test_rule_never_sends_a_row_the_gather_cannot_take_to_wgmma():
    """The wgmma variant gathers 16-byte runs of channels and reads the
    weights by TMA (16-byte rows of F): over random shapes, types and
    alignments it is picked only where C and F are multiples of 8."""
    rng = np.random.default_rng(0)
    for _ in range(3000):
        N, KH, KW = (int(v) for v in rng.integers(0, 4, 3) + (0, 1, 1))
        H, W = int(KH + rng.integers(0, 20)), int(KW + rng.integers(0, 20))
        C, F = (int(v) for v in rng.integers(1, 300, 2))
        dtype = BF16 if rng.random() < 0.8 else F32
        aligned = bool(rng.random() < 0.8)
        kind = K.variant(N, H, W, C, KH, KW, F, dtype, aligned)
        assert kind in ("wgmma", "tile")
        if kind == "wgmma":
            assert dtype == BF16 and aligned and C % 8 == 0 and F % 8 == 0
            assert N > 0 and H >= KH and W >= KW


PLAN_SHAPES = ([_shape(l, n) for l in LAYERS for n in (1, 3, 32)] + [
    (2, 9, 9, 96, 3, 3, 64), (3, 9, 9, 64, 3, 3, 128), (2, 8, 8, 64, 1, 1, 64),
    (1, 12, 12, 32, 5, 5, 64), (1, 10, 10, 8, 3, 3, 192),
    (64, 58, 58, 64, 3, 3, 64), (1, 3, 3, 2048, 3, 3, 2048)])


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_the_k_steps_within_shared_memory(shape):
    bm, bn, nsplit, kt_split = K.plan(*shape)
    kt = _steps(*shape)
    assert bm in (64, 128) and bn in (64, 128)
    assert nsplit * kt_split >= kt > (nsplit - 1) * kt_split   # no empty slice
    assert nsplit == 1 or kt_split * nsplit - kt < nsplit      # balanced
    assert K.smem_bytes(bm, bn) <= K.SMEM_LIMIT
    assert nsplit <= 65535


@pytest.mark.parametrize("layer", LAYERS, ids=[l.name for l in LAYERS])
def test_batch_one_plans_fill_the_card(layer):
    """At N 1 every suite layer's tiles alone leave most of the 132 SMs
    idle; the plan splits its K steps, on 64-filter tiles (the last block
    of a tile sums the split's partials of it), into slices of at least
    MIN_STEPS steps: fewer, longer slices beat ~100+ blocks of 2-4 steps
    on the card (the plan table in PERF.md), and the grid still reaches
    at least half the SMs, two blocks an SM fitting."""
    shape = _shape(layer, 1)
    bm, bn, nsplit, kt_split = K.plan(*shape)
    N, H, W, C, KH, KW, F = shape
    M = N * (H - KH + 1) * (W - KW + 1)
    tiles = -(-M // bm) * -(-F // bn)
    assert nsplit > 1 and bn == 64
    assert kt_split >= min(K.MIN_STEPS, _steps(*shape) // nsplit)
    assert tiles * nsplit >= K.SMS // 2
    assert 2 * K.smem_bytes(bm, bn) <= 228 * 1024


def test_big_outputs_take_128_row_tiles():
    """128-row tiles where they give every SM two: RN_56x56 and AN_27x27
    at N 32."""
    for name in ("RN_56x56", "AN_27x27"):
        layer = next(l for l in LAYERS if l.name == name)
        assert K.plan(*_shape(layer, 32))[0] == 128
    layer = next(l for l in LAYERS if l.name == "RN_28x28")
    assert K.plan(*_shape(layer, 32))[0] == 64


@pytest.mark.parametrize("layer", LAYERS, ids=[l.name for l in LAYERS])
def test_batch_32_plans_split_at_most_two_ways(layer):
    """At N 32 the tiles alone give most SMs a tile: no partials, but for
    RN_7x7's 100 tiles, whose 72 K steps go in two halves on the same
    128-filter tiles (faster than unsplit in every plan table)."""
    shape = _shape(layer, 32)
    bm, bn, nsplit, kt_split = K.plan(*shape)
    if layer.name == "RN_7x7":
        assert (bm, bn, nsplit, kt_split) == (64, 128, 2, 36)
    else:
        assert nsplit == 1 and kt_split == _steps(*shape)


def test_small_outputs_take_64_row_tiles():
    """RN_7x7 at N 1 has 49 output pixels: one 64-row tile, not 128."""
    assert K.plan(*_shape(next(l for l in LAYERS if l.name == "RN_7x7"),
                          1))[0] == 64


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_scratch_matches_the_plan(shape):
    N, H, W, C, KH, KW, F = shape
    plan = K.plan(*shape)
    bm, bn, nsplit, _ = plan
    M = N * (H - KH + 1) * (W - KW + 1)
    ws, counters = K.scratch_sizes(*shape, plan)
    assert counters == -(-M // bm) * -(-F // bn)
    assert ws == (nsplit * M * F if nsplit > 1 else 0)


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    x = torch.randn(1, 9, 9, 8).bfloat16()
    w = torch.randn(3, 3, 8, 8).bfloat16()
    K.vwr_conv2d(x, w, activation="relu")
    assert build.VARIANTS["vwr_conv2d.wgmma"] == 0
    assert build.VARIANTS["vwr_conv2d.tile"] == 0
    assert build.LAUNCHES["vwr_conv2d"] == 0
