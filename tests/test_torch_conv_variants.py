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
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

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


# ---- kernel 17 (vwr_depthwise): the row-streamed strips and their plan ----

from repro_torch.kernels import vwr_depthwise as K17  # noqa: E402

DW_LAYERS = [l for l in provet_cnn.LAYERS if l.stride == 1 and l.depthwise]
# chip_smoke.py's depthwise edges (N, H, W, C, K) and the stream kernel's
DW_EDGES = [(1, 10, 10, 8, 3), (2, 12, 9, 16, 3), (1, 9, 9, 4, 5),
            (2, 13, 21, 70, 3), (1, 20, 30, 3, 7), (2, 20, 75, 40, 3),
            (3, 30, 41, 24, 3), (2, 3, 3, 8, 3), (1, 130, 300, 64, 3)]
DW_SHAPES = ([(n, l.H_in, l.W_in, l.C_in, l.K) for l in DW_LAYERS
              for n in (1, 32)] + DW_EDGES)


def test_suite_depthwise_layers_are_the_three_mn_layers():
    assert sorted(l.name for l in DW_LAYERS) == [
        "MN_112x112", "MN_56x56", "MN_7x7"]


@pytest.mark.parametrize("C,KH,KW,want", [
    (32, 3, 3, "stream"), (128, 3, 3, "stream"), (1024, 3, 3, "stream"),
    (8, 3, 3, "stream"), (16, 3, 3, "stream"),
    (4, 5, 5, "tile"), (70, 3, 3, "tile"), (3, 7, 7, "tile"),
    (64, 1, 1, "tile"), (64, 3, 5, "tile"), (12, 3, 3, "tile")])
def test_dw_rule(C, KH, KW, want):
    """3 x 3 taps over 8-channel runs stream; other taps and ragged C keep
    the halo-tile kernel."""
    assert K17.dw_variant(C, KH, KW) == want


@pytest.mark.parametrize("N,H,W,C,Kt", DW_SHAPES, ids=str)
def test_dw_plan_covers_every_output_pixel_and_channel_once(N, H, W, C, Kt):
    """The grid (strips x column tiles, channel blocks, N) of
    ``dw_plan``'s (cb, sh, tw): every output row, column and channel of an
    image in exactly one block, no block empty, and a block's threads and
    its ring of input rows within the kernel's limits."""
    cb, sh, tw = K17.dw_plan(N, H, W, C, Kt, Kt)
    Ho, Wo = H - Kt + 1, W - Kt + 1
    assert cb % 8 == 0 and 8 <= cb <= 64 and sh >= 1 and tw >= 1
    assert tw * cb // 8 <= K17.DW_THREADS
    assert K17.DW_RING * (tw + Kt - 1) * cb * 4 <= 227 * 1024   # fp32
    seen = np.zeros((Ho, Wo, C), np.int32)
    for r0 in range(0, Ho, sh):
        for w0 in range(0, Wo, tw):
            for c0 in range(0, C, cb):
                block = seen[r0:r0 + sh, w0:w0 + tw, c0:c0 + cb]
                assert block.size > 0
                block += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("layer", DW_LAYERS, ids=[l.name for l in DW_LAYERS])
def test_dw_plan_fills_the_card_at_n32_with_whole_strips(layer):
    """N 32: the widest channel block (at most C), the fewest column tiles
    its threads allow, strips of several rows (each input row read (sh +
    2) / sh <= 1.1 times, or once where a strip is the whole image, against
    the halo tile's 1.41x at MN_56x56), and one wave: at most
    ``DW_BLOCKS`` blocks (two an SM) unless a strip is the whole image
    already, and more blocks than SMs."""
    cb, sh, tw = K17.dw_plan(32, layer.H_in, layer.W_in, layer.C_in, 3, 3)
    Ho, Wo = layer.H_in - 2, layer.W_in - 2
    assert cb == min(64, layer.C_in)
    assert -(-Wo // tw) == -(-Wo // (K17.DW_THREADS // (cb // 8)))
    assert sh == Ho or (sh + 2) / sh <= 1.1
    blocks = 32 * -(-Ho // sh) * -(-Wo // tw) * -(-layer.C_in // cb)
    assert blocks > K17.SMS
    assert blocks <= K17.DW_BLOCKS or sh == Ho


@pytest.mark.parametrize("layer", DW_LAYERS, ids=[l.name for l in DW_LAYERS])
def test_dw_plan_trades_channels_and_rows_for_blocks_at_n1(layer):
    """N 1: channel blocks narrow to 8 and strips shorten until the grid
    has more blocks than the card has SMs."""
    cb, sh, tw = K17.dw_plan(1, layer.H_in, layer.W_in, layer.C_in, 3, 3)
    Ho, Wo = layer.H_in - 2, layer.W_in - 2
    assert cb == 8
    blocks = -(-Ho // sh) * -(-Wo // tw) * -(-layer.C_in // cb)
    assert blocks > K17.SMS


def test_depthwise_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    x = torch.randn(1, 10, 10, 8).bfloat16()
    w = torch.randn(3, 3, 8).bfloat16()
    K17.vwr_depthwise(x, w)
    assert build.VARIANTS["vwr_depthwise.stream"] == 0
    assert build.VARIANTS["vwr_depthwise.tile"] == 0
    assert build.LAUNCHES["vwr_depthwise"] == 0
