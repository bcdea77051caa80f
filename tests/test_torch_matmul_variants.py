"""The rule that picks ``vwr_matmul``'s kernel for a call, and the plans of
its two bf16 variants (split-K weight streaming and wgmma tiles).

The rule and the plans are plain Python, so they are held here on the
CPU: the main path's shapes map to the variant meant for them, fp32 and
unaligned shapes map to the WMMA / FMA tile kernel, no shape that TMA or
the 16-byte weight loads cannot take reaches a bf16 variant, and every
plan covers K exactly and stays within the kernel's limits.  The kernels
themselves run on the card (``cuda``-marked cases in
``test_torch_kernels.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_matmul as KM  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
CROSS = KM.SPLITK_MAX_M


@pytest.mark.parametrize("what,M,N,K,want", [
    ("tinyllama decode down", 4, 2048, 5632, "splitk"),
    ("qwen decode down", 4, 1024, 2816, "splitk"),
    ("deepseek-v3 dense down", 4, 7168, 18432, "splitk"),
    ("deepseek-v3 shared-expert down", 4, 7168, 2048, "splitk"),
    ("a batch-1 decode", 1, 2048, 5632, "splitk"),
    ("the crossover", CROSS, 2048, 5632, "splitk"),
    ("past the crossover", CROSS + 1, 2048, 5632, "wgmma"),
    ("a mixed step: 8 slots + a 64-token chunk", 72, 2048, 5632, "wgmma"),
    ("tinyllama prefill q", 512, 2048, 2048, "wgmma"),
    ("tinyllama prefill k/v", 512, 256, 2048, "wgmma"),
    ("tinyllama prefill down + residual", 512, 2048, 5632, "wgmma"),
    ("qwen prefill qkv + bias", 512, 1024, 1024, "wgmma"),
])
def test_main_path_shapes_take_their_variant(what, M, N, K, want):
    assert KM.variant(M, N, K, BF16, True) == want, what


@pytest.mark.parametrize("M,N,K,dtype,aligned", [
    (4, 2048, 5632, F32, True),       # fp32 stays on the FMA kernel
    (512, 2048, 2048, F32, True),
    (512, 2048, 2048, BF16, False),   # an operand off 16 bytes
    (77, 333, 200, BF16, True),       # N not a multiple of 8
    (5, 24, 70, BF16, True),          # K not a multiple of 8
    (100, 50, 130, BF16, True),       # neither
    (0, 64, 64, BF16, True),          # empty products
    (8, 64, 0, BF16, True),
])
def test_fp32_and_unaligned_take_the_tile_kernel(M, N, K, dtype, aligned):
    assert KM.variant(M, N, K, dtype, aligned) == "gemm"


def test_rule_never_sends_a_row_tma_cannot_take_to_a_bf16_variant():
    """TMA and the split-K loads read 16-byte rows of x (K) and w (N)
    from 16-byte aligned bases: over random shapes, types and alignments
    the rule picks a bf16 variant only where all of that holds."""
    rng = np.random.default_rng(0)
    for _ in range(4000):
        M, N, K = (int(v) for v in rng.integers(0, 700, 3))
        dtype = BF16 if rng.random() < 0.8 else F32
        aligned = bool(rng.random() < 0.8)
        kind = KM.variant(M, N, K, dtype, aligned)
        assert kind in ("splitk", "wgmma", "gemm")
        if kind != "gemm":
            assert dtype == BF16 and aligned
            assert K % 8 == 0 and N % 8 == 0 and min(M, N, K) > 0
            assert (kind == "splitk") == (M <= CROSS)


@pytest.mark.parametrize("M,N,K", [
    (1, 2048, 5632), (4, 2048, 5632), (8, 2048, 5632), (16, 2048, 5632),
    (4, 1024, 2816), (4, 7168, 18432), (4, 7168, 2048), (5, 24, 72),
    (3, 136, 1000), (12, 264, 4104), (16, 8, 8),
])
def test_splitk_plan_covers_k_within_limits(M, N, K):
    mt, nsplit, ksplit = KM.splitk_plan(M, N, K)
    assert mt in (1, 2, 4, 8) and mt >= min(M, 8)
    assert nsplit * ksplit >= K > (nsplit - 1) * ksplit   # no empty slice
    assert mt * ksplit <= KM.SPLITK_X_FLOATS                # x's slice fits
    blocks = -(-M // mt) * -(-N // KM.SPLITK_BN) * nsplit
    assert blocks <= 65535 * 4 and nsplit <= 65535


def test_splitk_plan_fills_the_card_at_decode():
    """tinyllama's decode down projection: 16 strips of 128 columns, K
    split so that the grid gives each of the 132 SMs a block."""
    mt, nsplit, ksplit = KM.splitk_plan(4, 2048, 5632)
    assert mt == 4
    assert 16 * nsplit >= KM.SMS


@pytest.mark.parametrize("M,N,K", [
    (512, 2048, 5632), (512, 2048, 2048), (512, 256, 2048),
    (512, 1024, 1024), (72, 2048, 5632), (17, 2048, 5632), (100, 136, 200),
    (2048, 2048, 2048), (4096, 4096, 64),
])
def test_tile_plan_covers_k_and_fills_the_card(M, N, K):
    bm, nsplit, kt_split = KM.tile_plan(M, N, K)
    kt = -(-K // KM.TILE_BK)
    assert bm in (64, 128)
    assert nsplit * kt_split >= kt > (nsplit - 1) * kt_split
    tiles = -(-M // bm) * -(-N // KM.TILE_BN)
    if M <= 128:   # one row tile: the weight is read once
        assert bm == 128 and tiles == -(-N // KM.TILE_BN)
    elif bm == 128:
        assert tiles >= KM.SMS
    if nsplit > 1:   # K is split only for one row tile, to ~64 blocks
        assert M <= 128 and kt_split >= 4 and tiles * nsplit <= 64


def test_prefill_tiles_cover_the_sms_without_split():
    """512 x 5632 x 2048 (down): 64-row tiles give 128 blocks, near one an
    SM, so K is not split; 128-row tiles would give 64."""
    assert KM.tile_plan(512, 2048, 5632) == (64, 1, 88)


def test_variant_counters_reset_with_the_launch_counts():
    build.VARIANTS["vwr_matmul.splitk"] += 3
    build.reset_launches()
    assert {k for k in build.VARIANTS if k.startswith("vwr_matmul.")} == {
        "vwr_matmul.splitk", "vwr_matmul.wgmma", "vwr_matmul.gemm"}
    assert all(n == 0 for n in build.VARIANTS.values())
    x = torch.randn(4, 16)
    KM.vwr_matmul(x.bfloat16(), torch.eye(16).bfloat16())
    assert all(n == 0 for n in build.VARIANTS.values())   # CPU: plain
