"""The rule that picks ``vwr_matmul``'s and ``vwr_swiglu``'s kernel for a
call, and the plans of their two bf16 variants (split-K weight streaming
and wgmma tiles).

The rule and the plans are plain Python, so they are held here on the
CPU: the main path's shapes map to the variant meant for them, fp32 and
unaligned shapes map to the WMMA / FMA tile kernel, no shape that TMA or
the 16-byte weight loads cannot take reaches a bf16 variant, and every
plan covers K exactly and stays within the kernel's limits.  Swiglu's
wgmma layout (wg's and wi's columns side by side in a strip, K sliced by
the plan, partials summed in split order) is emulated in plain PyTorch
(``swiglu_split_emulation``) and the emulation is held against the plain
version and the JAX op: that checks the layout's arithmetic, not the
kernel.  The kernels themselves run on the card (``cuda``-marked cases
in ``test_torch_kernels.py``, the wgmma swiglu against this emulation
too, and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.kernels import ops as jops  # noqa: E402
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


# ---- vwr_swiglu: silu(x @ wg) * (x @ wi) ----

@pytest.mark.parametrize("what,M,K,N,want", [
    ("tinyllama prefill", 512, 2048, 5632, "wgmma"),
    ("tinyllama decode", 4, 2048, 5632, "wgmma"),
    ("Scheduler decode: 8 slots", 8, 2048, 5632, "wgmma"),
    ("a mixed step: 8 slots + a 64-token chunk", 72, 2048, 5632, "wgmma"),
    ("qwen prefill", 512, 1024, 2816, "wgmma"),
    ("qwen decode", 4, 1024, 2816, "wgmma"),
    ("deepseek-v3 shared expert", 4, 7168, 2048, "wgmma"),
    ("deepseek-v3 dense layers", 4, 7168, 18432, "wgmma"),
    ("a batch-1 decode", 1, 2048, 5632, "wgmma"),
    ("a batch-2 decode", 2, 2048, 5632, "wgmma"),
    ("a batch-3 decode", 3, 2048, 5632, "wgmma"),
    ("a batch-2 deepseek-v3 shared expert", 2, 7168, 2048, "wgmma"),
])
def test_swiglu_main_path_shapes_take_their_variant(what, M, K, N, want):
    assert KM.swiglu_variant(M, N, K, BF16, True) == want, what


def test_swiglu_takes_wgmma_wherever_matmul_takes_a_bf16_variant():
    """swiglu has no split-K variant: at every M (and over a sweep of K
    and N) it takes the wgmma tiles where ``variant`` takes either bf16
    variant, and ``gemm_kernel`` where ``variant`` does."""
    rng = np.random.default_rng(2)
    for M in range(0, 80):
        K, N = (int(v) for v in rng.integers(1, 600, 2))
        for k, n in ((2048, 5632), (K, N), (8 * K, 8 * N)):
            want = KM.variant(M, n, k, BF16, True)
            got = KM.swiglu_variant(M, n, k, BF16, True)
            assert got == ("gemm" if want == "gemm" else "wgmma")


@pytest.mark.parametrize("M,K,N,dtype", [
    (512, 2048, 5632, F32),           # fp32 keeps the WMMA / FMA kernel
    (4, 2048, 5632, F32),
    (64, 256, 512, F32),
    (37, 100, 70, BF16),              # K and N off 8
    (37, 104, 70, BF16),              # N off 8
    (4, 100, 72, BF16),               # K off 8
])
def test_swiglu_fp32_and_off_8_take_the_tile_kernel(M, K, N, dtype):
    assert KM.swiglu_variant(M, N, K, dtype, True) == "gemm"


SWIGLU_SHAPES = [(512, 2048, 5632), (4, 2048, 5632), (8, 2048, 5632),
                 (72, 2048, 5632), (512, 1024, 2816), (4, 1024, 2816),
                 (4, 7168, 2048), (4, 7168, 18432), (1, 2048, 5632),
                 (3, 1000, 136), (37, 104, 72), (300, 1000, 200)]


@pytest.mark.parametrize("M,K,N", SWIGLU_SHAPES)
def test_swiglu_plans_cover_k_once_in_64_wide_strips(M, K, N):
    """The wgmma plan slices K exactly once (no empty slice) into slices
    of at least 4 steps when it splits, its strips are 64 (or, past 128
    rows, 128) output columns of wg and of wi, and the grid fits."""
    bm, bn, nsplit, kt_split = KM.swiglu_tile_plan(M, N, K)
    kt = -(-K // KM.TILE_BK)
    assert bm in (64, 128) and bn in KM.SWIGLU_TILE_BNS
    assert nsplit * kt_split >= kt > (nsplit - 1) * kt_split
    # past 128 rows wide strips of 128-row tiles, K whole; else one row
    # tile (64 rows up to 64), the weights read once
    assert (bn == 128) == (M > 128)
    assert bm == (64 if M <= 64 else 128)
    if M > 128:
        assert nsplit == 1
    if nsplit > 1:
        assert kt_split >= 4
    assert -(-M // bm) <= 65535 and nsplit <= 65535   # grid y and z


@pytest.mark.parametrize("M,K,N,plan", [
    # tinyllama's gate/up at prefill: 44 strips of 128 output columns x 4
    # row tiles of 128 (176 blocks), K whole
    (512, 2048, 5632, (128, 128, 1, 32)),
    # qwen's: 22 strips x 4 (88 blocks)
    (512, 1024, 2816, (128, 128, 1, 16)),
    # a mixed step: one row tile of 128, 88 strips of 64
    (72, 2048, 5632, (128, 64, 1, 32)),
    # the Scheduler's decode: one row tile of 64
    (8, 2048, 5632, (64, 64, 1, 32)),
])
def test_swiglu_tile_plan_at_the_main_path(M, K, N, plan):
    assert KM.swiglu_tile_plan(M, N, K) == plan


@pytest.mark.parametrize("M,K,N,plan", [
    (4, 2048, 320, None),              # the rule's own plans
    (72, 512, 200, None),
    (300, 1000, 200, None),
    (5, 1000, 136, (64, 64, 4, 4)),    # four slices, the last step short
    (4, 2048, 320, (64, 128, 8, 4)),   # eight slices on 128-column strips
    (37, 640, 72, (64, 64, 3, 4)),     # three slices of 4 steps
    (37, 640, 200, (128, 128, 2, 5)),  # 128-column strips
])
def test_swiglu_split_layout_matches_the_plain_version(M, K, N, plan):
    """The emulation of the wgmma layout (wg's and wi's columns side by
    side in a strip, K sliced by the plan, partials summed in split
    order, then silu(g) * h) computes the plain version's function to
    fp32 rounding.  This holds the emulation, not the kernel."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    wg, wi = (torch.from_numpy(rng.standard_normal((K, N), np.float32)
                               * K ** -0.5) for _ in range(2))
    got = KM.swiglu_split_emulation(x, wg, wi, plan)
    torch.testing.assert_close(got, KM.vwr_swiglu_ref(x, wg, wi),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("M,K,N", [(16, 32, 48), (7, 20, 16)])
def test_swiglu_split_layout_matches_jax(_no_autotune, bn, M, K, N):
    """The same emulation, on 64- and 128-column strips, against the JAX
    op (Pallas in interpret mode) on the same numpy inputs, fp32: the
    layout's arithmetic, not the kernel."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wg, wi = ((rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
              for _ in range(2))
    want = jops.vwr_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wi))
    got = KM.swiglu_split_emulation(
        *(torch.from_numpy(a) for a in (x, wg, wi)), (64, bn, 1, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)


def test_swiglu_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    x = torch.randn(4, 16).bfloat16()
    KM.vwr_swiglu(x, torch.eye(16).bfloat16(), torch.eye(16).bfloat16())
    assert all(n == 0 for n in build.VARIANTS.values())   # CPU: plain
    assert build.LAUNCHES["vwr_swiglu"] == 0
