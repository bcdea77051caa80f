"""Kernel 4 (``vwr_flash_decode``) on bf16 caches: the rule that picks its
split variant, the plan that cuts a (batch, KV head) group's keys into
splits (one block each), and the variant's arithmetic (scores of the
bf16 values in fp32, P as two bf16 terms against V, four warps' 16-key
slices merged in warp order, the splits in split order) held against the
plain version and the JAX op at 1e-4.  ``decode_split_emulation`` is
that arithmetic in plain PyTorch; the kernel itself runs only on the card
(``cuda``-marked cases in ``test_torch_kernels.py`` and ``chip_smoke.py``,
both against the plain version and the emulation).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_decode as KD  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("dtype,D,G,want", [
    (BF16, 64, 8, "split"),     # tinyllama
    (BF16, 64, 1, "split"),     # qwen (MHA)
    (BF16, 32, 3, "split"),
    (BF16, 128, 16, "split"),
    (F32, 64, 8, "fma"),        # fp32 caches keep the FMA kernel
    (F32, 128, 16, "fma"),
    (BF16, 16, 4, "fma"),       # widths the wrapper pads first
    (BF16, 64, 17, "fma"),      # groups the wrapper slices first
])
def test_rule(dtype, D, G, want):
    assert KD.decode_variant(dtype, D, G) == want


@pytest.mark.parametrize("BKV,n_keys", [
    (16, 144), (16, 160), (16, 2048), (4, 2048), (64, 130), (1, 1),
    (16, 0), (2, 17), (4, 65), (4, 129), (1, 5000), (132, 64), (300, 16)])
def test_plan_covers_every_key_once(BKV, n_keys):
    """Splits of whole 16-key slices, each starting before n_keys, whose
    union is [0, n_keys): every key in exactly one split."""
    nsplit, kps = KD.decode_plan(BKV, n_keys)
    assert kps % KD.SPLIT_SLICE == 0 and kps > 0
    assert 1 <= nsplit <= KD.DECODE_MAX_SPLITS
    assert nsplit * kps >= n_keys
    assert (nsplit - 1) * kps < max(n_keys, 1)
    owner = [t // kps for t in range(n_keys)]
    assert sorted(set(owner)) == list(range(nsplit if n_keys else 0))


def test_plan_one_block_a_group_without_keys():
    """n_keys 0 still gives each group one block (its empty partial)."""
    assert KD.decode_plan(16, 0)[0] == 1
    assert KD.decode_plan(1, 0)[0] == 1


def test_plan_keeps_a_decode_steps_cache_in_one_split():
    """tinyllama B4 T160 cur 144 (16 groups) and qwen B4 (64 groups, G 1):
    ~150 keys a group take one block, whose three tiles are in flight at
    once; splitting them costs a merge (~2 us on the H100) that the extra
    blocks do not win back (PERF.md)."""
    assert KD.decode_plan(16, 144) == (1, 144)
    assert KD.decode_plan(16, 160) == (1, 160)
    assert KD.decode_plan(64, 130) == (1, 144)


@pytest.mark.parametrize("BKV", [16, 4])
def test_plan_splits_a_long_cache_in_256_keys(BKV):
    """B4 / B1 T2048: 8 splits of 256 keys, the plan measured fastest at
    B4 (within 4% of the fastest at B1)."""
    nsplit, kps = KD.decode_plan(BKV, 2048)
    assert (nsplit, kps) == (8, 256)
    assert kps >= KD.DECODE_MIN_KEYS


def test_plan_caps_the_splits():
    """The last block reads every split's partial: at most 32 splits."""
    assert KD.decode_plan(1, 100_000)[0] == KD.DECODE_MAX_SPLITS


def _cache(seed, B, T, KV, G, D):
    """bf16-representable fp32 inputs (the same numbers on every side)."""
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).bfloat16().float()
    return bf(B * KV, G, D), bf(B, T, KV, D), bf(B, T, KV, D)


CASES = [
    # B, T, KV, G, D, cur_len, pos0, plan (None: decode_plan's)
    (2, 160, 2, 8, 64, 144, 0, None),        # tinyllama's group: one split
    (2, 160, 2, 8, 64, 144, 0, (9, 16)),     # nine splits of a slice
    (2, 160, 2, 8, 64, 17, 0, (2, 16)),      # one key past a split
    (2, 160, 2, 8, 64, 65, 0, None),         # one key past a tile
    (2, 160, 2, 8, 64, 129, 0, (3, 48)),     # past a split and two tiles
    (1, 40, 2, 4, 64, 1, 0, None),           # one key
    (2, 40, 2, 4, 64, 3, 10, None),          # no key: m -1e30, l 0, o 0
    (2, 77, 2, 4, 64, 50, 5, None),          # a slab at pos0 > 0
    (1, 200, 1, 16, 128, 200, 0, (2, 112)),  # D 128, G 16, a partial tile
    (3, 33, 2, 3, 32, 20, 0, None),          # D 32, G 3
    (2, 48, 4, 1, 64, 48, 0, None),          # G 1
]


@pytest.mark.parametrize("B,T,KV,G,D,cur,pos0,plan", CASES)
def test_split_arithmetic_matches_the_plain_version_and_jax(
        B, T, KV, G, D, cur, pos0, plan):
    q, k, v = _cache(B * T + cur, B, T, KV, G, D)
    got = KD.decode_split_emulation(q, k, v, cur, pos0, plan=plan)
    want = KD.vwr_flash_decode_ref(q, k, v, cur, pos0)
    jq = jnp.asarray(q.reshape(B, KV * G, D).numpy())
    jax_out = jops.vwr_flash_decode(jq, jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), cur, pos0,
                                    interpret=True)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(j)).reshape(w.shape), **TOL)
    if cur <= pos0:
        assert torch.all(got[2] == 0) and torch.all(got[0] == 0)
        assert bool((got[1] == torch.tensor(KD.NEG_INF)).all())


@pytest.mark.parametrize("plan", [(1, 144), (3, 48), (9, 16), (5, 32)])
def test_split_count_leaves_the_partials_within_tolerance(plan):
    """Every plan of the headline group (one block, or splits merged in
    order) gives the same partials to the tolerance."""
    q, k, v = _cache(7, 1, 160, 1, 8, 64)
    want = KD.vwr_flash_decode_ref(q, k, v, 144)
    for g, w in zip(KD.decode_split_emulation(q, k, v, 144, plan=plan),
                    want):
        torch.testing.assert_close(g, w, **TOL)


def test_one_bf16_term_misses_the_tolerance():
    """Why P is split into two bf16 terms: P rounded once to bf16 (the
    scores and sums kept in fp32) leaves the 1e-4 limit."""
    q, k, v = _cache(3, 2, 160, 2, 8, 64)
    want = KD.vwr_flash_decode_ref(q, k, v, 144)
    once = KD.decode_split_emulation(q, k, v, 144, terms=1)
    excess = ((once[0] - want[0]).abs() - 1e-4
              - 1e-4 * want[0].abs()).max().item()
    assert excess > 0


def test_combine_skips_a_split_without_keys():
    """A split whose m is -1e30 weighs 0 in the merge: combining it with a
    real partial returns that partial."""
    o = torch.randn(2, 3, 8)
    m, l = torch.randn(2, 3), torch.rand(2, 3) + 0.5
    empty = (torch.zeros(2, 3, 8), torch.full((2, 3), KD.NEG_INF),
             torch.zeros(2, 3))
    for parts in ([empty, (o, m, l)], [(o, m, l), empty]):
        got = KD.combine_partials(parts)
        for g, w in zip(got, (o, m, l)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    q, k, v = _cache(5, 1, 40, 2, 4, 64)
    KD.vwr_flash_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(), 30)
    KD.vwr_flash_decode(q, k, v, 30)
    assert build.VARIANTS["vwr_flash_decode.split"] == 0
    assert build.VARIANTS["vwr_flash_decode.fma"] == 0
    assert build.LAUNCHES["vwr_flash_decode"] == 0
