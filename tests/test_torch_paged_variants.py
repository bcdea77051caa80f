"""Kernel 5 (``vwr_paged_flash_decode``) on bf16 pools: the rule that picks
its mma variant, the plan that cuts a slot's block table into splits of
whole table entries (one block each), and the variant's arithmetic (the
split's table entries as logical key slots in 64-slot tiles, 16-slot
slices to four warps, scores of the bf16 values in fp32, P as two bf16
terms against V, the warps merged in warp order, the splits in split
order) held against the plain version and the JAX op at 1e-4.
``paged_mma_emulation`` is that arithmetic in plain PyTorch; the kernel
itself runs only on the card (``chip_smoke.py`` holds it against the
plain version and the emulation).  Also the split buffers: one per
(device, stream).
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
    (BF16, 64, 8, "mma"),       # tinyllama
    (BF16, 64, 1, "mma"),       # qwen (MHA)
    (BF16, 32, 3, "mma"),
    (BF16, 128, 16, "mma"),
    (F32, 64, 8, "fma"),        # fp32 pools keep the FMA kernel
    (F32, 32, 1, "fma"),
    (BF16, 16, 4, "fma"),       # widths the wrapper pads first
    (BF16, 64, 17, "fma"),      # groups the wrapper slices first
])
def test_rule(dtype, D, G, want):
    assert KD.paged_variant(dtype, D, G) == want


@pytest.mark.parametrize("BKV,J,ps", [
    (32, 16, 16), (32, 18, 16), (128, 16, 16), (32, 128, 16), (8, 128, 16),
    (1, 4096, 16), (32, 0, 16), (6, 12, 8), (4, 10, 4), (2, 5, 64),
    (300, 40, 16), (1, 1, 1), (3, 17, 24)])
def test_plan_covers_every_table_entry_once(BKV, J, ps):
    """Splits of whole table entries, each starting before J, whose union
    is [0, J): every entry, so every key, in exactly one split."""
    nsplit, jps = KD.paged_plan(BKV, J, ps)
    assert jps > 0 and 1 <= nsplit <= KD.DECODE_MAX_SPLITS
    assert nsplit * jps >= J
    assert (nsplit - 1) * jps < max(J, 1)
    owner = [j // jps for j in range(J)]
    assert sorted(set(owner)) == list(range(nsplit if J else 0))


@pytest.mark.parametrize("BKV,J,ps", [
    (32, 0, 16), (1, 0, 8), (32, 5, 16), (1, 2, 16), (4, 11, 8), (2, 23, 4),
    (6, 1, 64)])
def test_plan_one_block_a_group_without_two_splits_of_keys(BKV, J, ps):
    """No keys, or fewer than two splits' ``PAGED_MIN_KEYS`` key slots,
    take one block a group (its partial, empty or not)."""
    assert J * ps < 2 * KD.PAGED_MIN_KEYS
    assert KD.paged_plan(BKV, J, ps)[0] == 1


@pytest.mark.parametrize("BKV,J,ps", [
    (32, 16, 16), (32, 18, 16), (128, 16, 16), (32, 128, 16), (8, 128, 16),
    (1, 4096, 16), (300, 40, 16), (4, 40, 4), (2, 12, 64)])
def test_plan_is_one_wave_of_splits_of_three_slices(BKV, J, ps):
    """At most ``DECODE_BLOCKS`` blocks (two an SM) where the groups
    allow, each split of at least ``PAGED_MIN_KEYS`` key slots."""
    nsplit, jps = KD.paged_plan(BKV, J, ps)
    assert BKV * nsplit <= max(KD.DECODE_BLOCKS, BKV)
    assert nsplit == 1 or jps * ps >= KD.PAGED_MIN_KEYS


def test_plan_at_the_scheduler_tables():
    """The plans measured fastest on an NVIDIA H100 80GB HBM3 at 700 W
    (PERF.md): tinyllama's Scheduler, 8 slots x 4 KV heads at tables of 16 and 18
    pages of 16, in 4 and 6 splits (0.0137 and 0.0139 ms against one
    block a group's 0.0162 and 0.0183); qwen's 8 x 16 groups in 2 (0.0153
    against 0.0156); a 2048-key table (J 128) in 8 splits of 16 entries
    (256 keys each; 0.0224)."""
    assert KD.paged_plan(32, 16, 16) == (4, 4)
    assert KD.paged_plan(32, 18, 16) == (6, 3)
    assert KD.paged_plan(128, 16, 16) == (2, 8)
    assert KD.paged_plan(32, 128, 16) == (8, 16)


def test_plan_reads_no_counts():
    """The plan is a function of shapes alone (no host copy of the
    counts), so a paged step stays capturable in a CUDA graph."""
    import inspect
    assert list(inspect.signature(KD.paged_plan).parameters) == [
        "BKV", "J", "page_size"]


def _pool(seed, B, KV, G, D, ps, n_pages):
    """bf16-representable fp32 inputs (the same numbers on every side)."""
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).bfloat16().float()
    return bf(B * KV, G, D), bf(n_pages, ps, KV, D), bf(n_pages, ps, KV, D)


CASES = [
    # label, KV, G, D, page_size, n_pages, table, counts, plan
    ("masked middle pages", 2, 8, 64, 16, 40,
     [[3, 7, 9, 1, 30, 2], [4, 5, 6, 8, 10, 11]],
     [[16, 0, 0, 16, 3, 0], [16, 16, 9, 0, 16, 5]], None),
    ("masked middle, forced splits", 2, 8, 64, 16, 40,
     [[3, 7, 9, 1, 30, 2], [4, 5, 6, 8, 10, 11]],
     [[16, 0, 0, 16, 3, 0], [16, 16, 9, 0, 16, 5]], (3, 2)),
    ("all masked", 2, 8, 64, 16, 40, [[1, 2, 3], [4, 5, 6]],
     [[0, 0, 0], [0, 0, 0]], None),
    ("one slot all masked", 2, 4, 64, 16, 40, [[1, 2, 3], [4, 5, 6]],
     [[0, 0, 0], [16, 1, 0]], (2, 2)),
    ("entries past the pool", 1, 4, 64, 8, 12, [[11, 50, -3, 2]],
     [[8, 8, 5, 8]], None),
    ("page 8", 2, 3, 64, 8, 30, [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]],
     [[8, 8, 0, 1, 8], [8, 3, 8, 8, 0]], None),
    ("page 4, four tiles", 1, 8, 64, 4, 80,
     [list(range(0, 70, 1))], [[4] * 60 + [2] + [0] * 9], None),
    ("J 18 at pages of 16", 2, 8, 64, 16, 48,
     [list(range(18)), list(range(18, 36))],
     [[16] * 17 + [15], [16] * 3 + [4] + [0] * 14], None),
    ("G 1", 3, 1, 64, 16, 30, [[1, 2], [3, 4], [5, 6]],
     [[16, 9], [0, 16], [1, 0]], None),
    ("G 3, D 32", 2, 3, 32, 16, 20, [[1, 2, 3]] * 2,
     [[16, 16, 5], [7, 0, 0]], None),
    ("G 16, D 128", 1, 16, 128, 16, 20, [[1, 2, 3, 4, 5]],
     [[16, 16, 16, 16, 2]], (2, 3)),
]


@pytest.mark.parametrize(
    "label,KV,G,D,ps,n_pages,table,counts,plan", CASES,
    ids=[c[0] for c in CASES])
def test_mma_arithmetic_matches_the_plain_version_and_jax(
        label, KV, G, D, ps, n_pages, table, counts, plan):
    B = len(table)
    q, kp, vp = _pool(len(label), B, KV, G, D, ps, n_pages)
    tbl = torch.tensor(table, dtype=torch.int32)
    cnt = torch.tensor(counts, dtype=torch.int32)
    got = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, plan=plan)
    want = KD.vwr_paged_flash_decode_ref(q, kp, vp, tbl, cnt)
    jq = jnp.asarray(q.reshape(B, KV * G, D).numpy())
    jax_out = jops.vwr_paged_flash_decode(
        jq, jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(tbl.numpy()), jnp.asarray(cnt.numpy()), interpret=True)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(j)).reshape(w.shape), **TOL)
    for b in range(B):
        if not any(counts[b]):
            rows = slice(b * KV, (b + 1) * KV)
            assert torch.all(got[2][rows] == 0)
            assert torch.all(got[0][rows] == 0)
            assert bool((got[1][rows] == torch.tensor(KD.NEG_INF)).all())


@pytest.mark.parametrize("plan", [(1, 16), (2, 8), (4, 4), (8, 2), (5, 4)])
def test_split_count_leaves_the_partials_within_tolerance(plan):
    """Every plan of a headline-like table (one block, or splits merged
    in order) gives the same partials to the tolerance."""
    q, kp, vp = _pool(11, 2, 4, 8, 64, 16, 64)
    tbl = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    cnt = torch.tensor([[16] * 15 + [15], [16] * 6 + [4] + [0] * 9],
                       dtype=torch.int32)
    want = KD.vwr_paged_flash_decode_ref(q, kp, vp, tbl, cnt)
    for g, w in zip(KD.paged_mma_emulation(q, kp, vp, tbl, cnt, plan=plan),
                    want):
        torch.testing.assert_close(g, w, **TOL)


def test_one_bf16_term_misses_the_tolerance():
    """Why P is split into two bf16 terms: P rounded once to bf16 (the
    scores and sums kept in fp32) leaves the 1e-4 limit."""
    q, kp, vp = _pool(3, 2, 2, 8, 64, 16, 40)
    tbl = torch.tensor([[3, 7, 9, 1, 30], [4, 5, 6, 8, 10]],
                       dtype=torch.int32)
    cnt = torch.tensor([[16, 16, 16, 16, 9], [16, 16, 0, 16, 16]],
                       dtype=torch.int32)
    want = KD.vwr_paged_flash_decode_ref(q, kp, vp, tbl, cnt)
    once = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, terms=1)
    excess = ((once[0] - want[0]).abs() - 1e-4
              - 1e-4 * want[0].abs()).max().item()
    assert excess > 0


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    q, kp, vp = _pool(5, 1, 2, 4, 64, 16, 8)
    tbl = torch.tensor([[1, 2]], dtype=torch.int32)
    cnt = torch.tensor([[16, 3]], dtype=torch.int32)
    KD.vwr_paged_flash_decode(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                              tbl, cnt)
    KD.vwr_paged_flash_decode(q, kp, vp, tbl, cnt)
    assert build.VARIANTS["vwr_paged_flash_decode.mma"] == 0
    assert build.VARIANTS["vwr_paged_flash_decode.fma"] == 0
    assert build.LAUNCHES["vwr_paged_flash_decode"] == 0


@pytest.mark.parametrize("get", [build.split_counters, build.split_workspace],
                         ids=["counters", "workspace"])
def test_split_buffers_belong_to_one_stream(get, monkeypatch):
    """Two stream handles on one device give two buffers, so launches in
    flight on two streams (or a graph replayed beside eager work) cannot
    race on a counter or a partial; the same handle gives the same buffer
    back, grown when a call needs more."""
    monkeypatch.setattr(build, "_SPLIT_COUNTERS", {})
    monkeypatch.setattr(build, "_SPLIT_WORKSPACE", {})
    dev = torch.device("cpu")
    a, b = get(dev, 1111, 16), get(dev, 2222, 16)
    assert a.data_ptr() != b.data_ptr()
    assert get(dev, 1111, 16) is a and get(dev, 2222, 8) is b
    grown = get(dev, 1111, a.numel() + 1)
    assert grown.numel() > a.numel() and get(dev, 2222, 16) is b
    assert get(dev, 1111, 16) is grown
