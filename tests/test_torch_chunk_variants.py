"""Kernel 6 (``vwr_chunk_prefix_attend``) on bf16 pools: the rule that
picks its wgmma variant, the plan that cuts the chunk's prior pages into
splits (one block a split and 64-row block), the variant's walk over the
table (``key_tiles``: 64-key tiles of page segments, count-0 pages
skipped, slots past a page's count masked, large pages sub-tiled) and
its arithmetic (scores of the bf16 values in fp32, P as two bf16 terms
against V, the splits merged in split order) held against the plain
version and the JAX op at 1e-4.  ``chunk_wgmma_emulation`` is that
arithmetic in plain PyTorch; the kernel itself runs only on the card
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
from repro_torch.kernels import vwr_chunk as KC  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("CG,D,ps,dtype,want", [
    (512, 64, 16, BF16, "wgmma"),   # tinyllama's 64-token chunk
    (64, 64, 16, BF16, "wgmma"),    # qwen's (G 1)
    (8, 64, 16, BF16, "wgmma"),     # C 1
    (40, 32, 8, BF16, "wgmma"),
    (40, 128, 64, BF16, "wgmma"),
    (40, 64, 24, BF16, "wgmma"),
    (512, 64, 16, F32, "fma"),      # fp32 pools keep the FMA kernel
    (40, 64, 12, BF16, "fma"),      # pages off a multiple of 8
    (40, 64, 4, BF16, "fma"),
    (40, 16, 8, BF16, "fma"),       # widths the wrapper pads first
])
def test_rule(CG, D, ps, dtype, want):
    assert KC.chunk_variant(CG, D, ps, dtype) == want


@pytest.mark.parametrize("KV,CG,J,ps", [
    (4, 512, 16, 16), (4, 512, 124, 16), (4, 8, 3, 16), (16, 64, 16, 16),
    (2, 15, 4, 8), (2, 8, 4, 64), (2, 8, 5, 128), (2, 8, 7, 24),
    (1, 1, 1000, 16), (4, 512, 0, 16)])
def test_plan_covers_every_page_once(KV, CG, J, ps):
    """Splits of whole key tiles (whole pages), each starting before J,
    whose union is the table: every page in exactly one split."""
    nsplit, jps = KC.chunk_plan(KV, CG, J, ps)
    assert 1 <= nsplit <= KC.CHUNK_MAX_SPLITS
    assert nsplit * jps >= J and (nsplit - 1) * jps < max(J, 1)
    if ps <= KC.CHUNK_KEYS:
        assert jps % (KC.CHUNK_KEYS // ps) == 0
    owner = [j // jps for j in range(J)]
    assert sorted(set(owner)) == list(range(nsplit if J else 0))


def test_plan_one_block_a_row_group_without_pages():
    assert KC.chunk_plan(4, 512, 0, 16)[0] == 1


@pytest.mark.parametrize("J", [16, 124])
def test_plan_fills_the_card_at_tinyllamas_chunk(J):
    """C 64 x G 8 rows of 4 KV heads: 32 row blocks.  At 16 pages of 16
    (4 tiles) every tile is its own split: 128 blocks on 132 SMs; at 124
    pages past one block an SM."""
    nsplit, jps = KC.chunk_plan(4, 512, J, 16)
    assert 4 * 8 * nsplit >= min(KC.SMS, 32 * -(-J // 4))


def test_key_tiles_skip_empty_pages_and_mask_past_counts():
    """Pages of 16: four pages a 64-slot tile, a count-0 page skipped
    before it is read, the slots past a partial page's count masked (-1)
    wherever the page sits in the table."""
    tiles = KC.key_tiles([3, 5, 1, 7, 2, 4], [16, 0, 7, 16, 9, 16], 16)
    assert len(tiles) == 2
    assert tiles[0] == (list(range(48, 64)) + list(range(16, 23)) + [-1] * 9
                        + list(range(112, 128)) + list(range(32, 41))
                        + [-1] * 7)
    assert tiles[1] == list(range(64, 80)) + [-1] * 48


def test_key_tiles_sub_tile_large_pages():
    """Pages of 128: 64 rows of one page a tile; pages of 64: one a tile."""
    tiles = KC.key_tiles([2, 0], [100, 128], 128)
    assert [t[0] for t in tiles] == [256, 320, 0, 64]
    assert tiles[1] == list(range(320, 356)) + [-1] * 28
    assert KC.key_tiles([1, 3], [64, 0], 64) == [list(range(64, 128))]
    assert KC.key_tiles([2], [0], 64) == []


def test_key_tiles_of_pages_of_24():
    """Pages of 24: two segments a tile, the slots past them masked."""
    tiles = KC.key_tiles([1, 2, 3], [24, 24, 5], 24)
    assert tiles[0] == list(range(24, 72)) + [-1] * 16
    assert tiles[1] == list(range(72, 77)) + [-1] * 59


def _inputs(seed, KV, G, D, C, counts, ps=16, n_pages=12):
    """bf16-representable fp32 inputs (the same numbers on every side)."""
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).bfloat16().float()
    q = bf(KV, C * G, D)
    kp, vp = bf(n_pages, ps, KV, D), bf(n_pages, ps, KV, D)
    table = torch.from_numpy(rng.permutation(n_pages)[:len(counts)]
                             .astype(np.int32))
    if len(counts):
        table[-1] = n_pages + 5          # past the pool: clamped
    return q, kp, vp, table, torch.tensor(counts, dtype=torch.int32)


def _jax_partials(q, kp, vp, table, counts, G):
    """The JAX op (Pallas in interpret mode) on the port's operands: q
    (KV, C*G, D) kv-major <-> (C, H, D)."""
    KV, CG, D = q.shape
    C = CG // G
    jq = q.reshape(KV, C, G, D).permute(1, 0, 2, 3).reshape(C, KV * G, D)
    o, m, l = jops.vwr_chunk_prefix_attend(
        *(jnp.asarray(t.numpy()) for t in (jq, kp, vp, table, counts)),
        interpret=True)
    back = lambda x, *rest: (torch.from_numpy(np.array(x))  # noqa: E731
                             .reshape(C, KV, G, *rest).transpose(0, 1)
                             .reshape(KV, CG, *rest))
    return back(o, D), back(m), back(l)


CASES = [
    # KV, G, D, C, counts, ps, plan (None: chunk_plan's)
    (2, 4, 64, 8, (16, 9, 16), 16, None),        # a partial page mid-table
    (2, 4, 64, 8, (8, 0, 1), 16, None),          # count 0 and 1
    (2, 4, 64, 8, (16,) * 9 + (3,), 16, (3, 4)),  # three splits
    (2, 4, 64, 8, (0, 0, 0), 16, None),          # a first chunk: no key
    (2, 4, 64, 8, (), 16, None),                 # J 0
    (2, 4, 64, 1, (16, 16, 5), 16, None),        # C 1
    (1, 8, 64, 20, (16, 16, 9), 16, None),       # 160 rows: 3 row blocks
    (2, 3, 64, 5, (8, 8, 0, 1), 8, None),        # pages of 8
    (2, 4, 64, 8, (64, 50, 0, 64), 64, None),    # pages of 64
    (2, 4, 32, 8, (16, 9), 16, None),            # D 32
    (2, 4, 128, 8, (16, 9), 16, None),           # D 128
    (4, 1, 64, 16, (16,) * 6, 16, None),         # G 1
]


@pytest.mark.parametrize("KV,G,D,C,counts,ps,plan", CASES)
def test_wgmma_arithmetic_matches_the_plain_version_and_jax(
        KV, G, D, C, counts, ps, plan):
    args = _inputs(len(counts) + C + D, KV, G, D, C, counts, ps)
    got = KC.chunk_wgmma_emulation(*args, plan=plan)
    want = KC.vwr_chunk_prefix_attend_ref(*args)
    # the JAX op takes no empty table (its callers pass J >= 1)
    jax_out = _jax_partials(*args, G) if counts else want
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, j, **TOL)
    if not any(counts):
        assert torch.all(got[2] == 0) and torch.all(got[0] == 0)
        assert bool((got[1] == torch.tensor(KC.NEG_INF)).all())


def test_a_table_entry_past_the_pool_reads_the_last_page():
    q, kp, vp, table, counts = _inputs(2, 2, 4, 64, 4, (16, 7))
    clamped = table.clamp(0, kp.shape[0] - 1)
    for g, w in zip(KC.chunk_wgmma_emulation(q, kp, vp, table, counts),
                    KC.chunk_wgmma_emulation(q, kp, vp, clamped, counts)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_one_bf16_term_misses_the_tolerance():
    """Why P is split into two bf16 terms: P rounded once to bf16 leaves
    the 1e-4 limit."""
    args = _inputs(9, 2, 4, 64, 8, (16,) * 4)
    want = KC.vwr_chunk_prefix_attend_ref(*args)
    once = KC.chunk_wgmma_emulation(*args, terms=1)
    excess = ((once[0] - want[0]).abs() - 1e-4
              - 1e-4 * want[0].abs()).max().item()
    assert excess > 0


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    q, kp, vp, table, counts = _inputs(5, 2, 4, 64, 8, (16, 9))
    KC.vwr_chunk_prefix_attend(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                               table, counts)
    KC.vwr_chunk_prefix_attend(q, kp, vp, table, counts)
    assert build.VARIANTS["vwr_chunk_prefix_attend.wgmma"] == 0
    assert build.VARIANTS["vwr_chunk_prefix_attend.fma"] == 0
    assert build.LAUNCHES["vwr_chunk_prefix_attend"] == 0
