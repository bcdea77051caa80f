"""Kernels 10 (``vwr_mla_flash_decode``, the dense latent cache) and 11
(``vwr_mla_paged_flash_decode``, latent page pools): the rule that picks
their wgmma variant, the plan that cuts a sequence's keys into splits and
its output columns into column blocks, and the variant's arithmetic (the
queries and P as two bf16 terms each, fp32 products and sums, an fp32
online softmax over 32-slot key tiles, the splits merged in split order)
held against the plain versions at DeepSeek-V3's widths and against the
JAX package's Pallas kernels (interpret mode) at a reduced shape.
``decode_split_emulation`` is that arithmetic in plain PyTorch; the cases
here hold the emulation and the plain versions, not the kernels, which
run only on the card (``chip_smoke.py`` holds them against both).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.kernels import dispatch as JD  # noqa: E402
from repro.models import mla as jmla  # noqa: E402,F401  (registers the ops)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
H, R, RP, SCALE = 128, 512, 64, 1.0 / 192 ** 0.5
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("r,rope,h,ps,dtype,want", [
    (512, 64, 128, None, BF16, "wgmma"),   # DeepSeek-V3's dense cache
    (512, 64, 128, 16, BF16, "wgmma"),     # its pages of 16
    (512, 64, 128, 8, BF16, "wgmma"),
    (512, 64, 128, 64, BF16, "wgmma"),     # larger pages are sub-tiled
    (512, 64, 128, 24, BF16, "wgmma"),
    (256, 32, 128, 16, BF16, "wgmma"),
    (128, 64, 20, None, BF16, "wgmma"),    # rows past H are masked
    (512, 64, 1, 16, BF16, "wgmma"),
    (512, 64, 128, None, F32, "fma"),      # fp32 caches keep the FMA kernel
    (512, 64, 128, 16, F32, "fma"),
    (32, 32, 4, None, BF16, "fma"),        # the reduced configs' padded
    (32, 32, 4, 8, BF16, "fma"),           # widths
    (64, 32, 128, 16, BF16, "fma"),
    (512, 64, 128, 4, BF16, "fma"),        # pages under 8 rows
    (512, 64, 128, 12, BF16, "fma"),       # or off a multiple of 8
    (512, 64, 128, 16, I8, "wgmma"),       # kernel 13 (int8 pools)
    (512, 64, 128, None, I8, "wgmma"),     # kernel 14 (the int8 cache)
    (32, 32, 4, None, I8, "fma"),          # its padded reduced widths
])
def test_rule(r, rope, h, ps, dtype, want):
    assert KM.decode_variant(r, rope, h, ps, dtype) == want


def _tiles(n, ps):
    """32-key tiles of n keys (dense, ps None) or n table entries."""
    if ps is None:
        return -(-n // KM.CHUNK_KEYS)
    if ps <= KM.CHUNK_KEYS:
        return -(-n // (KM.CHUNK_KEYS // ps))
    return n * -(-ps // KM.CHUNK_KEYS)


@pytest.mark.parametrize("B,h,n,ps,r", [
    (4, 128, 144, None, 512),      # generate's decode step
    (1, 128, 2048, None, 512),     # a long cache
    (8, 128, 17, 16, 512),         # the Scheduler's 8 slots
    (8, 128, 128, 16, 512),        # a 2048-key table
    (8, 128, 18, 8, 512),
    (3, 128, 5, 64, 512),          # pages of 64: two tiles a page
    (2, 128, 11, 24, 512),         # pages of 24: one a tile
    (3, 20, 37, None, 128),        # H 20: one masked row block a sequence
    (2, 192, 90, None, 256),
    (4, 128, 0, None, 512),        # no key
    (8, 128, 0, 16, 512),          # no table entry
    (64, 128, 300, None, 512),     # many row groups
])
def test_plan_covers_the_keys_in_whole_tiles(B, h, n, ps, r):
    """Every key (or table entry) in one split, no split starting at or
    past n, whole 32-key tiles a split (dense: per % 32 == 0; pools: per
    a multiple of the entries a tile), at most 32 splits, a column count
    the kernel has an instance for, and at most DECODE_BLOCKS blocks
    unless one a row group is already more."""
    nsplit, per, ncol = KM.mla_decode_plan(B, h, n, ps, r)
    assert 1 <= nsplit <= KM.DECODE_MAX_SPLITS
    assert nsplit * per >= n and (nsplit == 1 or (nsplit - 1) * per < n)
    if ps is None:
        assert per % KM.CHUNK_KEYS == 0
    elif ps <= KM.CHUNK_KEYS:
        assert per % (KM.CHUNK_KEYS // ps) == 0
    assert ncol in KM.decode_columns(r) or (ncol == 1
                                            and not KM.decode_columns(r))
    groups = B * -(-h // KM.DECODE_ROWS)
    assert groups * nsplit * ncol <= max(KM.DECODE_BLOCKS, groups)
    assert nsplit <= max(1, _tiles(n, ps))


def test_plan_reads_no_counts():
    """The pools' plan is a function of the table's shape and the page
    size (the paged step stays capturable): it takes no counts."""
    params = inspect.signature(KM.mla_decode_plan).parameters
    assert list(params) == ["B", "H", "n", "page_size", "r"]


@pytest.mark.parametrize("r,want", [(512, (1, 2, 4)), (256, (1, 2)),
                                    (128, (1,)), (32, ())])
def test_column_blocks_keep_64_columns_a_warpgroup(r, want):
    assert KM.decode_columns(r) == want


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, np.float32))


def _dense(seed, B, T, h=H, r=R, rope=RP):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, h, r), _rand(rng, B, h, rope),
            _rand(rng, B, T, r).to(BF16), _rand(rng, B, T, rope).to(BF16))


def _paged(seed, rows, n_pages, ps, h=H, r=R, rope=RP):
    """rows: per slot, a list of (physical page, count)."""
    rng = np.random.default_rng(seed)
    J = max(len(x) for x in rows)
    table = torch.zeros(len(rows), J, dtype=torch.int32)
    counts = torch.zeros(len(rows), J, dtype=torch.int32)
    for b, x in enumerate(rows):
        for j, (p, c) in enumerate(x):
            table[b, j], counts[b, j] = p, c
    return (_rand(rng, len(rows), h, r), _rand(rng, len(rows), h, rope),
            _rand(rng, n_pages, ps, r).to(BF16),
            _rand(rng, n_pages, ps, rope).to(BF16), table, counts)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("seed,B,T,cur,pos0,plan", [
    (0, 2, 160, 144, 0, None),            # generate's step, one split
    (1, 2, 160, 150, 30, None),           # a slab at pos0 > 0
    (2, 3, 300, 300, 0, (3, 128, 1)),     # splits ending in partial tiles
    (3, 2, 160, 33, 0, (2, 32, 4)),       # one key past a split
    (4, 1, 100, 97, 0, (4, 32, 2)),
])
def test_dense_arithmetic_matches_the_plain_version(seed, B, T, cur, pos0,
                                                    plan):
    """Within kernel 10's fp32 tolerance (atol 1e-4, rtol 1e-4)."""
    ops_ = _dense(seed, B, T)
    got = KM.decode_split_emulation(*ops_, cur_len=cur, pos0=pos0,
                                    plan=plan, scale=SCALE)
    _close(got, KM.vwr_mla_flash_decode_ref(*ops_, cur, pos0, scale=SCALE))


def test_dense_arithmetic_without_a_valid_key():
    """cur_len <= pos0: m = -1e30, l = 0, o_tilde = 0 for every row."""
    o, m, l = KM.decode_split_emulation(*_dense(5, 2, 40), cur_len=3,
                                        pos0=10, scale=SCALE)
    assert o.abs().max().item() == 0.0 and l.abs().max().item() == 0.0
    assert bool((m == torch.tensor(KM.NEG_INF)).all())


# slot 0: ragged pages, a count-0 page mid-table and an entry past the
# pool (clamped); slot 1: inactive (every count 0); slot 2: full pages
PAGED = [[(3, 16), (7, 0), (40, 9), (1, 16)], [(2, 0), (5, 0)],
         [(9, 16), (4, 16), (6, 16), (10, 5)]]


@pytest.mark.parametrize("seed,rows,ps,plan", [
    (0, PAGED, 16, None),
    (1, PAGED, 16, (4, 1, 1)),            # splits of one entry
    (2, PAGED, 16, (2, 2, 4)),
    (3, [[(2, 50), (0, 0), (1, 64)], [(3, 64)]], 64, None),   # sub-tiled
    (4, [[(5, 8), (1, 3), (7, 0), (2, 8), (11, 8)], [(0, 1)]], 8,
     (2, 4, 2)),                          # pages of 8: four a tile
])
def test_paged_arithmetic_matches_the_plain_version(seed, rows, ps, plan):
    """Within kernel 11's fp32 tolerance on ragged slots, a count-0 page,
    an entry past the pool, an inactive slot, pages of 8, 16 and 64."""
    ops_ = _paged(seed, rows, 12, ps)
    got = KM.decode_split_emulation(*ops_, plan=plan, scale=SCALE)
    _close(got, KM.vwr_mla_paged_flash_decode_ref(*ops_, scale=SCALE))
    o, m, l = got
    if not any(c for _, c in rows[1]):
        assert o[1].abs().max().item() == 0.0 and l[1].abs().max() == 0
        assert bool((m[1] == torch.tensor(KM.NEG_INF)).all())


def test_column_blocks_and_splits_change_no_value():
    """Column blocks split no arithmetic: the emulation ignores them, and
    the splits' merge stays within the tolerance of one split."""
    ops_ = _paged(6, PAGED, 12, 16)
    one = KM.decode_split_emulation(*ops_, plan=(1, 4, 1), scale=SCALE)
    cols = KM.decode_split_emulation(*ops_, plan=(1, 4, 4), scale=SCALE)
    for a, b in zip(one, cols):
        assert torch.equal(a, b)
    _close(KM.decode_split_emulation(*ops_, plan=(4, 1, 1), scale=SCALE),
           one)


def test_one_bf16_term_misses_the_tolerance():
    """Why two terms: the queries rounded once to bf16 (P and the sums
    kept in fp32) already leave the fp32 tolerance at generate's step."""
    qa, qr, ckv, kr = _dense(7, 2, 160)
    want = KM.vwr_mla_flash_decode_ref(qa, qr, ckv, kr, 144, scale=SCALE)
    once = KM.vwr_mla_flash_decode_ref(
        (qa * SCALE).bfloat16().float(), (qr * SCALE).bfloat16().float(),
        ckv, kr, 144, scale=1.0)
    excess = ((once[0] - want[0]).abs()
              - 1e-4 - 1e-4 * want[0].abs()).max().item()
    assert excess > 0


# ---------------------------------------------------------- against JAX

RB, HB, RR, RPB = 2, 4, 32, 16    # test_torch_mla.py's reduced shape


def _np(t):
    return np.asarray(t.float().numpy())


@pytest.mark.parametrize("T,cur,pos0,plan", [
    (24, 17, 0, None), (24, 30, 10, None), (20, 16, 9, None),
    (64, 64, 0, (2, 32, 1)), (70, 70, 0, (3, 32, 1)), (20, 5, 8, None)])
def test_dense_arithmetic_matches_jax(T, cur, pos0, plan):
    """Against ``vwr_mla_flash_decode_p`` (interpret mode) on bf16-exact
    caches at the reduced shape."""
    ops_ = _dense(T + cur, RB, T, HB, RR, RPB)
    want = JD.dispatch("decode_partial_mla", "pallas",
                       *(jnp.asarray(_np(t)) for t in ops_), cur, pos0,
                       scale=SCALE)
    got = KM.decode_split_emulation(*ops_, cur_len=cur, pos0=pos0,
                                    plan=plan, scale=SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)


@pytest.mark.parametrize("ps,plan", [(4, None), (4, (3, 2, 1)),
                                     (8, (2, 3, 1))])
def test_paged_arithmetic_matches_jax(ps, plan):
    """Against ``vwr_mla_paged_flash_decode_p`` (interpret mode): a ragged
    slot with a count-0 page and an entry past the pool, and an inactive
    slot."""
    rows = [[(5, ps), (2, ps), (7, 0), (12, 3), (0, 0)],
            [(1, 0), (3, 0), (0, 0), (0, 0), (0, 0)]]
    ops_ = _paged(ps, rows, 9, ps, HB, RR, RPB)
    want = JD.dispatch("decode_partial_mla_paged", "pallas",
                       *(jnp.asarray(_np(t)) for t in ops_[:4]),
                       jnp.asarray(ops_[4].numpy()),
                       jnp.asarray(ops_[5].numpy()), scale=SCALE)
    got = KM.decode_split_emulation(*ops_, plan=plan, scale=SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    KM.vwr_mla_flash_decode(*_dense(8, 1, 40), 30, scale=SCALE)
    KM.vwr_mla_paged_flash_decode(*_paged(8, PAGED, 12, 16), scale=SCALE)
    for kernel in ("vwr_mla_flash_decode", "vwr_mla_paged_flash_decode"):
        assert build.VARIANTS[f"{kernel}.wgmma"] == 0
        assert build.VARIANTS[f"{kernel}.fma"] == 0
        assert build.LAUNCHES[kernel] == 0
