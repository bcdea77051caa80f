"""Kernels 7 (``vwr_paged_flash_decode_q8``) and 13
(``vwr_mla_paged_flash_decode_q8``) on their Hopper variants: the rules
that pick them (kernel 5's mma variant and kernel 11's wgmma variant, over
int8 pages), and their arithmetic held against the plain versions and the
JAX ops at 1e-4.  The int8 values are exact in 16 bits and the page scales
are applied in fp32 around the products: kernel 7 multiplies each score by
scale times its page's k scale and P (after l) by its page's v scale and
the split's power of two before two fp16 terms; kernel 13 takes kernel
15's fp16 terms, with P's power of two from the block's own key split of
its sequence's row.  ``paged_mma_emulation`` and ``decode_split_emulation``
(with the scales) are that arithmetic in plain PyTorch; the kernels
themselves run only on the card (``chip_smoke.py``, against the plain
versions and the emulations).
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
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _use(got, want):
    """The largest share of the 1e-4 limit an output element uses."""
    return max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item()
               for g, w in zip(got, want))


def _np(t):
    return jnp.asarray(t.numpy())


def _back(x, shape):
    return torch.from_numpy(np.array(x)).reshape(shape)


# ---- the rules ----

@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 8, 16, 17])
def test_paged_rule_over_int8_pools(dtype, D, G):
    """Kernel 7 takes kernel 5's rule: bf16 queries at D 32 / 64 / 128
    and G <= 16 on the mma variant (any page size); fp32 queries (the
    reduced fp32 configs), the widths the wrapper pads first (D 16) and
    the groups it slices first (G 17) on the FMA kernel."""
    mma = dtype == BF16 and D in (32, 64, 128) and G <= 16
    assert KD.paged_variant(dtype, D, G) == ("mma" if mma else "fma")


@pytest.mark.parametrize("r", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("rope", [32, 64])
@pytest.mark.parametrize("ps", [None, 4, 8, 16, 24, 64])
def test_mla_rule_over_int8_caches(r, rope, ps):
    """Kernel 13 (int8 pools) takes the wgmma variant at r 128 / 256 /
    512, rope 32 / 64 and pages of a multiple of 8 rows, and so does
    kernel 14's dense int8 cache (``ps`` None) at those widths; pages of 4
    and the padded ranks the FMA kernel."""
    wgmma = (ps is None or ps % 8 == 0) and r in (128, 256, 512)
    assert KM.decode_variant(r, rope, 128, ps, I8) == ("wgmma" if wgmma
                                                      else "fma")


# ---- kernel 7: the mma variant over int8 pages ----

def _pools(seed, B, KV, G, D, ps, n_pages):
    """bf16-representable fp32 queries, int8 pools, (n_pages, KV) scales."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B * KV, G, D)).astype(
        np.float32)).bfloat16().float()
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, KV, D))
                               .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((n_pages, KV)) * 0.02 + 1e-3)
                               .astype(np.float32)) for _ in range(2))
    return q, kp, vp, ks, vs


PAGED_CASES = [
    # label, KV, G, D, page_size, n_pages, table, counts, plan
    ("count-0 and partial pages", 2, 8, 64, 16, 40,
     [[3, 7, 9, 1, 30, 2], [4, 5, 6, 8, 10, 11]],
     [[16, 0, 0, 16, 3, 0], [16, 16, 9, 0, 16, 5]], None),
    ("the same, forced splits", 2, 8, 64, 16, 40,
     [[3, 7, 9, 1, 30, 2], [4, 5, 6, 8, 10, 11]],
     [[16, 0, 0, 16, 3, 0], [16, 16, 9, 0, 16, 5]], (3, 2)),
    ("splits of one entry", 2, 8, 64, 16, 40,
     [[3, 7, 9, 1, 30, 2], [4, 5, 6, 8, 10, 11]],
     [[16, 16, 16, 16, 3, 0], [16, 16, 9, 0, 16, 5]], (6, 1)),
    ("an inactive slot", 2, 4, 64, 16, 40, [[1, 2, 3], [4, 5, 6]],
     [[0, 0, 0], [16, 1, 0]], (2, 2)),
    ("entries past the pool", 1, 4, 64, 8, 12, [[11, 50, -3, 2]],
     [[8, 8, 5, 8]], None),
    ("pages of 8", 2, 3, 64, 8, 30, [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]],
     [[8, 8, 0, 1, 8], [8, 3, 8, 8, 0]], None),
    ("pages of 24", 2, 8, 64, 24, 20, [[1, 2, 3, 4], [5, 6, 7, 8]],
     [[24, 24, 5, 0], [24, 0, 24, 13]], (2, 2)),
    ("G 1", 3, 1, 64, 16, 30, [[1, 2], [3, 4], [5, 6]],
     [[16, 9], [0, 16], [1, 0]], None),
    ("G 8, D 32", 2, 8, 32, 16, 20, [[1, 2, 3]] * 2,
     [[16, 16, 5], [7, 0, 0]], None),
    ("G 16, D 128", 1, 16, 128, 16, 20, [[1, 2, 3, 4, 5]],
     [[16, 16, 16, 16, 2]], (2, 3)),
    ("G 16, D 32, pages of 8", 1, 16, 32, 8, 20, [[1, 2, 3, 4, 5, 6]],
     [[8, 8, 0, 8, 8, 3]], (3, 2)),
]


@pytest.mark.parametrize(
    "label,KV,G,D,ps,n_pages,table,counts,plan", PAGED_CASES,
    ids=[c[0] for c in PAGED_CASES])
def test_paged_q8_arithmetic_matches_the_plain_version_and_jax(
        label, KV, G, D, ps, n_pages, table, counts, plan):
    B = len(table)
    q, kp, vp, ks, vs = _pools(len(label) + D, B, KV, G, D, ps, n_pages)
    tbl = torch.tensor(table, dtype=torch.int32)
    cnt = torch.tensor(counts, dtype=torch.int32)
    got = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, plan=plan,
                                 scales=(ks, vs))
    want = KD.vwr_paged_flash_decode_q8_ref(q, kp, vp, ks, vs, tbl, cnt)
    jax_out = jops.vwr_paged_flash_decode_q8(
        _np(q.reshape(B, KV * G, D)), *(_np(t) for t in (kp, vp, ks, vs,
                                                        tbl, cnt)),
        interpret=True)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, _back(j, w.shape), **TOL)
    for b in range(B):
        if not any(counts[b]):
            rows = slice(b * KV, (b + 1) * KV)
            assert torch.all(got[2][rows] == 0)
            assert torch.all(got[0][rows] == 0)
            assert bool((got[1][rows] == torch.tensor(KD.NEG_INF)).all())


def _long_table(seed, lens, J, ps, n_pages):
    """chip_smoke's tables: each slot's live pages a permuted page each,
    zero past them."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_pages)
    table = np.zeros((len(lens), J), np.int32)
    counts = np.zeros((len(lens), J), np.int32)
    k = 0
    for b, n in enumerate(lens):
        live = -(-n // ps)
        table[b, :live] = perm[k:k + live]
        counts[b, :live] = np.clip(n - ps * np.arange(live), 0, ps)
        k += live
    return torch.from_numpy(table), torch.from_numpy(counts)


HEADLINE_LENS = (0, 1, 16, 17, 255, 100, 200, 64)
LONG_LENS = (2048, 1900, 1500, 1024, 777, 2000, 100, 1)


@pytest.mark.parametrize("lens,J,n_pages", [
    (HEADLINE_LENS, 16, 1024), (LONG_LENS, 128, 1200)],
    ids=["headline J 16", "J 128"])
def test_paged_q8_takes_fp16_p_terms(lens, J, n_pages):
    """Why kernel 7's P terms are fp16 (P times its v scale and the
    split's power of two): at chip_smoke's headline table (653 keys) and
    its J 128 table (up to 2,048 keys a slot; 8 splits) two fp16 terms
    use under a tenth of the limit, two bf16 terms (P times its v scale,
    no scaling) more than that but under half; both under half, fp16 by
    the wider margin."""
    q, kp, vp, ks, vs = _pools(J, 8, 4, 8, 64, 16, n_pages)
    tbl, cnt = _long_table(J, lens, J, 16, n_pages)
    want = KD.vwr_paged_flash_decode_q8_ref(q, kp, vp, ks, vs, tbl, cnt)
    f16 = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, scales=(ks, vs))
    bf = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, scales=(ks, vs),
                                p_terms=KD.bf16_terms)
    assert _use(f16, want) < 0.1 < _use(bf, want) < 0.5


def test_paged_q8_one_p_term_misses_the_tolerance():
    """Why P is split into two terms: P rounded once to fp16 leaves the
    1e-4 limit."""
    q, kp, vp, ks, vs = _pools(3, 2, 2, 8, 64, 16, 40)
    tbl = torch.tensor([[3, 7, 9, 1, 30], [4, 5, 6, 8, 10]],
                       dtype=torch.int32)
    cnt = torch.tensor([[16, 16, 16, 16, 9], [16, 16, 0, 16, 16]],
                       dtype=torch.int32)
    want = KD.vwr_paged_flash_decode_q8_ref(q, kp, vp, ks, vs, tbl, cnt)
    once = KD.paged_mma_emulation(q, kp, vp, tbl, cnt, terms=1,
                                  scales=(ks, vs))
    assert _use(once, want) > 1


def _stepped(scales, table, counts, late_from, step=2.0 ** 12):
    """The scales of the live pages a slot holds before entry
    ``late_from`` divided by ``step`` (new tensors)."""
    tbl = table.long().clamp(0, scales[0].shape[0] - 1)
    early = tbl[:, :late_from][counts[:, :late_from] > 0].unique()
    out = []
    for s in scales:
        s = s.clone()
        s[early] /= step
        out.append(s)
    return out


def test_paged_q8_power_of_two_is_the_splits_own(monkeypatch):
    """v scales 2^12 apart between a slot's first and last split (4
    splits), slot 0 in its first split alone: the split's own power of
    two holds the limit; taken from slot 0's row (one power for every
    block), or from each group's first split, P's fp16 terms overflow in
    the last splits."""
    q, kp, vp, ks, vs = _pools(8, 3, 2, 8, 64, 16, 64)
    tbl, cnt = _long_table(8, (64, 255, 200), 16, 16, 64)
    (vs,) = _stepped((vs,), tbl, cnt, 12)
    want = KD.vwr_paged_flash_decode_q8_ref(q, kp, vp, ks, vs, tbl, cnt)

    def run():
        return KD.paged_mma_emulation(q, kp, vp, tbl, cnt, plan=(4, 4),
                                      scales=(ks, vs))
    for g, w in zip(run(), want):
        torch.testing.assert_close(g, w, **TOL)
    own = KD.split_p_up
    for wrong in (lambda vc, x0, x1: own(vc[:1], 0, vc.shape[1]).expand(
                      vc.shape[0]),
                  lambda vc, x0, x1: own(vc, 0, x1 - x0)):
        monkeypatch.setattr(KD, "split_p_up", wrong)
        assert not all(bool(torch.isfinite(x).all()) for x in run())


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_q8_entry_past_the_pool_reads_the_last_page(seed):
    q, kp, vp, ks, vs = _pools(seed, 1, 2, 4, 64, 8, 12)
    tbl = torch.tensor([[11, 50, -3, 2]], dtype=torch.int32)
    cnt = torch.tensor([[8, 8, 5, 8]], dtype=torch.int32)
    clamped = tbl.clamp(0, 11)
    for g, w in zip(
            KD.paged_mma_emulation(q, kp, vp, tbl, cnt, scales=(ks, vs)),
            KD.paged_mma_emulation(q, kp, vp, clamped, cnt,
                                   scales=(ks, vs))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---- kernel 13: the wgmma variant over int8 latent pages ----

H, R, RP = 128, 512, 64
SCALE = 1.0 / 192 ** 0.5


def _latent(seed, B, h, r, rope, ps, n_pages):
    """fp32 queries, int8 latent and rope pools, (n_pages,) scales."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    qa, qr = f(B, h, r), f(B, h, rope)
    ckv, kr = (torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, w))
                                .astype(np.int8)) for w in (r, rope))
    cs, rs = (torch.from_numpy((rng.random(n_pages) * 0.02 + 1e-3)
                               .astype(np.float32)) for _ in range(2))
    return qa, qr, ckv, kr, cs, rs


def _mla_headline(seed):
    """chip_smoke's headline: 8 slots, J 17 of 16 (637 keys in 43 live
    pages), a count-0 page, an inactive slot, an entry past the pool."""
    tbl, cnt = _long_table(seed, HEADLINE_LENS, 17, 16, 1024)
    cnt[4, 3] = 0
    tbl[2, 0] = 1029
    return (*_latent(seed, 8, H, R, RP, 16, 1024), tbl, cnt)


@pytest.mark.parametrize("plan", [None, (3, 6, 2), (17, 1, 1), (1, 17, 4),
                                  (5, 4, 1), (2, 9, 4)])
def test_mla_q8_splits_and_columns_change_no_value(plan):
    """At the headline (DeepSeek-V3 widths), each plan (the rule's, a
    split an entry, one block a row group, column blocks) holds the
    plain version to the limit."""
    ops_ = _mla_headline(13)
    want = KM.vwr_mla_paged_flash_decode_q8_ref(*ops_, scale=SCALE)
    qa, qr, ckv, kr, cs, rs, tbl, cnt = ops_
    got = KM.decode_split_emulation(qa, qr, ckv, kr, tbl, cnt, plan=plan,
                                    ckv_scale=cs, krope_scale=rs,
                                    scale=SCALE)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
    assert torch.all(got[2][0] == 0) and torch.all(got[0][0] == 0)


MLA_CASES = [
    # label, h, r, rope, page_size, n_pages, table, counts, plan
    ("count-0 and partial pages", 16, 128, 32, 16, 20,
     [[3, 7, 9, 1, 2], [4, 5, 6, 8, 10]],
     [[16, 0, 16, 3, 0], [16, 16, 9, 0, 16]], None),
    ("forced splits", 16, 128, 32, 16, 20,
     [[3, 7, 9, 1, 2], [4, 5, 6, 8, 10]],
     [[16, 0, 16, 3, 0], [16, 16, 9, 0, 16]], (3, 2, 1)),
    ("an inactive slot", 16, 128, 64, 16, 12, [[1, 2, 3], [4, 5, 6]],
     [[0, 0, 0], [16, 1, 0]], (2, 2, 1)),
    ("entries past the pool", 8, 128, 32, 8, 12, [[11, 50, -3, 2]],
     [[8, 8, 5, 8]], None),
    ("pages of 24, two column blocks", 16, 256, 32, 24, 10,
     [[1, 2, 3, 4], [5, 6, 7, 8]], [[24, 24, 5, 0], [24, 0, 24, 13]],
     (2, 2, 2)),
    ("H 20 (masked rows)", 20, 128, 64, 16, 10, [[1, 2, 3]] * 2,
     [[16, 16, 5], [7, 0, 0]], None),
]


@pytest.mark.parametrize(
    "label,h,r,rope,ps,n_pages,table,counts,plan", MLA_CASES,
    ids=[c[0] for c in MLA_CASES])
def test_mla_q8_arithmetic_matches_the_plain_version_and_jax(
        label, h, r, rope, ps, n_pages, table, counts, plan):
    B = len(table)
    qa, qr, ckv, kr, cs, rs = _latent(len(label) + r, B, h, r, rope, ps,
                                      n_pages)
    tbl = torch.tensor(table, dtype=torch.int32)
    cnt = torch.tensor(counts, dtype=torch.int32)
    got = KM.decode_split_emulation(qa, qr, ckv, kr, tbl, cnt, plan=plan,
                                    ckv_scale=cs, krope_scale=rs,
                                    scale=SCALE)
    want = KM.vwr_mla_paged_flash_decode_q8_ref(qa, qr, ckv, kr, cs, rs,
                                                tbl, cnt, scale=SCALE)
    jax_out = jops.vwr_mla_paged_flash_decode_q8(
        *(_np(t) for t in (qa, qr, ckv, kr, cs, rs, tbl, cnt)),
        scale=SCALE, interpret=True)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, _back(j, w.shape), **TOL)
    for b in range(B):
        if not any(counts[b]):
            assert torch.all(got[2][b] == 0) and torch.all(got[0][b] == 0)
            assert bool((got[1][b] == torch.tensor(KM.NEG_INF)).all())


def test_mla_q8_power_of_two_is_the_splits_own(monkeypatch):
    """Latent scales 2^12 apart between a slot's first and last split
    (plan (3, 6, 2) at the headline's table), slot 0 in its first split
    alone: P's power of two from the block's own split holds the limit;
    from slot 0's row (what the chunk instance's scan of the shared row
    reads), or from the first split of each slot's row, P's fp16 terms
    overflow in the last splits."""
    qa, qr, ckv, kr, cs, rs = _latent(24, 8, H, R, RP, 16, 1024)
    tbl, cnt = _long_table(24, (90, 1, 16, 17, 255, 100, 200, 64), 17, 16,
                           1024)
    cs, rs = _stepped((cs, rs), tbl, cnt, 12)
    want = KM.vwr_mla_paged_flash_decode_q8_ref(qa, qr, ckv, kr, cs, rs,
                                                tbl, cnt, scale=SCALE)

    def run():
        return KM.decode_split_emulation(
            qa, qr, ckv, kr, tbl, cnt, plan=(3, 6, 2), ckv_scale=cs,
            krope_scale=rs, scale=SCALE)
    for g, w in zip(run(), want):
        torch.testing.assert_close(g, w, **TOL)
    own = KM.split_p_up
    row0 = tbl[0].tolist(), cnt[0].tolist()
    for wrong in (lambda s, t, c, k0, k1: own(s, *row0, 0, len(row0[0])),
                  lambda s, t, c, k0, k1: own(s, t, c, 0, k1 - k0)):
        monkeypatch.setattr(KM, "split_p_up", wrong)
        assert not all(bool(torch.isfinite(x).all()) for x in run())


def test_mla_q8_one_p_term_misses_the_tolerance():
    """Why P is split into two fp16 terms: P (times its latent scale and
    power of two) rounded once leaves the 1e-4 limit."""
    qa, qr, ckv, kr, cs, rs = _latent(5, 2, H, R, RP, 16, 24)
    tbl = torch.tensor([[3, 7, 9, 1, 2], [4, 5, 6, 8, 10]],
                       dtype=torch.int32)
    cnt = torch.tensor([[16, 16, 16, 16, 9], [16, 16, 0, 16, 16]],
                       dtype=torch.int32)
    want = KM.vwr_mla_paged_flash_decode_q8_ref(qa, qr, ckv, kr, cs, rs,
                                                tbl, cnt, scale=SCALE)
    once = KM.decode_split_emulation(qa, qr, ckv, kr, tbl, cnt,
                                     ckv_scale=cs, krope_scale=rs, terms=1,
                                     scale=SCALE)
    assert _use(once, want) > 1


def test_variant_counts_stay_zero_on_the_cpu():
    """CPU tensors run the plain versions: no launch, no variant counted."""
    build.reset_launches()
    q, kp, vp, ks, vs = _pools(5, 1, 2, 4, 64, 16, 8)
    tbl = torch.tensor([[1, 2]], dtype=torch.int32)
    cnt = torch.tensor([[16, 3]], dtype=torch.int32)
    KD.vwr_paged_flash_decode_q8(q.bfloat16(), kp, vp, ks, vs, tbl, cnt)
    qa, qr, ckv, kr, cs, rs = _latent(5, 1, 16, 128, 32, 16, 8)
    KM.vwr_mla_paged_flash_decode_q8(qa, qr, ckv, kr, cs, rs, tbl, cnt,
                                     scale=SCALE)
    for name in ("vwr_paged_flash_decode_q8.mma",
                 "vwr_paged_flash_decode_q8.fma",
                 "vwr_mla_paged_flash_decode_q8.wgmma",
                 "vwr_mla_paged_flash_decode_q8.fma"):
        assert build.VARIANTS[name] == 0
    assert build.LAUNCHES["vwr_paged_flash_decode_q8"] == 0
    assert build.LAUNCHES["vwr_mla_paged_flash_decode_q8"] == 0
