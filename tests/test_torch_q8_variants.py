"""Kernels 9 (``vwr_flash_decode_q8``) and 8 (``vwr_chunk_prefix_attend_q8``)
on their Hopper variants: the rules that pick them (kernel 4's split
variant and kernel 6's wgmma variant, over int8 caches and pools), and
their arithmetic held against the plain versions and the JAX ops at 1e-4.
The int8 values are exact in 16 bits, and the scales are applied in fp32
around the products: kernel 9 multiplies each score by scale * k_scale,
takes P as two fp16 terms against the fp16 values and each split's
o_tilde times v_scale; kernel 8 multiplies each score column by scale
times its page's k scale and P by its page's v scale before its two bf16
terms.  ``decode_split_emulation`` and ``chunk_wgmma_emulation`` (with
``scales``) are that arithmetic in plain PyTorch; the kernels themselves
run only on the card (``chip_smoke.py``, against the plain versions and
the emulations).
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
from repro_torch.kernels import vwr_decode as KD  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _use(got, want):
    """The largest share of the 1e-4 limit an output element uses."""
    return max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item()
               for g, w in zip(got, want))


# ---- the rules: the same as kernels 4 and 6, on int8 caches and pools ----

@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 8, 16, 17])
def test_decode_rule(dtype, D, G):
    """bf16 queries at D 32 / 64 / 128 and G <= 16 take the split
    variant; fp32 queries, the widths the wrapper pads first (D 16) and
    the groups it slices first (G 17) the FMA kernel."""
    split = dtype == BF16 and D in (32, 64, 128) and G <= 16
    assert KD.decode_variant(dtype, D, G) == ("split" if split else "fma")


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("ps", [4, 8, 16, 24])
@pytest.mark.parametrize("CG", [8, 512])
def test_chunk_rule(dtype, D, ps, CG):
    """bf16 queries at D 32 / 64 / 128 over pages of a multiple of 8 rows
    take the wgmma variant; fp32, D 16 and pages of 4 the FMA kernel."""
    wgmma = dtype == BF16 and D in (32, 64, 128) and ps % 8 == 0
    assert KC.chunk_variant(CG, D, ps, dtype) == ("wgmma" if wgmma
                                                  else "fma")


# ---- kernel 9: the split variant over an int8 cache ----

def _cache(seed, B, T, KV, G, D):
    """bf16-representable fp32 queries, an int8 cache and (B*KV,) scales."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B * KV, G, D)).astype(
        np.float32)).bfloat16().float()
    k, v = (torch.from_numpy(rng.integers(-127, 128, (B, T, KV, D))
                             .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random(B * KV) * 0.02 + 1e-3)
                               .astype(np.float32)) for _ in range(2))
    return q, k, v, ks, vs


DECODE_CASES = [
    # B, T, KV, G, D, cur_len, pos0, plan (None: decode_plan's)
    (2, 160, 2, 8, 64, 144, 0, None),        # tinyllama's group: one split
    (2, 160, 2, 8, 64, 144, 0, (9, 16)),     # nine splits of a slice
    (2, 160, 2, 8, 64, 17, 0, (2, 16)),      # one key past a split
    (2, 160, 2, 8, 64, 65, 0, None),         # one key past a tile
    (2, 300, 2, 8, 64, 290, 7, (2, 144)),    # pos0 > 0, two splits
    (1, 40, 2, 4, 64, 1, 0, None),           # one key
    (2, 40, 2, 4, 64, 3, 10, None),          # no key: m -1e30, l 0, o 0
    (2, 77, 2, 4, 64, 50, 5, None),          # a slab at pos0 > 0
    (1, 200, 1, 16, 128, 200, 0, (2, 112)),  # D 128, G 16, a partial tile
    (3, 33, 2, 3, 32, 20, 0, (2, 16)),       # D 32, G 3, forced splits
    (2, 48, 4, 1, 64, 48, 0, None),          # G 1
]


@pytest.mark.parametrize("B,T,KV,G,D,cur,pos0,plan", DECODE_CASES)
def test_decode_q8_arithmetic_matches_the_plain_version_and_jax(
        B, T, KV, G, D, cur, pos0, plan):
    q, k, v, ks, vs = _cache(B * T + cur + D, B, T, KV, G, D)
    got = KD.decode_split_emulation(q, k, v, cur, pos0, plan=plan,
                                    scales=(ks, vs))
    want = KD.vwr_flash_decode_q8_ref(q, k, v, ks, vs, cur, pos0)
    jq = jnp.asarray(q.reshape(B, KV * G, D).numpy())
    jax_out = jops.vwr_flash_decode_q8(
        jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(ks.reshape(B, KV).numpy()),
        jnp.asarray(vs.reshape(B, KV).numpy()), cur, pos0, interpret=True)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(j)).reshape(w.shape), **TOL)
    if cur <= pos0:
        assert torch.all(got[2] == 0) and torch.all(got[0] == 0)
        assert bool((got[1] == torch.tensor(KD.NEG_INF)).all())


def test_decode_q8_one_p_term_misses_the_tolerance():
    """Why P is split into two terms: P rounded once (to fp16, or to bf16
    as in kernel 4's test) leaves the 1e-4 limit."""
    q, k, v, ks, vs = _cache(3, 2, 160, 2, 8, 64)
    want = KD.vwr_flash_decode_q8_ref(q, k, v, ks, vs, 144)
    for p_terms in (KD.f16_terms, KD.bf16_terms):
        once = KD.decode_split_emulation(q, k, v, 144, scales=(ks, vs),
                                         terms=1, p_terms=p_terms)
        assert _use(once, want) > 1


def test_decode_q8_takes_fp16_p_terms_at_a_long_cache():
    """Why kernel 9's P terms are fp16: at B1 T2048 (8 splits of 256 int8
    keys) two bf16 terms use more than half of the limit, two fp16 terms
    a fifth of it."""
    q, k, v, ks, vs = _cache(11, 1, 2048, 4, 8, 64)
    want = KD.vwr_flash_decode_q8_ref(q, k, v, ks, vs, 2048)
    f16 = KD.decode_split_emulation(q, k, v, 2048, scales=(ks, vs))
    bf = KD.decode_split_emulation(q, k, v, 2048, scales=(ks, vs),
                                   p_terms=KD.bf16_terms)
    assert _use(f16, want) < 0.2 < 0.5 < _use(bf, want)


# ---- kernel 8: the wgmma variant over int8 pools ----

def _pools(seed, KV, G, D, C, counts, ps=16, n_pages=12):
    """bf16-representable fp32 queries, int8 pools and (n_pages, KV)
    scales; a permuted table whose last entry lies past the pool."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((KV, C * G, D)).astype(
        np.float32)).bfloat16().float()
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, KV, D))
                               .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((n_pages, KV)) * 0.02 + 1e-3)
                               .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.permutation(n_pages)[:len(counts)]
                             .astype(np.int32))
    if len(counts):
        table[-1] = n_pages + 5          # past the pool: clamped
    return q, kp, vp, ks, vs, table, torch.tensor(counts, dtype=torch.int32)


def _jax_partials(q, kp, vp, ks, vs, table, counts, G):
    """The JAX op (Pallas in interpret mode) on the port's operands: q
    (KV, C*G, D) kv-major <-> (C, H, D)."""
    KV, CG, D = q.shape
    C = CG // G
    jq = q.reshape(KV, C, G, D).permute(1, 0, 2, 3).reshape(C, KV * G, D)
    o, m, l = jops.vwr_chunk_prefix_attend_q8(
        *(jnp.asarray(t.numpy()) for t in (jq, kp, vp, ks, vs, table,
                                           counts)), interpret=True)
    back = lambda x, *rest: (torch.from_numpy(np.array(x))  # noqa: E731
                             .reshape(C, KV, G, *rest).transpose(0, 1)
                             .reshape(KV, CG, *rest))
    return back(o, D), back(m), back(l)


CHUNK_CASES = [
    # KV, G, D, C, counts, ps, plan (None: chunk_plan's)
    (2, 4, 64, 8, (16, 9, 16), 16, None),        # a partial page mid-table
    (2, 4, 64, 8, (16, 0, 0, 16, 3), 16, None),  # count-0 pages mid-table
    (2, 4, 64, 8, (8, 0, 1), 16, None),          # count 0 and 1
    (2, 4, 64, 8, (16,) * 9 + (3,), 16, (3, 4)),  # three splits
    (2, 4, 64, 8, (16, 9, 16, 16, 0, 16, 3, 16), 16, (2, 4)),  # forced
    (2, 4, 64, 8, (0, 0, 0), 16, None),          # a first chunk: no key
    (2, 4, 64, 1, (16, 16, 5), 16, None),        # C 1
    (1, 8, 64, 20, (16, 16, 9), 16, None),       # 160 rows: 3 row blocks
    (2, 3, 64, 5, (8, 8, 0, 1), 8, None),        # pages of 8
    (2, 4, 64, 8, (24, 24, 5, 24, 0, 24), 24, None),  # pages of 24
    (2, 4, 64, 8, (64, 50, 0, 64), 64, None),    # pages of 64
    (2, 4, 32, 8, (16, 9), 16, None),            # D 32
    (2, 4, 128, 8, (16, 9), 16, None),           # D 128
    (4, 1, 64, 16, (16,) * 6, 16, None),         # G 1
]


@pytest.mark.parametrize("KV,G,D,C,counts,ps,plan", CHUNK_CASES)
def test_chunk_q8_arithmetic_matches_the_plain_version_and_jax(
        KV, G, D, C, counts, ps, plan):
    args = _pools(len(counts) + C + D + ps, KV, G, D, C, counts, ps)
    q, kp, vp, ks, vs, table, cnt = args
    got = KC.chunk_wgmma_emulation(q, kp, vp, table, cnt, plan=plan,
                                   scales=(ks, vs))
    want = KC.vwr_chunk_prefix_attend_q8_ref(*args)
    jax_out = _jax_partials(*args, G)
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, j, **TOL)
    if not any(counts):
        assert torch.all(got[2] == 0) and torch.all(got[0] == 0)
        assert bool((got[1] == torch.tensor(KC.NEG_INF)).all())


def test_chunk_q8_entry_past_the_pool_reads_the_last_page():
    q, kp, vp, ks, vs, table, cnt = _pools(2, 2, 4, 64, 4, (16, 7))
    clamped = table.clamp(0, kp.shape[0] - 1)
    for g, w in zip(
            KC.chunk_wgmma_emulation(q, kp, vp, table, cnt,
                                     scales=(ks, vs)),
            KC.chunk_wgmma_emulation(q, kp, vp, clamped, cnt,
                                     scales=(ks, vs))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_chunk_q8_one_bf16_term_misses_the_tolerance():
    """Why P is split into two bf16 terms: P (times its page's v scale)
    rounded once to bf16 leaves the 1e-4 limit; two terms use under half
    of it (the kernel's bf16 design)."""
    q, kp, vp, ks, vs, table, cnt = _pools(9, 2, 4, 64, 8, (16,) * 4)
    want = KC.vwr_chunk_prefix_attend_q8_ref(q, kp, vp, ks, vs, table, cnt)
    once = KC.chunk_wgmma_emulation(q, kp, vp, table, cnt, terms=1,
                                    scales=(ks, vs))
    twice = KC.chunk_wgmma_emulation(q, kp, vp, table, cnt, scales=(ks, vs))
    assert _use(twice, want) < 0.5 < 1 < _use(once, want)


def test_variant_counts_stay_zero_on_the_cpu():
    """CPU tensors run the plain versions: no launch, no variant counted."""
    build.reset_launches()
    q, k, v, ks, vs = _cache(5, 1, 40, 2, 4, 64)
    KD.vwr_flash_decode_q8(q.bfloat16(), k, v, ks, vs, 30)
    args = _pools(5, 2, 4, 64, 8, (16, 9))
    KC.vwr_chunk_prefix_attend_q8(args[0].bfloat16(), *args[1:])
    for name in ("vwr_flash_decode_q8.split", "vwr_flash_decode_q8.fma",
                 "vwr_chunk_prefix_attend_q8.wgmma",
                 "vwr_chunk_prefix_attend_q8.fma"):
        assert build.VARIANTS[name] == 0
    assert build.LAUNCHES["vwr_flash_decode_q8"] == 0
    assert build.LAUNCHES["vwr_chunk_prefix_attend_q8"] == 0
