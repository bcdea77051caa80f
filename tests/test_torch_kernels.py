"""The dense-path kernels (matmul, swiglu, attention, and the dense-cache
flash decode over a model-dtype or an int8 cache) against the JAX ops
they replace.

On the CPU each wrapper runs its plain version, which is held to the
JAX op (Pallas in interpret mode, the way the JAX package's own tests
run it) on the same numpy inputs in fp32: both sides accumulate in
fp32, so they agree to rounding (atol = rtol = 1e-5).  The CUDA kernels
themselves need the card: the ``cuda``-marked cases skip here, and
``chip_smoke.py`` runs them there at the main path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.dist import decode as jdd  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch.models.lm  # noqa: E402,F401  (registers the dispatch ops)
from repro_torch.dist import decode as tdd  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import vwr_attention as KA  # noqa: E402
from repro_torch.kernels import vwr_decode as KD  # noqa: E402
from repro_torch.kernels import vwr_matmul as KM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
@pytest.mark.parametrize("bias,residual", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_matmul_matches_jax(act, bias, residual):
    rng = np.random.default_rng(0)
    M, K, N = 33, 40, 24
    x, w = _randn(rng, M, K), _randn(rng, K, N, scale=K ** -0.5)
    b = _randn(rng, N) if bias else None
    r = _randn(rng, M, N) if residual else None
    want = jops.vwr_matmul(jnp.asarray(x), jnp.asarray(w),
                           None if b is None else jnp.asarray(b),
                           None if r is None else jnp.asarray(r),
                           activation=act)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = ops.vwr_matmul(t(x), t(w), t(b), t(r), activation=act)
    _close(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", [(16, 32, 48), (7, 20, 13)])
def test_swiglu_matches_jax(M, K, N):
    rng = np.random.default_rng(1)
    x = _randn(rng, M, K)
    wg, wi = (_randn(rng, K, N, scale=K ** -0.5) for _ in range(2))
    want = jops.vwr_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wi))
    got = ops.vwr_swiglu(*(torch.from_numpy(a) for a in (x, wg, wi)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("B,S,H,KV", [(2, 16, 8, 2), (1, 13, 4, 4),
                                      (2, 21, 4, 1)])
def test_attention_matches_jax(B, S, H, KV):
    """G = 4 (zero-copy GQA), G = 1 (MHA) and ragged S."""
    rng = np.random.default_rng(2)
    D = 16
    q = _randn(rng, B, S, H, D)
    k, v = _randn(rng, B, S, KV, D), _randn(rng, B, S, KV, D)
    want = jops.vwr_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    got = ops.vwr_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got.numpy(), want)


def test_attention_kernel_is_causal_only():
    z = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="causal-only"):
        ops.vwr_attention(z, z, z, causal=False)


@pytest.mark.parametrize("T,cur_len,pos0", [
    (24, 17, 0),      # cur_len < T
    (24, 30, 10),     # a slab starting at pos0 > 0
    (20, 5, 8),       # no valid position: l = 0, m = -1e30
])
def test_flash_decode_matches_jax(T, cur_len, pos0):
    rng = np.random.default_rng(3)
    B, H, KV, D = 2, 8, 2, 16
    q = _randn(rng, B, H, D)
    k, v = _randn(rng, B, T, KV, D), _randn(rng, B, T, KV, D)
    want = jops.vwr_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), cur_len, pos0=pos0)
    got = ops.vwr_flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                               cur_len, pos0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
    if cur_len <= pos0:
        assert torch.all(got[2] == 0) and torch.all(got[1] == KD.NEG_INF)


def _q8_cache(rng, B, T, KV, D):
    kv = [rng.integers(-127, 128, (B, T, KV, D)).astype(np.int8)
          for _ in range(2)]
    scales = [rng.uniform(1e-3, 2e-2, (B, KV)).astype(np.float32)
              for _ in range(2)]
    return kv, scales


@pytest.mark.parametrize("T,cur_len,pos0", [
    (24, 17, 0),      # cur_len < T
    (21, 30, 10),     # a slab at pos0 > 0, T not a multiple of a block
    (20, 5, 8),       # no valid position: l = 0, m = -1e30
])
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_decode_partial_q8_ops_match_jax(T, cur_len, pos0, jimpl, timpl):
    """The ``decode_partial_q8`` op (kernel 9's, on the CPU its plain
    version: dequantize, then attend) against JAX's 'xla' op and its
    'pallas' op in interpret mode, over an int8 cache with one scale a
    (batch, KV head) row."""
    rng = np.random.default_rng(T + cur_len)
    B, H, KV, Dh = 2, 8, 2, 16
    q = _randn(rng, B, H, Dh)
    (k, v), (ks, vs) = _q8_cache(rng, B, T, KV, Dh)
    want = JD.dispatch("decode_partial_q8", jimpl, *(jnp.asarray(a) for a in
                                                     (q, k, v, ks, vs)),
                       cur_len, pos0)
    got = D.dispatch("decode_partial_q8", timpl,
                     *(torch.from_numpy(a) for a in (q, k, v, ks, vs)),
                     cur_len, pos0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
    if cur_len <= pos0:
        assert torch.all(got[2] == 0) and torch.all(got[1] == KD.NEG_INF)


@pytest.mark.parametrize("q8", [False, True], ids=["cache", "int8"])
def test_local_decode_attend_matches_jax(q8):
    """``dist.decode.local_decode_attend``: scales select the q8 op (kernel
    9 on the 'cuda' backend), held against JAX's function with the same
    scales through its 'pallas' backend."""
    rng = np.random.default_rng(11)
    B, H, KV, Dh, T = 2, 8, 2, 16, 24
    q = _randn(rng, B, H, Dh)
    if q8:
        (k, v), scales = _q8_cache(rng, B, T, KV, Dh)
    else:
        k, v, scales = _randn(rng, B, T, KV, Dh), _randn(rng, B, T, KV, Dh), []
    names = ("k_scale", "v_scale")
    want = jdd.local_decode_attend(
        *(jnp.asarray(a) for a in (q, k, v)), 19, backend="pallas",
        **{n: jnp.asarray(s) for n, s in zip(names, scales)})
    got = tdd.local_decode_attend(
        *(torch.from_numpy(a) for a in (q, k, v)), 19, backend="cuda",
        **{n: torch.from_numpy(s) for n, s in zip(names, scales)})
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_cpu_tensors_run_the_plain_version_uncounted():
    build.reset_launches()
    x = torch.randn(4, 8)
    torch.testing.assert_close(KM.vwr_matmul(x, torch.eye(8)), x)
    assert all(n == 0 for n in build.LAUNCHES.values())


def test_non_cuda_device_raises():
    """Only CPU tensors take the plain version: anything else must reach
    the kernel, and a non-CUDA device is refused, not run plainly."""
    m = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        KM.vwr_matmul(m, torch.empty(8, 8, device="meta"))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        KM.vwr_swiglu(m, torch.empty(8, 8, device="meta"),
                      torch.empty(8, 8, device="meta"))


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(
        atol=1e-2, rtol=1.6e-2)
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(dt)

    x, w, b, res = r(70, 96), r(96, 40) * 0.1, r(1, 40), r(70, 40)
    torch.testing.assert_close(
        KM.vwr_matmul(x, w, b, res, activation="gelu"),
        KM.vwr_matmul_ref(x, w, b, res, activation="gelu"), **tol)
    torch.testing.assert_close(KM.vwr_swiglu(x, w, w),
                               KM.vwr_swiglu_ref(x, w, w), **tol)
    if dtype == "bfloat16":
        # swiglu's wgmma tiles at M 2, M 4 (a decode step) and M 72,
        # against the plain version and the emulation of their layout
        # with the same plan (K split at M 2 and 4)
        for M in (2, 4, 72):
            xs, wg, wi = r(M, 512), r(512, 136) * 0.05, r(512, 136) * 0.05
            before = build.VARIANTS["vwr_swiglu.wgmma"]
            got = KM.vwr_swiglu(xs, wg, wi)
            assert build.VARIANTS["vwr_swiglu.wgmma"] == before + 1
            torch.testing.assert_close(got, KM.vwr_swiglu_ref(xs, wg, wi),
                                       **tol)
            torch.testing.assert_close(
                got, KM.swiglu_split_emulation(xs, wg, wi), **tol)
    q, k, v = r(2, 45, 8, 64), r(2, 45, 2, 64), r(2, 45, 2, 64)
    torch.testing.assert_close(KA.vwr_attention(q, k, v),
                               KA.vwr_attention_ref(q, k, v), **tol)
    qd = r(4, 4, 64)
    for got, want in zip(KD.vwr_flash_decode(qd, k, v, 40, 3),
                         KD.vwr_flash_decode_ref(qd, k, v, 40, 3)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_q8_matches_plain(cuda, dtype):
    """Kernel 9 against its plain version: T not a multiple of the tile,
    a slab at pos0 > 0, a row with no valid key, G 1 and 16, D 32 to
    128, bf16 and fp32 queries."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    for B, T, KV, G, D, cur, pos0 in ((4, 160, 4, 8, 64, 144, 0),
                                      (2, 77, 2, 4, 64, 50, 5),
                                      (3, 33, 2, 1, 32, 20, 0),
                                      (1, 65, 1, 16, 128, 65, 0),
                                      (2, 40, 2, 4, 64, 3, 10)):
        q = torch.randn(B * KV, G, D, generator=g, device=cuda).to(dt)
        kv = [torch.randint(-127, 128, (B, T, KV, D), generator=g,
                            device=cuda, dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand(B * KV, generator=g, device=cuda) * 0.02 + 1e-3
              for _ in range(2)]
        args = (q, *kv, *sc, cur, pos0)
        got = KD.vwr_flash_decode_q8(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, KD.vwr_flash_decode_q8_ref(*args)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pools", "int8-pools"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_chunk_prefix_kernels_match_plain(cuda, dtype, q8):
    """Kernels 6 and 8 against their plain versions: full pages, a
    partial tail, masked pages in the middle and a table entry past the
    pool (clamped), at C 8 and C 1."""
    from repro_torch.kernels import vwr_chunk as KC
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    n_pages, ps, KV, G, D = 12, 16, 2, 4, 64
    shape = (n_pages, ps, KV, D)
    if q8:
        pools = [torch.randint(-127, 128, shape, generator=g, device=cuda,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((n_pages, KV), generator=g, device=cuda) * 0.02
                  + 1e-3 for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=g, device=cuda).to(dt)
                 for _ in range(2)]
        scales = []
    table = torch.tensor([3, 11, 0, 7, 40], dtype=torch.int32, device=cuda)
    counts = torch.tensor([ps, 0, ps, 0, 5], dtype=torch.int32, device=cuda)
    fn = KC.vwr_chunk_prefix_attend_q8 if q8 else KC.vwr_chunk_prefix_attend
    ref = (KC.vwr_chunk_prefix_attend_q8_ref if q8
           else KC.vwr_chunk_prefix_attend_ref)
    for C in (8, 1):
        q = torch.randn(KV, C * G, D, generator=g, device=cuda).to(dt)
        args = (q, *pools, *scales, table, counts)
        got = fn(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref(*args)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
@pytest.mark.parametrize("kind,M,K,N", [
    ("splitk", 4, 5632, 2048),    # tinyllama decode down
    ("splitk", 1, 72, 24),        # M 1, one 128-column strip past N
    ("splitk", 3, 1000, 136),     # K not a multiple of a slice
    ("wgmma", 512, 2048, 256),    # 64-row tiles (k/v): 16 blocks
    ("wgmma", 72, 5632, 2048),    # a mixed step: K split 4 ways
    ("wgmma", 100, 200, 136),     # ragged M, N and K tail
    ("wgmma", 8, 5632, 2048),     # past the crossover: one 128-row tile
])
def test_cuda_matmul_variants_match_plain(cuda, kind, M, K, N, act):
    """Each bf16 variant of kernel 1, forced, with bias and residual,
    against the plain version; two launches are bitwise equal (the
    split reduction sums in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).bfloat16()

    x, w, b, res = r(M, K), r(K, N, scale=K ** -0.5), r(1, N), r(M, N)
    assert KM.variant(M, N, K, torch.bfloat16, True) == kind
    got = KM.vwr_matmul(x, w, b, res, activation=act)
    again = KM.vwr_matmul(x, w, b, res, activation=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, KM.vwr_matmul_ref(x, w, b, res, activation=act),
        atol=1e-2, rtol=1.6e-2)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 8, 16])
def test_cuda_attention_wgmma_matches_plain(cuda, G, D):
    """Kernel 3's bf16 path (the G heads of a KV head packed into the
    rows of one wgmma tile, P rounded to bf16) against the plain version
    at S off the tile, S 1, and two KV heads."""
    g = torch.Generator(device=cuda).manual_seed(G * D)
    for B, S in ((2, 100), (1, 1), (1, 130)):
        q = torch.randn(B, S, 2 * G, D, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(B, S, 2, D, generator=g, device=cuda).bfloat16()
                for _ in range(2))
        got = KA.vwr_attention(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, KA.vwr_attention_ref(q, k, v),
                                   atol=1e-2, rtol=1.6e-2)
        assert torch.equal(got, KA.vwr_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("C,ps,counts", [
    (3, 16, (16, 0, 16, 7)),        # a count-0 and a partial page
    (1, 16, (16, 16, 5)),
    (8, 64, (64, 50, 0, 64)),       # pages of 64: sub-tiled by 32 rows
    (4, 8, (8, 3, 0, 8, 8)),        # pages of 8: four to a tile
    (2, 16, (0, 0)),                # no valid key
])
def test_cuda_mla_chunk_wgmma_matches_plain(cuda, C, ps, counts):
    """Kernel 12's wgmma variant on bf16 pools at DeepSeek-V3's widths
    (H 128, r 512, rope 64) against its plain version at the kernel's
    fp32 tolerance; a table entry past the pool (clamped); the variant
    counted; bitwise equal over two launches."""
    from repro_torch.kernels import vwr_mla_decode as KML
    g = torch.Generator(device=cuda).manual_seed(12)
    n_pages, H, r, rope = 16, 128, 512, 64
    qa = torch.randn(C, H, r, generator=g, device=cuda)
    qr = torch.randn(C, H, rope, generator=g, device=cuda)
    pools = [torch.randn(n_pages, ps, w, generator=g, device=cuda).bfloat16()
             for w in (r, rope)]
    table = torch.randperm(n_pages, generator=g, device=cuda)[:len(counts)]
    table = table.to(torch.int32)
    table[-1] = n_pages + 3
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    args = (qa, qr, *pools, table, cnt)
    build.reset_launches()
    got = KML.vwr_mla_chunk_prefix_attend(*args, scale=0.07)
    again = KML.vwr_mla_chunk_prefix_attend(*args, scale=0.07)
    torch.cuda.synchronize()
    assert build.VARIANTS["vwr_mla_chunk_prefix_attend.wgmma"] == 2
    for a, b, c in zip(got, KML.vwr_mla_chunk_prefix_attend_ref(
            *args, scale=0.07), again):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,KV,G,D,cur,pos0,plan", [
    (4, 160, 4, 8, 64, 144, 0, None),       # tinyllama's step: one split
    (4, 160, 4, 8, 64, 144, 0, (9, 16)),    # nine splits of a slice
    (2, 160, 2, 8, 64, 17, 0, (2, 16)),     # one key past a split
    (2, 160, 2, 8, 64, 65, 0, None),        # one key past a tile
    (2, 300, 2, 8, 64, 300, 0, (3, 112)),   # splits of partial tiles
    (1, 40, 2, 4, 64, 1, 0, None),          # one key
    (2, 40, 2, 4, 64, 3, 10, None),         # no key
    (2, 77, 2, 4, 64, 50, 5, None),         # a slab at pos0 > 0
    (1, 200, 1, 16, 128, 200, 0, (2, 112)), # D 128, G 16
    (3, 33, 2, 3, 32, 20, 0, None),         # D 32, G 3
    (4, 2048, 4, 8, 64, 2048, 0, None),     # a long cache: 8 splits
])
def test_cuda_flash_decode_split_matches_plain(cuda, B, T, KV, G, D, cur,
                                               pos0, plan):
    """Kernel 4's split variant on bf16 caches at split and tile edges
    against the plain version and its emulation at 1e-4; the variant
    counted; bitwise equal over two launches."""
    g = torch.Generator(device=cuda).manual_seed(B * T + cur)
    q = torch.randn(B * KV, G, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, T, KV, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    n = max(0, min(T, cur - pos0))
    build.reset_launches()
    if plan is None:
        got = KD.vwr_flash_decode(q, k, v, cur, pos0)
        again = KD.vwr_flash_decode(q, k, v, cur, pos0)
    else:
        got = KD.decode_launch(q, k, v, n, "split", plan)
        again = KD.decode_launch(q, k, v, n, "split", plan)
    torch.cuda.synchronize()
    assert build.VARIANTS["vwr_flash_decode.split"] == 2
    for a, b, c, d in zip(got, KD.vwr_flash_decode_ref(q, k, v, cur, pos0),
                          KD.decode_split_emulation(q, k, v, cur, pos0,
                                                    plan=plan), again):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)
        assert torch.equal(a, d)


@pytest.mark.cuda
@pytest.mark.parametrize("KV,G,D,C,ps,counts,plan", [
    (4, 8, 64, 64, 16, (16,) * 16, None),     # tinyllama's chunk: 4 splits
    (4, 8, 64, 64, 16, (16, 9, 16, 16, 0, 16, 3), (2, 4)),  # partial mid
    (4, 8, 64, 1, 16, (16, 16, 5), None),     # C 1
    (2, 4, 64, 8, 16, (0, 0, 0), None),       # a first chunk: no key
    (2, 4, 64, 8, 16, (), None),              # J 0
    (2, 3, 64, 5, 8, (8, 8, 0, 1), None),     # pages of 8
    (2, 4, 64, 8, 64, (64, 50, 0, 64), None), # pages of 64
    (2, 4, 32, 8, 16, (16, 9), None),         # D 32
    (2, 4, 128, 8, 16, (16, 9), None),        # D 128
    (16, 1, 64, 64, 16, (16,) * 16, None),    # G 1
])
def test_cuda_chunk_prefix_wgmma_matches_plain(cuda, KV, G, D, C, ps, counts,
                                               plan):
    """Kernel 6's wgmma variant on bf16 pools against the plain version
    and its emulation at 1e-4; a table entry past the pool (clamped); the
    variant counted; bitwise equal over two launches."""
    from repro_torch.kernels import vwr_chunk as KC
    g = torch.Generator(device=cuda).manual_seed(C * ps + len(counts))
    n_pages = 24
    q = torch.randn(KV, C * G, D, generator=g, device=cuda).bfloat16()
    pools = [torch.randn(n_pages, ps, KV, D, generator=g,
                         device=cuda).bfloat16() for _ in range(2)]
    table = torch.randperm(n_pages, generator=g, device=cuda)[:len(counts)]
    table = table.to(torch.int32)
    if len(counts):
        table[-1] = n_pages + 3
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    args = (q, *pools, table, cnt)
    build.reset_launches()
    if plan is None:
        got, again = (KC.vwr_chunk_prefix_attend(*args) for _ in range(2))
    else:
        got, again = (KC.chunk_launch(*args, "wgmma", plan)
                      for _ in range(2))
    torch.cuda.synchronize()
    assert build.VARIANTS["vwr_chunk_prefix_attend.wgmma"] == 2
    for a, b, c, d in zip(got, KC.vwr_chunk_prefix_attend_ref(*args),
                          KC.chunk_wgmma_emulation(*args, plan=plan), again):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)
        assert torch.equal(a, d)
