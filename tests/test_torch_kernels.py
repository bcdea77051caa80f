"""The four ported kernels against the JAX ops they replace.

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

from repro.kernels import ops as jops  # noqa: E402
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
    q, k, v = r(2, 45, 8, 64), r(2, 45, 2, 64), r(2, 45, 2, 64)
    torch.testing.assert_close(KA.vwr_attention(q, k, v),
                               KA.vwr_attention_ref(q, k, v), **tol)
    qd = r(4, 4, 64)
    for got, want in zip(KD.vwr_flash_decode(qd, k, v, 40, 3),
                         KD.vwr_flash_decode_ref(qd, k, v, 40, 3)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
