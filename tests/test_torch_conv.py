"""The paper's CNN kernels (``vwr_conv2d``, ``vwr_depthwise``) against the
JAX ops they replace, the section 6.1 demo on the port's ``core``, and
the zero-padding / group slicing by which the attention kernels take
every head, rank and group width.

On the CPU each wrapper runs its plain version, held to the JAX op
(Pallas in interpret mode, as the JAX package's own tests run it) on the
same numpy inputs: fp32 to 1e-5 (only the order of the sums differs),
bf16 to 2e-2 (the JAX tests' tolerance: one rounding of the output).
The CUDA kernels need the card: the ``cuda``-marked cases skip here, and
``chip_smoke.py`` runs them there at the suite's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import vwr_attention as KA  # noqa: E402
from repro_torch.kernels import vwr_chunk as KC  # noqa: E402
from repro_torch.kernels import vwr_conv2d as K16  # noqa: E402
from repro_torch.kernels import vwr_decode as KD  # noqa: E402
from repro_torch.kernels import vwr_depthwise as K17  # noqa: E402
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402
from repro_torch.kernels import widths  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(atol=2e-2, rtol=2e-2))}


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _pair(a, dtype):
    """One numpy fp32 array as a JAX and a torch array of ``dtype`` (the
    same round-to-nearest-even cast on both sides)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


def _conv_inputs(seed, n, h, w, c, f, kh, kw, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((kh, kw, c, f)).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32) if bias else None
    return x, wt, b


# ------------------------------------------- the JAX tests' shapes

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,f,kh,kw,bh,bf", [
    (1, 9, 9, 8, 8, 3, 3, 2, 8),
    (2, 13, 11, 7, 5, 3, 3, 4, 4),
    (1, 8, 8, 4, 16, 1, 1, 4, 16),   # 1x1 conv
    (2, 12, 10, 3, 9, 5, 5, 4, 4),
])
def test_conv2d_matches_jax(dtype, n, h, w, c, f, kh, kw, bh, bf):
    """``tests/test_kernels.py::test_vwr_conv2d``'s shapes: ragged C (7,
    3) and F (5, 9), H_out off the JAX row block, a 1x1 and a 5x5 conv."""
    x, wt, _ = _conv_inputs(0, n, h, w, c, f, kh, kw, False)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(wt, dtype)
    want = jops.vwr_conv2d(jx, jw, bh=bh, bf=bf)
    got = ops.vwr_conv2d(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,k,bh", [
    (1, 10, 10, 8, 3, 4),
    (2, 12, 9, 16, 3, 2),
    (1, 9, 9, 4, 5, 5),
])
def test_depthwise_matches_jax(dtype, n, h, w, c, k, bh):
    """``tests/test_kernels.py::test_vwr_depthwise``'s shapes."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((k, k, c)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(wt, dtype)
    want = jops.vwr_depthwise(jx, jw, bh=bh)
    got = ops.vwr_depthwise(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,f,kh,act,bias", [
    (1, 9, 9, 8, 8, 3, "relu", True),
    (2, 13, 11, 7, 5, 3, "gelu", True),     # ragged
    (1, 8, 8, 4, 16, 1, None, True),        # bias only
    (2, 12, 10, 3, 9, 5, "relu", False),    # activation only
])
def test_conv2d_fused_epilogue_matches_jax(dtype, n, h, w, c, f, kh, act,
                                           bias):
    """``tests/test_kernels.py::test_vwr_conv2d_fused_epilogue``'s cases:
    the fused op against JAX's fused op and against the two-pass
    composition (conv, then bias and activation on the fp32 sum)."""
    x, wt, b = _conv_inputs(2, n, h, w, c, f, kh, kh, bias)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(wt, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    want = jops.vwr_conv2d(jx, jw, jb, activation=act, bh=4, bf=4)
    got = ops.vwr_conv2d(tx, tw, tb, activation=act)
    _close(got, want, dtype)
    two_pass = K16.vwr_conv2d_ref(tx, tw).float()
    if tb is not None:
        two_pass = two_pass + tb.float()
    if act is not None:
        two_pass = K16.ACTIVATIONS[act](two_pass)
    _close(got, two_pass.to(tx.dtype), dtype)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
def test_conv2d_each_activation_matches_jax(act, bias):
    """Every epilogue, with and without bias, at a ragged fp32 shape; the
    bias as (F,) and as (1, F)."""
    x, wt, b = _conv_inputs(3, 2, 11, 9, 5, 6, 3, 2, bias)
    want = jops.vwr_conv2d(*(None if a is None else jnp.asarray(a)
                             for a in (x, wt, b)), activation=act, bh=4,
                           bf=4)
    t = [None if a is None else torch.from_numpy(a) for a in (x, wt, b)]
    _close(ops.vwr_conv2d(*t, activation=act), want, "float32")
    if bias:
        _close(ops.vwr_conv2d(t[0], t[1], t[2][None], activation=act),
               want, "float32")


def test_conv_input_checks():
    x = torch.zeros(1, 6, 6, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.vwr_conv2d(x, torch.zeros(3, 3, 4, 2), activation="tanh")
    with pytest.raises(ValueError, match="needs w"):
        ops.vwr_conv2d(x, torch.zeros(3, 3, 5, 2))
    with pytest.raises(ValueError, match="needs w"):
        ops.vwr_conv2d(x, torch.zeros(7, 3, 4, 2))
    with pytest.raises(ValueError, match="needs w"):
        ops.vwr_depthwise(x, torch.zeros(3, 3, 5))
    m = torch.empty(1, 6, 6, 4, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K16.vwr_conv2d(m, torch.empty(3, 3, 4, 2, device="meta"))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K17.vwr_depthwise(m, torch.empty(3, 3, 4, device="meta"))


def test_cpu_conv_runs_the_plain_version_uncounted():
    build.reset_launches()
    x, wt, b = (torch.from_numpy(a) for a in
                _conv_inputs(4, 1, 7, 7, 3, 4, 3, 3, True))
    ops.vwr_conv2d(x, wt, b, activation="relu")
    ops.vwr_depthwise(x, wt[..., 0].contiguous())
    assert build.LAUNCHES["vwr_conv2d"] == build.LAUNCHES[
        "vwr_depthwise"] == 0


def test_demo_runs_on_cpu():
    """The port's section 6.1 demo: the ISA programs reproduce numpy, the
    fused conv equals the two-pass one, and its suite is the JAX core's."""
    from repro.core import analysis as janalysis
    from repro_torch.examples import provet_conv_demo

    res = provet_conv_demo.main(device="cpu")
    assert max(res["6.1_err"], res["6.2.1_err"], res["6.2.2_err"]) < 1e-4
    assert res["fused_err"] < 1e-5
    assert res["6.1_instr_mix"]["VFUX"] == 12 * 25
    want = {k: (v["Provet"].utilization, v["Provet"].cmr)
            for k, v in janalysis.run_suite().items()}
    assert res["suite"] == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            provet_conv_demo.main(device="cuda")


# ------------------------- every head, rank and group width (padding)

def test_native_width():
    assert widths.native_width(16, KD.HEAD_DIMS, "k") == 32
    assert widths.native_width(64, KD.HEAD_DIMS, "k") == 64
    assert widths.native_width(100, KD.HEAD_DIMS, "k") == 128
    assert widths.native_width(8, KM.ROPES, "k") == 32
    with pytest.raises(ValueError, match="past the widest"):
        widths.native_width(129, KD.HEAD_DIMS, "k")
    t = torch.ones(2, 64)
    assert widths.pad_last(t, 64) is t


def _q8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("kind", ["dense", "dense-q8", "paged", "paged-q8"])
@pytest.mark.parametrize("D,G", [(16, 32), (16, 4), (24, 40), (64, 17)])
def test_padded_decode_matches_unpadded(kind, D, G):
    """``widths.at_widths`` (the kernel wrappers' path on the card) run
    over the plain versions: D zero-padded to the kernels' next width
    with the scale of the true width, G past 16 in slices of 16 rows,
    the output sliced back, equals the unpadded plain version."""
    rng = np.random.default_rng(D + G)
    B, KV, T = 2, 2, 20
    q = torch.from_numpy(rng.standard_normal((B * KV, G, D)).astype(
        np.float32))
    calls = []
    if kind.startswith("dense"):
        if kind.endswith("q8"):
            k, v = _q8(rng, (B, T, KV, D)), _q8(rng, (B, T, KV, D))
            sc = [torch.rand(B * KV) * 0.02 + 1e-3 for _ in range(2)]
            ref = lambda q, k, v, scale=None: KD.vwr_flash_decode_q8_ref(  # noqa: E731
                q, k, v, *sc, 15, 2, scale=scale)
        else:
            k, v = (torch.randn(B, T, KV, D) for _ in range(2))
            ref = lambda q, k, v, scale=None: KD.vwr_flash_decode_ref(  # noqa: E731
                q, k, v, 15, 2, scale=scale)
    else:
        n_pages, ps = 6, 4
        table = torch.tensor([[5, 1, 9, 0], [2, 3, 0, 0]], dtype=torch.int32)
        counts = torch.tensor([[4, 4, 2, 0], [4, 1, 0, 0]],
                              dtype=torch.int32)
        if kind.endswith("q8"):
            k, v = (_q8(rng, (n_pages, ps, KV, D)) for _ in range(2))
            sc = [torch.rand(n_pages, KV) * 0.02 + 1e-3 for _ in range(2)]
            ref = lambda q, k, v, scale=None: KD.vwr_paged_flash_decode_q8_ref(  # noqa: E731,E501
                q, k, v, *sc, table, counts, scale=scale)
        else:
            k, v = (torch.randn(n_pages, ps, KV, D) for _ in range(2))
            ref = lambda q, k, v, scale=None: KD.vwr_paged_flash_decode_ref(  # noqa: E731,E501
                q, k, v, table, counts, scale=scale)

    def launch(q, k, v):
        assert q.shape[-1] in KD.HEAD_DIMS and q.shape[1] <= KD.MAX_GROUP
        assert q.is_contiguous()
        calls.append(q.shape[1])
        return ref(q, k, v, scale=D ** -0.5)

    got = widths.at_widths(launch, [((q, k, v), KD.HEAD_DIMS)], "t",
                           max_group=KD.MAX_GROUP)
    want = ref(q, k, v)
    assert calls == [min(KD.MAX_GROUP, G - g) for g in range(0, G, 16)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_padded_attention_and_chunk_match_unpadded():
    """The causal attention and chunk-prefix paths at D 16 (the reduced
    configs'), padded to 32 as on the card."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    got = widths.at_widths(lambda q, k, v: KA.vwr_attention_ref(
        q, k, v, scale=0.25), [((q, k, v), KA.HEAD_DIMS)], "t")
    torch.testing.assert_close(got, KA.vwr_attention_ref(q, k, v),
                               atol=1e-6, rtol=1e-5)
    qc = torch.randn(2, 12, 16)
    pools = [torch.randn(5, 4, 2, 16) for _ in range(2)]
    table = torch.tensor([3, 0, 4], dtype=torch.int32)
    counts = torch.tensor([4, 0, 3], dtype=torch.int32)
    got = widths.at_widths(
        lambda q, k, v: KC.vwr_chunk_prefix_attend_ref(
            q, k, v, table, counts, scale=0.25),
        [((qc, *pools), KC.HEAD_DIMS)], "t")
    for a, b in zip(got, KC.vwr_chunk_prefix_attend_ref(qc, *pools, table,
                                                        counts)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_padded_mla_matches_unpadded():
    """The MLA wrappers' padding at the reduced r 16, rope 8 (the same
    ``widths.at_widths`` as the attention kernels'): the queries and
    caches zero-padded to 32 / 32 and o_tilde sliced back equal the
    unpadded plain version."""
    g = torch.Generator().manual_seed(0)
    qa, qr = torch.randn(3, 4, 16, generator=g), torch.randn(3, 4, 8,
                                                             generator=g)
    ckv, kr = torch.randn(3, 20, 16, generator=g), torch.randn(
        3, 20, 8, generator=g)
    seen = []

    def launch(qa, ckv, qr, kr):
        seen.append((qa.shape[-1], ckv.shape[-1], qr.shape[-1],
                     kr.shape[-1]))
        return KM.vwr_mla_flash_decode_ref(qa, qr, ckv, kr, 13, scale=0.2)

    got = widths.at_widths(launch, [((qa, ckv), KM.RANKS),
                                    ((qr, kr), KM.ROPES)], "t")
    want = KM.vwr_mla_flash_decode_ref(qa, qr, ckv, kr, 13, scale=0.2)
    assert seen == [(32, 32, 32, 32)] and got[0].shape[-1] == 16
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_conv_kernels_match_plain(cuda, dtype):
    """Kernels 16 and 17 against their plain versions: ragged C and F,
    1x1, 5x5 and 7x7 taps, H_out and W_out off the tile, each epilogue
    with and without bias, C past a 64-channel block."""
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(
        atol=1e-2, rtol=1.6e-2)
    g = torch.Generator(device=cuda).manual_seed(16)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dt)

    for n, h, w, c, f, k, bias, act in (
            (2, 13, 11, 7, 5, 3, True, "gelu"), (1, 8, 8, 4, 16, 1, True, None),
            (2, 12, 10, 3, 9, 5, False, "relu"),
            (2, 15, 21, 24, 70, 3, True, "silu"),
            (1, 11, 18, 16, 24, 3, False, "silu"),
            (1, 20, 43, 3, 64, 7, True, "relu")):
        x, wt = r(n, h, w, c), r(k, k, c, f, scale=(k * k * c) ** -0.5)
        b = r(f) if bias else None
        got = K16.vwr_conv2d(x, wt, b, activation=act)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, K16.vwr_conv2d_ref(x, wt, b, activation=act), **tol)
    for n, h, w, c, k in ((1, 10, 10, 8, 3), (2, 12, 9, 16, 3),
                          (1, 9, 9, 4, 5), (2, 13, 21, 70, 3)):
        x, wt = r(n, h, w, c), r(k, k, c, scale=1.0 / k)
        got = K17.vwr_depthwise(x, wt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, K17.vwr_depthwise_ref(x, wt), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_padded_wrappers_match_plain(cuda, dtype):
    """The attention kernels at the reduced configs' widths: D 16 and a
    decode group of 32 rows (two launches), and every MLA kernel at r 16,
    rope 8, against their plain versions."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(17)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(dt)

    def close(got, want):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)

    q, k, v = r(2, 9, 4, 16), r(2, 9, 2, 16), r(2, 9, 2, 16)
    torch.testing.assert_close(
        KA.vwr_attention(q, k, v), KA.vwr_attention_ref(q, k, v),
        **(dict(atol=1e-4, rtol=1e-4) if dtype == "float32"
           else dict(atol=1e-2, rtol=1.6e-2)))
    build.reset_launches()
    qd, kc, vc = r(4, 32, 16), r(2, 20, 2, 16), r(2, 20, 2, 16)
    got = KD.vwr_flash_decode(qd, kc, vc, 15, 2)
    torch.cuda.synchronize()
    assert build.LAUNCHES["vwr_flash_decode"] == 2
    close(got, KD.vwr_flash_decode_ref(qd, kc, vc, 15, 2))
    pools = [r(6, 4, 2, 16) for _ in range(2)]
    table = torch.tensor([[5, 1, 0], [2, 3, 0]], dtype=torch.int32,
                         device=cuda)
    counts = torch.tensor([[4, 2, 0], [4, 1, 0]], dtype=torch.int32,
                          device=cuda)
    close(KD.vwr_paged_flash_decode(qd, *pools, table, counts),
          KD.vwr_paged_flash_decode_ref(qd, *pools, table, counts))
    qc = r(2, 12, 16)
    tbl = torch.tensor([3, 0, 5, 0], dtype=torch.int32, device=cuda)
    cnt = torch.tensor([4, 0, 3, 0], dtype=torch.int32, device=cuda)
    close(KC.vwr_chunk_prefix_attend(qc, *pools, tbl, cnt),
          KC.vwr_chunk_prefix_attend_ref(qc, *pools, tbl, cnt))
    qa = torch.randn(3, 4, 16, generator=g, device=cuda)
    qr = torch.randn(3, 4, 8, generator=g, device=cuda)
    ckv, kr = r(3, 20, 16), r(3, 20, 8)
    close(KM.vwr_mla_flash_decode(qa, qr, ckv, kr, 13, scale=0.2),
          KM.vwr_mla_flash_decode_ref(qa, qr, ckv, kr, 13, scale=0.2))
    lp = [r(6, 4, 16), r(6, 4, 8)]
    close(KM.vwr_mla_paged_flash_decode(qa, qr, *lp, table[:1].expand(
        3, 3).contiguous(), counts[:1].expand(3, 3).contiguous(), scale=0.2),
        KM.vwr_mla_paged_flash_decode_ref(
            qa, qr, *lp, table[:1].expand(3, 3), counts[:1].expand(3, 3),
            scale=0.2))
    close(KM.vwr_mla_chunk_prefix_attend(qa, qr, *lp, tbl, cnt, scale=0.2),
          KM.vwr_mla_chunk_prefix_attend_ref(qa, qr, *lp, tbl, cnt,
                                             scale=0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,f,k,bias,act,plan", [
    (1, 9, 9, 512, 512, 3, True, "relu", None),     # RN_7x7 N 1: K split
    (2, 9, 9, 96, 64, 3, True, "gelu", None),       # C 96: a ragged slice
    (3, 9, 9, 64, 128, 3, False, "silu", None),     # W_out 7: tiles cross images
    (3, 15, 15, 32, 64, 3, True, None, None),       # W_out 13
    (2, 8, 8, 64, 64, 1, True, "relu", None),       # 1x1
    (1, 12, 12, 32, 64, 5, False, None, None),      # 5x5
    (1, 9, 9, 512, 512, 3, True, "relu", (64, 64, 5, 15)),  # uneven split
])
def test_cuda_conv_wgmma_matches_plain(cuda, n, h, w, c, f, k, bias, act,
                                       plan):
    """Kernel 16's wgmma variant (bf16) against its plain version at the
    bf16 tolerance, counted as such, and bitwise equal over two
    launches."""
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).bfloat16()
    wt = (torch.randn(k, k, c, f, generator=g, device=cuda)
          * (k * k * c) ** -0.5).bfloat16()
    b = torch.randn(f, generator=g, device=cuda).bfloat16() if bias else None
    assert K16.variant(n, h, w, c, k, k, f, x.dtype, True) == "wgmma"
    build.reset_launches()
    if plan is None:
        got = K16.vwr_conv2d(x, wt, b, activation=act)
        again = K16.vwr_conv2d(x, wt, b, activation=act)
    else:
        got = K16.launch(x, wt, b, act, "wgmma", plan)
        again = K16.launch(x, wt, b, act, "wgmma", plan)
    torch.cuda.synchronize()
    assert build.VARIANTS["vwr_conv2d.wgmma"] == 2
    torch.testing.assert_close(
        got, K16.vwr_conv2d_ref(x, wt, b, activation=act), atol=1e-2,
        rtol=1.6e-2)
    assert torch.equal(got, again)
