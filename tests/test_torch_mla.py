"""The port's MLA (``models/mla.py``), its four decode kernels and its
two chunk-prefix kernels (``kernels/vwr_mla_decode.py``, plain versions
on the CPU) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides in fp32.
Tolerance 1e-5 (atol and rtol): both sides compute in fp32 and differ
only in summation order.  The four ``decode_partial_mla*`` ops are held
to the JAX 'xla' ops and to the JAX 'pallas' ops (interpret mode, as
the JAX package's own tests run them) over ragged pages, a count-0
page, a slot with no valid key, a table entry past the pool, a slab at
pos0 > 0 and int8 caches with their scales, and split against the
concatenated ``mla_concat_view`` through the plain GQA decode ops; the
two ``chunk_prefix_mla_paged*`` ops the same way over a chunk's (J,)
table, and ``mla_attention_suffix`` against JAX's.  The kernels
themselves need the card: the ``cuda``-marked cases skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.dist import decode as jdd  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import module as M  # noqa: E402
from repro_torch.dist import decode as tdd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402
from repro_torch.models import mla  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, R, ROPE = 2, 4, 32, 16
SCALE = 0.17


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _close_partials(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_config("deepseek-v3-671b")),
            tconfigs.reduced(tconfigs.get_config("deepseek-v3-671b")))


@pytest.fixture(scope="module")
def attn_params():
    """One MLA block's parameters of reduced deepseek-v3 from the JAX
    init, on both sides."""
    jc, _ = _cfgs()
    from repro.common import module as JM
    jp = JM.init_params(jmla.mla_spec(jc), jax.random.PRNGKey(3))
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------- model ops

def test_mla_spec_matches_jax():
    jc, tc = _cfgs()
    from repro.common import module as JM
    want = {p: tuple(a.shape) for p, a in
            M.leaves(JM.abstract_params(jmla.mla_spec(jc)))}
    got = {p: d.shape for p, d in M.leaves(mla.mla_spec(tc))}
    assert got == want


@pytest.mark.parametrize("positions", ["arange", "offset"])
def test_latent_queries_and_attention_match_jax(attn_params, positions):
    """mla_latent, mla_queries (rope over rope_head_dim = 8 features,
    not d_head = 16) and the expanded-form prefill attention, blockwise
    and dense."""
    jc, tc = _cfgs()
    jp, tp = attn_params
    rng = np.random.default_rng(0)
    S = 20
    x = _randn(rng, 2, S, tc.d_model)
    pos = np.arange(S) + (0 if positions == "arange" else 7)
    jx, tx = jnp.asarray(x), _t(x)
    jpos, tpos = jnp.asarray(pos), _t(pos)
    for g, w in zip(mla.mla_latent(tp, tx, tpos, tc),
                    jmla.mla_latent(jp, jx, jpos, jc)):
        _close(g.numpy(), w)
    for g, w in zip(mla.mla_queries(tp, tx, tpos, tc),
                    jmla.mla_queries(jp, jx, jpos, jc)):
        _close(g.numpy(), w)
    for dense in (False, True):
        got, (ckv, kr) = mla.mla_attention(tp, tx, tpos, tc, dense=dense)
        want, (jckv, jkr) = jmla.mla_attention(jp, jx, jpos, jc,
                                               dense=dense)
        _close(got.numpy(), want)
        _close(ckv.numpy(), jckv)
        _close(kr.numpy(), jkr)


def test_attention_suffix_matches_jax(attn_params):
    """``mla_attention_suffix``: 7 suffix tokens at positions [12, 19) over
    12 prefix latents, blockwise and dense (``accounting``)."""
    jc, tc = _cfgs()
    jp, tp = attn_params
    rng = np.random.default_rng(2)
    M, S = 12, 7
    x = _randn(rng, 1, S, tc.d_model)
    pckv = _randn(rng, 1, M, tc.mla.kv_lora_rank)
    pkr = _randn(rng, 1, M, tc.mla.rope_head_dim)
    q_pos, kv_pos = np.arange(M, M + S), np.arange(M + S)
    for acc in (False, True):
        got, (ckv, kr) = mla.mla_attention_suffix(
            tp, _t(x), _t(q_pos), _t(kv_pos), tc.replace(accounting=acc),
            _t(pckv), _t(pkr))
        want, (jckv, jkr) = jmla.mla_attention_suffix(
            jp, *(jnp.asarray(a) for a in (x, q_pos, kv_pos)),
            jc.replace(accounting=acc), jnp.asarray(pckv), jnp.asarray(pkr))
        _close(got.numpy(), want)
        _close(ckv.numpy(), jckv)
        _close(kr.numpy(), jkr)


def test_absorbed_queries_and_finish_match_jax(attn_params):
    jc, tc = _cfgs()
    jp, tp = attn_params
    m = tc.mla
    rng = np.random.default_rng(1)
    qn, qr = _randn(rng, B, tc.n_heads, m.nope_head_dim), _randn(
        rng, B, tc.n_heads, m.rope_head_dim)
    got = mla.mla_absorbed_queries(tp, _t(qn), _t(qr), tc)
    want = jmla.mla_absorbed_queries(jp, jnp.asarray(qn), jnp.asarray(qr),
                                     jc)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    assert got[2] == want[2]
    o = _randn(rng, B, tc.n_heads, m.kv_lora_rank)
    _close(mla.mla_decode_finish(tp, _t(o), tc).numpy(),
           jmla.mla_decode_finish(jp, jnp.asarray(o), jc))


# ---------------------------------------------------------------- decode ops

def _dense_case(rng, T, q8):
    q = (_randn(rng, B, H, R), _randn(rng, B, H, ROPE))
    if q8:
        cache = (rng.integers(-127, 128, (B, T, R)).astype(np.int8),
                 rng.integers(-127, 128, (B, T, ROPE)).astype(np.int8))
        scales = (rng.uniform(1e-3, 2e-2, B).astype(np.float32),
                  rng.uniform(1e-3, 2e-2, B).astype(np.float32))
    else:
        cache = (_randn(rng, B, T, R), _randn(rng, B, T, ROPE))
        scales = ()
    return q, cache, scales


@pytest.mark.parametrize("q8", [False, True], ids=["model-dtype", "int8"])
@pytest.mark.parametrize("T,cur_len,pos0", [
    (24, 17, 0),      # cur_len < T
    (24, 30, 10),     # a slab at pos0 > 0, every key valid
    (20, 16, 9),      # pos0 > 0 and keys past cur_len masked
    (20, 5, 8),       # no valid key: m = -1e30, l = 0, o = 0
])
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_dense_mla_decode_ops_match_jax(T, cur_len, pos0, q8, jimpl, timpl):
    rng = np.random.default_rng(T + cur_len)
    q, cache, scales = _dense_case(rng, T, q8)
    op = "decode_partial_mla" + ("_q8" if q8 else "")
    jargs = [jnp.asarray(a) for a in (*q, *cache, *scales)]
    want = JD.dispatch(op, jimpl, *jargs, cur_len, pos0, scale=SCALE)
    got = D.dispatch(op, timpl, *(_t(a) for a in (*q, *cache, *scales)),
                     cur_len, pos0, scale=SCALE)
    _close_partials(got, want)
    if cur_len <= pos0:
        assert torch.all(got[2] == 0) and torch.all(got[1] == KM.NEG_INF)
        assert torch.all(got[0] == 0)


def _paged_case(rng, q8, n_pages=9, ps=4):
    """Slot 0: ragged pages with a count-0 page in the middle and a table
    entry past the pool (clamped to the last page); slot 1: no valid
    key at all (an inactive slot)."""
    q = (_randn(rng, B, H, R), _randn(rng, B, H, ROPE))
    if q8:
        pools = (rng.integers(-127, 128, (n_pages, ps, R)).astype(np.int8),
                 rng.integers(-127, 128, (n_pages, ps, ROPE)).astype(
                     np.int8))
        scales = (rng.uniform(1e-3, 2e-2, n_pages).astype(np.float32),
                  rng.uniform(1e-3, 2e-2, n_pages).astype(np.float32))
    else:
        pools = (_randn(rng, n_pages, ps, R), _randn(rng, n_pages, ps, ROPE))
        scales = ()
    table = np.array([[5, 2, 7, n_pages + 3, 0], [1, 3, 0, 0, 0]], np.int32)
    counts = np.array([[ps, ps, 0, 3, 0], [0, 0, 0, 0, 0]], np.int32)
    return q, pools, scales, table, counts


@pytest.mark.parametrize("q8", [False, True], ids=["model-dtype", "int8"])
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_paged_mla_decode_ops_match_jax(q8, jimpl, timpl):
    rng = np.random.default_rng(5)
    q, pools, scales, table, counts = _paged_case(rng, q8)
    op = "decode_partial_mla_paged" + ("_q8" if q8 else "")
    # the JAX pallas wrapper clamps the table, its xla op gathers clamped
    jargs = [jnp.asarray(a) for a in (*q, *pools, *scales, table, counts)]
    want = JD.dispatch(op, jimpl, *jargs, scale=SCALE)
    got = D.dispatch(op, timpl, *(_t(a) for a in (*q, *pools, *scales,
                                                  table, counts)),
                     scale=SCALE)
    _close_partials(got, want)
    assert torch.all(got[2][1] == 0) and torch.all(got[0][1] == 0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_split_equals_concat_view(paged):
    """The split-operand partials equal the plain GQA decode ops on the
    concatenated k_cat / v_cat view (KV = 1, rope features zero-padded in
    the values), with the query pre-scaled by ``mla_concat_view``."""
    rng = np.random.default_rng(6)
    if paged:
        q, pools, _, table, counts = _paged_case(rng, False)
        q_abs, q_rope, ckv, kr = (_t(a) for a in (*q, *pools))
        split = D.dispatch("decode_partial_mla_paged", "torch", q_abs,
                           q_rope, ckv, kr, _t(table), _t(counts),
                           scale=SCALE)
    else:
        q, cache, _ = _dense_case(rng, 24, False)
        q_abs, q_rope, ckv, kr = (_t(a) for a in (*q, *cache))
        split = D.dispatch("decode_partial_mla", "torch", q_abs, q_rope,
                           ckv, kr, 19, scale=SCALE)
    q_cat, k_cat, v_cat, r = mla.mla_concat_view(q_abs, q_rope, ckv, kr,
                                                  SCALE)
    if paged:
        cat = D.dispatch("decode_partial_paged", "torch", q_cat, k_cat,
                         v_cat, _t(table), _t(counts))
    else:
        cat = D.dispatch("decode_partial", "torch", q_cat, k_cat, v_cat, 19)
    torch.testing.assert_close(split[0], cat[0][..., :r], **TOL)
    assert torch.all(cat[0][..., r:] == 0)
    for a, b in zip(split[1:], cat[1:]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["model-dtype", "int8"])
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_chunk_prefix_mla_ops_match_jax(q8, jimpl, timpl):
    """The ``chunk_prefix_mla_paged*`` ops (kernels 12 and 15; on the CPU
    their plain versions) against JAX's: a 3-token chunk over ragged
    prior pages, a count-0 page and a table entry past the pool; then a
    first chunk with no valid prior key (m = -1e30, l = 0, o = 0)."""
    rng = np.random.default_rng(9)
    C = 3
    _, pools, scales, table, counts = _paged_case(rng, q8)
    q = (_randn(rng, C, H, R), _randn(rng, C, H, ROPE))
    op = "chunk_prefix_mla_paged" + ("_q8" if q8 else "")
    for tbl, cnt in ((table[0], counts[0]), (table[1], counts[1])):
        args = (*q, *pools, *scales, tbl, cnt)
        want = JD.dispatch(op, jimpl, *(jnp.asarray(a) for a in args),
                           scale=SCALE)
        got = D.dispatch(op, timpl, *(_t(a) for a in args), scale=SCALE)
        _close_partials(got, want)
    assert torch.all(got[2] == 0) and torch.all(got[0] == 0)
    assert torch.all(got[1] == KM.NEG_INF)


@pytest.mark.parametrize("q8", [False, True], ids=["model-dtype", "int8"])
def test_mla_decode_attend_matches_jax(q8):
    """``dist.decode``'s local split-operand attends, dense (per-sequence
    int8 scales select kernel 14) and paged (counts built once a step,
    where the JAX function takes the lengths)."""
    rng = np.random.default_rng(7)
    q, cache, scales = _dense_case(rng, 24, q8)
    kw = {}
    if q8:
        kw = dict(ckv_scale=scales[0], krope_scale=scales[1])
    want = jdd.local_mla_decode_attend(
        *(jnp.asarray(a) for a in (*q, *cache)), 21, scale=SCALE,
        **{k: jnp.asarray(v) for k, v in kw.items()}, backend="pallas")
    got = tdd.local_mla_decode_attend(
        *(_t(a) for a in (*q, *cache)), 21, scale=SCALE,
        **{k: _t(v) for k, v in kw.items()}, backend="cuda")
    assert got.dtype == torch.float32
    _close(got.numpy(), want)

    q, pools, scales, table, _ = _paged_case(rng, q8)
    lens = np.array([10, 0], np.int32)
    kw = {}
    if q8:
        kw = dict(ckv_scale=scales[0], krope_scale=scales[1])
    want = jdd.local_mla_paged_decode_attend(
        *(jnp.asarray(a) for a in (*q, *pools, table, lens)), scale=SCALE,
        **{k: jnp.asarray(v) for k, v in kw.items()}, backend="pallas")
    counts = tdd._page_counts(lens, table.shape[1], pools[0].shape[1])
    got = tdd.local_mla_paged_decode_attend(
        *(_t(a) for a in (*q, *pools, table, counts)), scale=SCALE,
        **{k: _t(v) for k, v in kw.items()}, backend="cuda")
    _close(got.numpy(), want)
    with pytest.raises(NotImplementedError, match="item 14"):
        tdd.mla_decode_attend(*(_t(a) for a in (*q, *cache)), 21,
                              scale=SCALE, seq_shard=True)


def test_cpu_mla_ops_run_the_plain_version_uncounted():
    rng = np.random.default_rng(8)
    q, pools, scales, table, counts = _paged_case(rng, True)
    build.reset_launches()
    got = KM.vwr_mla_paged_flash_decode_q8(
        *(_t(a) for a in (*q, *pools, *scales, table, counts)), scale=SCALE)
    want = KM.vwr_mla_paged_flash_decode_q8_ref(
        *(_t(a) for a in (*q, *pools, *scales, table, counts)), scale=SCALE)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(n == 0 for n in build.LAUNCHES.values())


def test_mla_kernel_shapes_are_checked():
    """On a non-CPU device the wrapper reaches the kernel's checks: a
    rank or rope width past the widest the kernel has an instance for is
    refused; a narrower one (r 48, rope 8) is zero-padded to the next
    (64, 32) and goes on to the device check."""
    meta = dict(device="meta")
    q_rope = torch.empty(2, 4, 64, **meta)
    with pytest.raises(ValueError, match="past the widest"):
        KM.vwr_mla_flash_decode(torch.empty(2, 4, 1024, **meta), q_rope,
                                torch.empty(2, 8, 1024, **meta),
                                torch.empty(2, 8, 64, **meta), 8,
                                scale=1.0)
    with pytest.raises(ValueError, match="past the widest"):
        KM.vwr_mla_flash_decode(torch.empty(2, 4, 64, **meta),
                                torch.empty(2, 4, 96, **meta),
                                torch.empty(2, 8, 64, **meta),
                                torch.empty(2, 8, 96, **meta), 8,
                                scale=1.0)
    for r, rope in ((48, 8), (64, 64)):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            KM.vwr_mla_flash_decode(
                torch.empty(2, 4, r, **meta), torch.empty(2, 4, rope, **meta),
                torch.empty(2, 8, r, **meta), torch.empty(2, 8, rope, **meta),
                8, scale=1.0)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these there)")
    return torch.device("cuda")


def _card_inputs(g, B_, H_, r, rope, T, dt, q8, dev):
    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    q = (rn(B_, H_, r), rn(B_, H_, rope))
    if q8:
        cache = [torch.randint(-127, 128, (B_, T, w), generator=g,
                               device=dev, dtype=torch.int8)
                 for w in (r, rope)]
        scales = [torch.rand(B_, generator=g, device=dev) * 0.02 + 1e-3
                  for _ in range(2)]
    else:
        cache = [rn(B_, T, w).to(dt) for w in (r, rope)]
        scales = []
    return q, cache, scales


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,rope,H_", [(512, 64, 128), (32, 32, 4),
                                       (128, 64, 20)])
def test_cuda_dense_mla_kernels_match_plain(cuda, dtype, q8, r, rope, H_):
    """Kernels 10 and 14 against their plain versions: ragged T, a slab at
    pos0 > 0, a sequence with no valid key, heads not a multiple of 16."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    q, cache, scales = _card_inputs(g, 3, H_, r, rope, 37, dt, q8, cuda)
    fn = KM.vwr_mla_flash_decode_q8 if q8 else KM.vwr_mla_flash_decode
    ref = (KM.vwr_mla_flash_decode_q8_ref if q8
           else KM.vwr_mla_flash_decode_ref)
    for cur, pos0 in ((37, 0), (30, 0), (40, 5), (4, 9)):
        args = (*q, *cache, *scales, cur, pos0)
        got = fn(*args, scale=0.07)
        torch.cuda.synchronize()
        for a, b in zip(got, ref(*args, scale=0.07)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pools", "int8-pools"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 8, 32])
def test_cuda_paged_mla_kernels_match_plain(cuda, dtype, q8, ps):
    """Kernels 11 and 13 against their plain versions at DeepSeek-V3's
    widths: ragged pages, a count-0 page, an inactive slot and a table
    entry past the pool; pages of 8, 16 and 32 rows."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    n_pages, r, rope, H_ = 24, 512, 64, 128
    q, pools, _ = _card_inputs(g, 3, H_, r, rope, 1, dt, False, cuda)
    if q8:
        pools = [torch.randint(-127, 128, (n_pages, ps, w), generator=g,
                               device=cuda, dtype=torch.int8)
                 for w in (r, rope)]
        scales = [torch.rand(n_pages, generator=g, device=cuda) * 0.02
                  + 1e-3 for _ in range(2)]
    else:
        pools = [torch.randn(n_pages, ps, w, generator=g,
                             device=cuda).to(dt) for w in (r, rope)]
        scales = []
    table = torch.tensor([[4, 9, 2, 30, 0], [7, 1, 0, 0, 0],
                          [3, 5, 8, 11, 13]], dtype=torch.int32,
                         device=cuda)
    counts = torch.tensor([[ps, ps, 0, 3, 0], [0, 0, 0, 0, 0],
                           [ps, ps, ps, ps, 1]], dtype=torch.int32,
                          device=cuda)
    fn = (KM.vwr_mla_paged_flash_decode_q8 if q8
          else KM.vwr_mla_paged_flash_decode)
    ref = (KM.vwr_mla_paged_flash_decode_q8_ref if q8
           else KM.vwr_mla_paged_flash_decode_ref)
    args = (*q, *pools, *scales, table, counts)
    got = fn(*args, scale=0.07)
    torch.cuda.synchronize()
    for a, b in zip(got, ref(*args, scale=0.07)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert torch.all(got[2][1] == 0) and torch.all(got[1][1] == KM.NEG_INF)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pools", "int8-pools"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_chunk_kernels_match_plain(cuda, dtype, q8):
    """Kernels 12 and 15 against their plain versions at DeepSeek-V3's
    widths: a 64-token chunk over full pages, a partial page, a count-0
    page and a table entry past the pool; C 1; a first chunk."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    n_pages, ps, r, rope, H_ = 24, 16, 512, 64, 128
    if q8:
        pools = [torch.randint(-127, 128, (n_pages, ps, w), generator=g,
                               device=cuda, dtype=torch.int8)
                 for w in (r, rope)]
        scales = [torch.rand(n_pages, generator=g, device=cuda) * 0.02
                  + 1e-3 for _ in range(2)]
    else:
        pools = [torch.randn(n_pages, ps, w, generator=g,
                             device=cuda).to(dt) for w in (r, rope)]
        scales = []
    fn = (KM.vwr_mla_chunk_prefix_attend_q8 if q8
          else KM.vwr_mla_chunk_prefix_attend)
    ref = (KM.vwr_mla_chunk_prefix_attend_q8_ref if q8
           else KM.vwr_mla_chunk_prefix_attend_ref)
    for C, table, counts in ((64, [4, 9, 2, 30, 0], [ps, ps, 0, 3, ps]),
                             (1, [7, 1], [ps, 5]), (5, [3, 8], [0, 0])):
        q, _, _ = _card_inputs(g, C, H_, r, rope, 1, dt, False, cuda)
        args = (*q, *pools, *scales,
                torch.tensor(table, dtype=torch.int32, device=cuda),
                torch.tensor(counts, dtype=torch.int32, device=cuda))
        got = fn(*args, scale=0.07)
        torch.cuda.synchronize()
        for a, b in zip(got, ref(*args, scale=0.07)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
