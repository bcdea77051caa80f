"""The port's ssm family (xlstm-350m: groups of mLSTM blocks closed by
one sLSTM block) against the JAX package.

Reduced fp32 config (2 groups of 1 mLSTM + 1 sLSTM; d 64, 4 heads,
mLSTM d_inner 128 (P 32), chunk 16), JAX parameters through the bridge,
inputs made with numpy from a seed.  Held: the parameter tree;
``mlstm_chunkwise`` (scan and ``unroll``), ``mlstm_ref``,
``mlstm_forward`` / ``mlstm_step`` and ``slstm_forward`` (and its
accounting program) / ``slstm_step``, with states carried in; prefill
logits and every cache leaf; decode steps from a JAX cache bridged in;
greedy ``generate`` against the JAX engine at prompts of 32 (two chunks),
7 and 2; a prompt of 24 raises on both sides.  The family launches no
kernel, so the two dispatch backends run the same code.

Tolerance: 1e-4 of the outputs' scale (max |x|, at least 1), as
``test_torch_lm.py`` holds the dense family; greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import pad_cache_from_prefill as jpad  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                pad_cache_from_prefill)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402

NAME = "xlstm-350m"
TOL = 1e-4


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, f"{what}: max|d| {err:.3g} > {TOL * scale:.3g}"


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_config(NAME)),
            tconfigs.reduced(tconfigs.get_config(NAME)).replace(
                kernel_impl="torch"))


def _params(jc):
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree):
    """A port cache's leaves in ``jax.tree.leaves`` order: dict keys
    sorted, NamedTuple fields in order, None left out."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for f in tree for x in _flat(f)]
    return [tree]


def _same_leaves(got, want, what):
    flat = jax.tree.leaves(want)
    mine = _flat(got)
    assert len(mine) == len(flat), what
    for t, j in zip(mine, flat):
        assert tuple(t.shape) == j.shape, what
        assert str(t.dtype).split(".")[-1] == str(j.dtype), what
        _close(t.numpy(), j, what)


def _both(*arrays):
    """numpy arrays -> (JAX arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def test_spec_matches_jax():
    """``mlstm`` / ``mlstm_norms`` (groups, m a group, ...) and ``slstm``
    (groups, ...): leaf for leaf the JAX tree's shapes and dtypes; the
    port's init fills ``b_f`` with 3 as JAX's does."""
    jc, tc = _cfgs()
    theirs = {tuple(k.key for k in path): (tuple(a.shape), str(a.dtype))
              for path, a in jax.tree_util.tree_flatten_with_path(
                  jlm.abstract_init(jc))[0]}
    mine = {path: (tuple(d.shape), str(d.dtype).split(".")[-1])
            for path, d in leaves(lm.model_spec(tc))}
    assert mine == theirs
    assert lm._ssm_groups(tc) == (1, 2)
    assert mine[("mlstm", "wq")][0] == (2, 1, 128, 4, 32)
    tp = lm.init(tc, seed=0, device="cpu")
    assert bool((tp["mlstm"]["b_f"] == 3.0).all())


def _qkvif(S, seed, B=2, H=4, P=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((B, S, H)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.standard_normal((B, S, H)) + 2)))
                ).astype(np.float32)
    return q, k, v, li, lf


def _state(seed, B=2, H=4, P=32):
    """A carried-in (C, n, m) state: what 8 positions leave behind."""
    q, k, v, li, lf = _qkvif(8, seed, B, H, P)
    z = (np.zeros((B, H, P, P), np.float32), np.zeros((B, H, P), np.float32),
         np.full((B, H), -1e30, np.float32))
    _, st = jxl.mlstm_ref(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                          tuple(jnp.asarray(a) for a in z))
    return tuple(np.array(a) for a in st)


@pytest.mark.parametrize("S", [32, 7, 2])
@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unroll"])
def test_mlstm_chunkwise_and_ref_match_jax(S, unroll):
    """``mlstm_chunkwise`` (chunk 16) and ``mlstm_ref`` over S positions
    from a carried-in state: h and (C, n, m) against JAX's, and the two
    formulations against each other."""
    j, t = _both(*_qkvif(S, 3))
    st = _state(4)
    js, ts = _both(*st)
    jh, jst = jxl.mlstm_chunkwise(*j, tuple(js), 16, unroll=unroll)
    th, tst = xl.mlstm_chunkwise(*t, tuple(ts), 16, unroll=unroll)
    _close(th.numpy(), jh, "chunkwise h")
    for a, b in zip(tst, jst):
        _close(a.numpy(), b, "chunkwise state")
    jh, jst = jxl.mlstm_ref(*j, tuple(js))
    rh, rst = xl.mlstm_ref(*t, tuple(ts))
    _close(rh.numpy(), jh, "ref h")
    _close(th.numpy(), rh.numpy(), "chunkwise vs ref")
    for a, b in zip(rst, jst):
        _close(a.numpy(), b, "ref state")


def _layers(jc, tc):
    jp, tp = _params(jc)
    jm = jax.tree.map(lambda a: a[1, 0], jp["mlstm"])
    tm = lm._layer(lm._layer(tp["mlstm"], 1), 0)
    js = jax.tree.map(lambda a: a[1], jp["slstm"])
    ts = lm._layer(tp["slstm"], 1)
    return jm, tm, js, ts


def _x(jc, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, jc.d_model)) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("S", [32, 7, 2])
def test_mlstm_block_matches_jax(S):
    """``mlstm_forward`` over S positions, then 16 more with the state
    carried in (conv tail and (C, n, m)), then 3 ``mlstm_step``s."""
    jc, tc = _cfgs()
    jm, tm, _, _ = _layers(jc, tc)
    x = _x(jc, S + 19, 5)
    jy, jst = jxl.mlstm_forward(jm, jnp.asarray(x[:, :S]), jc)
    ty, tst = xl.mlstm_forward(tm, torch.from_numpy(x[:, :S]), tc)
    _close(ty.numpy(), jy, "y")
    _same_leaves(tst, jst, "state")
    jy, jst = jxl.mlstm_forward(jm, jnp.asarray(x[:, S:S + 16]), jc, jst)
    ty, tst = xl.mlstm_forward(tm, torch.from_numpy(x[:, S:S + 16]), tc,
                               tst)
    _close(ty.numpy(), jy, "y, state carried in")
    _same_leaves(tst, jst, "state, carried in")
    for t in range(S + 16, S + 19):
        jy, jst = jxl.mlstm_step(jm, jnp.asarray(x[:, t]), jst, jc)
        ty, tst = xl.mlstm_step(tm, torch.from_numpy(x[:, t]), tst, tc)
        _close(ty.numpy(), jy, f"step {t}")
        _same_leaves(tst, jst, f"state {t}")


@pytest.mark.parametrize("accounting", [False, True],
                         ids=["scan", "accounting"])
def test_slstm_block_matches_jax(accounting):
    """``slstm_forward`` over 7 positions from a fresh state, then 5 more
    from its state, then 3 ``slstm_step``s; with ``accounting`` the JAX
    package's operation-equivalent program (its output and fresh state)."""
    jc, tc = _cfgs()
    jc, tc = (c.replace(accounting=accounting) for c in (jc, tc))
    _, _, js, ts = _layers(jc, tc)
    x = _x(jc, 15, 6)
    jy, jst = jxl.slstm_forward(js, jnp.asarray(x[:, :7]), jc)
    ty, tst = xl.slstm_forward(ts, torch.from_numpy(x[:, :7]), tc)
    _close(ty.numpy(), jy, "y")
    _same_leaves(tst, jst, "state")
    jy, jst = jxl.slstm_forward(js, jnp.asarray(x[:, 7:12]), jc, jst)
    ty, tst = xl.slstm_forward(ts, torch.from_numpy(x[:, 7:12]), tc, tst)
    _close(ty.numpy(), jy, "y, state carried in")
    _same_leaves(tst, jst, "state, carried in")
    for t in range(12, 15):
        jy, jst = jxl.slstm_step(js, jnp.asarray(x[:, t]), jst, jc)
        ty, tst = xl.slstm_step(ts, torch.from_numpy(x[:, t]), tst, tc)
        _close(ty.numpy(), jy, f"step {t}")
        _same_leaves(tst, jst, f"state {t}")


@pytest.mark.parametrize("P", [32, 7, 2])
def test_prefill_and_cache_match_jax(P):
    """Prefill logits and every leaf of the decode cache (the mLSTM and
    sLSTM states as they are), then 4 decode steps fed JAX's greedy
    tokens with the caches compared after them."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    B, steps = 2, 4
    toks = np.random.default_rng(P).integers(0, jc.vocab, (B, P)).astype(
        np.int32)
    jlg, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tlg, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tlg.numpy(), jlg, "prefill logits")
    jcache = jpad(jc, jkv, B, P + steps)
    tcache = pad_cache_from_prefill(tc, tkv, B, P + steps)
    _same_leaves(tcache, jcache, "cache")
    tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    for i in range(steps):
        jlg, jcache = jlm.decode_step(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
            "cache": jcache}, jc)
        tlg, tcache = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": P + i,
            "cache": tcache}, tc)
        _close(tlg.numpy(), jlg, f"decode step {i}")
        want = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), want)
        tok = want
    _same_leaves(tcache, jcache, "cache after decode")


def test_decode_from_fresh_and_bridged_caches():
    """``init_cache`` equals JAX's (zeros, stabilizers at -1e30); decode
    steps from a fresh cache, and from a JAX prefill's cache bridged in
    (NamedTuple states field by field), match JAX's, the cache updated
    in place."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    B, P = 2, 16
    _same_leaves(lm.init_cache(tc, B, 8, device="cpu"),
                 jlm.init_cache(jc, B, 8), "init_cache")
    toks = np.random.default_rng(8).integers(0, jc.vocab, (B, P)).astype(
        np.int32)
    jlg, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    for jcache in (jlm.init_cache(jc, B, P + 3), jpad(jc, jkv, B, P + 3)):
        tcache = bridge.from_jax(jax.tree.map(np.asarray, jcache), "cpu")
        before = tcache["mlstm"].C
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        for i in range(3):
            jl2, jcache = jlm.decode_step(jp, {
                "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
                "cache": jcache}, jc)
            tl2, out = lm.decode_step(tp, {
                "token": torch.from_numpy(tok), "cur_len": P + i,
                "cache": tcache}, tc)
            assert out is tcache and out["mlstm"].C is before
            _close(tl2.numpy(), jl2, f"decode step {i}")
            tok = np.asarray(jnp.argmax(jl2, -1)).astype(np.int32)
        _same_leaves(tcache, jcache, "cache after decode")


@pytest.mark.parametrize("P", [32, 7, 2])
def test_generate_matches_jax(P):
    """Greedy ``generate`` on the dense cache: the JAX engine's tokens."""
    B, GEN = 2, 6
    jc, tc = _cfgs()
    jeng = JEngine(jc, JEngineConfig(batch=B, max_len=P + GEN),
                   mesh=_mesh())
    toks = np.random.default_rng(9).integers(0, jc.vocab, (B, P)).astype(
        np.int32)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=B, max_len=P + GEN,
                                        kernel_impl="cuda"),
                       params=params, device="cpu")
    got, _ = eng.generate({"tokens": toks}, gen=GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_off_the_chunk_raises():
    """24 positions with a chunk of 16: JAX asserts, the port raises."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    toks = np.zeros((1, 24), np.int32)
    with pytest.raises(AssertionError):
        jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    with pytest.raises(ValueError, match="multiple"):
        lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
