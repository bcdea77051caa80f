"""The port's hybrid family (zamba2-1.2b: Mamba2 blocks with one shared
attention + MLP block after every ``attn_every`` of them) against the
JAX package.

Reduced fp32 config (5 Mamba2 blocks = 2 groups of 2 + a tail of 1, so 3
shared-block invocations; d 64, d_inner 128, 8 heads of 16, d_state 8,
chunk 16), JAX parameters through the bridge, inputs made with numpy from
a seed.  Held: the parameter tree; ``mamba2_forward`` (the chunk scan and
the closed form) and ``mamba2_step``, with a state carried in; prefill
logits and every cache leaf; decode steps from a JAX cache bridged in;
greedy ``generate`` against the JAX engine at prompts of 32 (two chunks),
7 (under a chunk) and 2 (under the conv tail); a prompt of 24 (neither
under a chunk nor a multiple of it) raises on both sides.

Tolerance: 1e-4 of the outputs' scale (max |x|, at least 1), as
``test_torch_lm.py`` holds the dense family; greedy tokens identical.
The JAX engine runs on an explicit (1, 1) mesh with Auto axes (its
default mesh fails under JAX 0.9, ROADMAP queue 3).
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
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                pad_cache_from_prefill)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

NAME = "zamba2-1.2b"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, f"{what}: max|d| {err:.3g} > {TOL * scale:.3g}"


def _cfgs(jimpl="xla", timpl="torch"):
    return (jconfigs.reduced(jconfigs.get_config(NAME)).replace(
        kernel_impl=jimpl),
        tconfigs.reduced(tconfigs.get_config(NAME)).replace(
            kernel_impl=timpl))


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


def test_spec_matches_jax():
    """The nested stacks: ``mamba_main`` / ``mamba_norms`` (n_main, k,
    ...), ``mamba_tail`` / ``tail_norms`` (tail, ...), one
    ``shared_attn`` block: leaf for leaf the JAX tree's shapes and
    dtypes; the port's init fills the constants as JAX's does."""
    jc, tc = _cfgs()
    theirs = {tuple(k.key for k in path): (tuple(a.shape), str(a.dtype))
              for path, a in jax.tree_util.tree_flatten_with_path(
                  jlm.abstract_init(jc))[0]}
    mine = {path: (tuple(d.shape), str(d.dtype).split(".")[-1])
            for path, d in leaves(lm.model_spec(tc))}
    assert mine == theirs
    k, n_main, tail, n_inv = lm._hybrid_groups(tc)
    assert (k, n_main, tail, n_inv) == (2, 2, 1, 3)
    assert mine[("mamba_main", "a_log")][0] == (n_main, k, 8)
    tp = lm.init(tc, seed=0, device="cpu")
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    for name in ("a_log", "dt_bias", "d_skip"):
        np.testing.assert_allclose(tp["mamba_main"][name].numpy(),
                                   np.asarray(jp["mamba_main"][name]),
                                   rtol=1e-6)


def _mamba_inputs(jc, S, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, S, jc.d_model)) * 0.5).astype(np.float32)
    return x


@pytest.mark.parametrize("S", [32, 7, 2])
@pytest.mark.parametrize("accounting", [False, True],
                         ids=["scan", "closed"])
def test_mamba2_forward_matches_jax(S, accounting):
    """One Mamba2 block over S positions from a zero state, then 16 more
    positions with that state carried in (conv tail and SSM state):
    outputs and states against JAX's, the chunk scan and the closed
    form (``cfg.accounting``)."""
    jc, tc = _cfgs()
    jc, tc = (c.replace(accounting=accounting) for c in (jc, tc))
    jp, tp = _params(jc)
    jl = jax.tree.map(lambda a: a[0, 0], jp["mamba_main"])
    tl = lm._layer(lm._layer(tp["mamba_main"], 0), 0)
    x = _mamba_inputs(jc, S + 16, 1)
    jy, jst = jssm.mamba2_forward(jl, jnp.asarray(x[:, :S]), jc)
    ty, tst = ssm.mamba2_forward(tl, torch.from_numpy(x[:, :S]), tc)
    _close(ty.numpy(), jy, "y")
    _same_leaves(tst, jst, "state")
    jy, jst = jssm.mamba2_forward(jl, jnp.asarray(x[:, S:]), jc, jst)
    ty, tst = ssm.mamba2_forward(tl, torch.from_numpy(x[:, S:]), tc, tst)
    _close(ty.numpy(), jy, "y, state carried in")
    _same_leaves(tst, jst, "state, carried in")


def test_mamba2_step_matches_jax():
    """``mamba2_step`` for 5 tokens from a 7-token prefill's state."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    jl = jax.tree.map(lambda a: a[1, 0], jp["mamba_main"])
    tl = lm._layer(lm._layer(tp["mamba_main"], 1), 0)
    x = _mamba_inputs(jc, 12, 2)
    _, jst = jssm.mamba2_forward(jl, jnp.asarray(x[:, :7]), jc)
    _, tst = ssm.mamba2_forward(tl, torch.from_numpy(x[:, :7]), tc)
    for t in range(7, 12):
        jy, jst = jssm.mamba2_step(jl, jnp.asarray(x[:, t]), jst, jc)
        ty, tst = ssm.mamba2_step(tl, torch.from_numpy(x[:, t]), tst, tc)
        _close(ty.numpy(), jy, f"step {t}")
        _same_leaves(tst, jst, f"state {t}")


@pytest.mark.parametrize("P", [32, 7, 2])
def test_prefill_and_cache_match_jax(P):
    """Prefill logits and every leaf of the padded decode cache (the
    Mamba2 states as they are, the shared block's K/V at offset 0 of
    ``attn_k`` / ``attn_v``), then 4 decode steps fed JAX's greedy tokens
    with the caches compared after them."""
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


@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_decode_from_bridged_jax_cache(jimpl, timpl):
    """A JAX prefill's cache crosses into the port through the bridge
    (its NamedTuple states field by field); 3 decode steps from it match
    JAX's, on both backends (JAX's Pallas kernels in interpret mode, the
    port's kernel wrappers on their plain versions), the cache updated
    in place."""
    jc, tc = _cfgs(jimpl, timpl)
    jp, tp = _params(jc)
    B, P = 2, 16
    toks = np.random.default_rng(5).integers(0, jc.vocab, (B, P)).astype(
        np.int32)
    jlg, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    jcache = jpad(jc, jkv, B, P + 3)
    tcache = bridge.from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert tcache["mamba_main"].ssm.dtype == torch.float32
    before = tcache["mamba_main"].ssm
    tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    for i in range(3):
        jlg, jcache = jlm.decode_step(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
            "cache": jcache}, jc)
        tlg, out = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": P + i,
            "cache": tcache}, tc)
        assert out is tcache and out["mamba_main"].ssm is before
        _close(tlg.numpy(), jlg, f"decode step {i}")
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    _same_leaves(tcache, jcache, "cache after decode")


@pytest.mark.parametrize("P", [32, 7, 2])
def test_generate_matches_jax(P):
    """Greedy ``generate`` on the dense cache: the JAX engine's tokens
    (the kernel backend, plain versions on the CPU)."""
    B, GEN = 2, 6
    jc, tc = _cfgs()
    jeng = JEngine(jc, JEngineConfig(batch=B, max_len=P + GEN),
                   mesh=_mesh())
    toks = np.random.default_rng(7).integers(0, jc.vocab, (B, P)).astype(
        np.int32)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=B, max_len=P + GEN,
                                        kernel_impl="cuda"),
                       params=params, device="cpu")
    got, _ = eng.generate({"tokens": toks}, gen=GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_off_the_chunk_raises():
    """24 positions with a chunk of 16: JAX asserts, the port raises (a
    padded prompt would change the recurrent state)."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    toks = np.zeros((1, 24), np.int32)
    with pytest.raises(AssertionError):
        jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    with pytest.raises(ValueError, match="multiple"):
        lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    with pytest.raises(ValueError, match="multiple"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=32), params=tp,
                     device="cpu").generate({"tokens": toks}, gen=2)
