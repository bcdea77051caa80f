"""The port's MoE FFN (``models/moe.py``) and the moe family's model
(``models/lm.py``: reduced deepseek-v3 with MLA and a dense first layer,
reduced olmoe with GQA) against the JAX package's.

Routing and dispatch in fp32 at 1e-5 (atol and rtol), expert ids and
positions exactly, with capacity drops forced (a small capacity factor)
and both dispatch modes; ``moe_ffn``'s output and aux losses at 1e-5.
The model: prefill logits and 8 greedy decode steps against
``lm.prefill`` / ``lm.decode_step`` at 1e-4 of the logits' scale (the
tolerance of ``test_torch_lm.py``), greedy tokens identical, for JAX
'xla' against the port's 'torch' and JAX 'pallas' (interpret mode)
against the port's 'cuda' (plain versions on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.common import module as JM  # noqa: E402
from repro.engine import pad_cache_from_prefill as jpad  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import module as M  # noqa: E402
from repro_torch.engine import pad_cache_from_prefill  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = 1e-4
NAMES = ["deepseek-v3-671b", "olmoe-1b-7b"]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfgs(name, **moe_kw):
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    if moe_kw:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _moe_params(jc, seed=0):
    jp = JM.init_params(jmoe.moe_spec(jc), jax.random.PRNGKey(seed))
    if "e_bias" in jp:      # a selection bias that moves the choice
        jp["e_bias"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                         jp["e_bias"].shape) * 0.05
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(tc, G, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (G, S, tc.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_moe_spec_matches_jax(name):
    """Leaf shapes equal the JAX spec's; the router and the selection
    bias stay fp32 whatever the model dtype."""
    jc, tc = _cfgs(name)
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    want = {p: (tuple(a.shape), jnp.dtype(a.dtype).name) for p, a in
            M.leaves(JM.abstract_params(jmoe.moe_spec(jc)))}
    got = {p: (d.shape, str(d.dtype).split(".")[-1])
           for p, d in M.leaves(moe.moe_spec(tc))}
    assert got == want
    assert got[("router",)][1] == "float32"


@pytest.mark.parametrize("name", NAMES)
def test_routing_matches_jax(name):
    """Router probabilities, selection scores, top-k gates and expert
    ids, and both position schemes (cumsum == sort == JAX's)."""
    jc, tc = _cfgs(name)
    jp, tp = _moe_params(jc)
    x = _x(tc, 2, 24)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jprobs, jsel, jlog = jmoe.router_scores(jp, jx, jc)
    probs, sel, logits = moe.router_scores(tp, tx, tc)
    for g, w in ((probs, jprobs), (sel, jsel), (logits, jlog)):
        _close(g.numpy(), w)
    jg, jidx = jmoe.top_k_gates(jprobs, jsel, jc)
    gates, idx = moe.top_k_gates(probs, sel, tc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates.numpy(), jg)
    flat = idx.reshape(2, -1)
    want = np.asarray(jmoe._positions_cumsum(jidx.reshape(2, -1),
                                             jc.moe.n_experts))
    for fn in (moe._positions_cumsum, moe._positions_sort):
        np.testing.assert_array_equal(fn(flat, tc.moe.n_experts).numpy(),
                                      want)


def test_top_k_breaks_ties_to_the_lower_index():
    jc, tc = _cfgs("olmoe-1b-7b")
    sel = np.array([[0.1, 0.3, 0.3, 0.05, 0.3, 0.1, 0.0, 0.3]],
                   np.float32)
    _, jidx = jmoe.top_k_gates(jnp.asarray(sel), jnp.asarray(sel), jc)
    _, idx = moe.top_k_gates(torch.from_numpy(sel), torch.from_numpy(sel),
                             tc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[1, 2]]


@pytest.mark.parametrize("dispatch", ["gather", "sort"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "drops"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_matches_jax(name, cf, dispatch):
    """Output and aux losses; at capacity factor 0.5 assignments are
    dropped (by (token, k) order), and the same ones on both sides."""
    jc, tc = _cfgs(name, capacity_factor=cf, dispatch=dispatch)
    jp, tp = _moe_params(jc)
    x = _x(tc, 3, 16)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jc)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), tc)
    _close(y.numpy(), jy)
    assert set(aux) == {"lb_loss", "z_loss", "drop_frac"}
    for k in aux:
        _close(aux[k].numpy(), jaux[k])
    if cf < 1:
        assert float(aux["drop_frac"]) > 0


@pytest.mark.parametrize("name", NAMES)
def test_full_ep_matches_jax(name):
    """``ep='full_ep'`` only constrains JAX's layout: on one device its
    output and aux losses equal JAX's full_ep ``moe_ffn`` (drops
    forced), as 'gspmd' does; the expert-parallel blocks are
    ``test_torch_tp_engine.py``'s."""
    jc, tc = _cfgs(name, ep="full_ep", capacity_factor=0.5)
    jp, tp = _moe_params(jc)
    x = _x(tc, 2, 16)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jc)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), tc)
    _close(y.numpy(), jy)
    for k in aux:
        _close(aux[k].numpy(), jaux[k])
    assert float(aux["drop_frac"]) > 0


# ---------------------------------------------------------------- the model

B, P, STEPS = 2, 16, 8


def _close_logits(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= LOGIT_TOL * scale, (
        f"{what}: max|d| {err:.3g} > {LOGIT_TOL * scale:.3g}")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_prefill_and_decode_match_jax(name, jimpl, timpl):
    jc = jconfigs.reduced(jconfigs.get_config(name)).replace(
        kernel_impl=jimpl)
    tc = tconfigs.reduced(tconfigs.get_config(name)).replace(
        kernel_impl=timpl)
    params = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab, (B, P),
                                             dtype=np.int32)
    jl, jkv = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jc)
    tl, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert tl.dtype == torch.float32 and tl.shape == (B, tc.vocab_padded)
    _close_logits(tl.numpy(), jl, "prefill logits")
    for t, j in zip(jax.tree.leaves(tkv, is_leaf=torch.is_tensor),
                    jax.tree.leaves(jkv)):      # the per-group stacks
        _close_logits(t.numpy(), j, "prefill cache")

    max_len = P + STEPS
    jcache = jpad(jc, jkv, B, max_len)
    tcache = pad_cache_from_prefill(tc, tkv, B, max_len)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    # jitted: the eager moe decode step takes seconds a step on the CPU
    jstep = jax.jit(lambda p, b: jlm.decode_step(p, b, jc))
    for i in range(STEPS):
        jl, jcache = jstep(params, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
            "cache": jcache})
        tl, tcache = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": P + i,
            "cache": tcache}, tc)
        _close_logits(tl.numpy(), jl, f"decode step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want
    key = "ckv" if tc.mla is not None else "k"
    _close_logits(tcache["moe"][key].numpy(), jcache["moe"][key],
                  "decode cache")


@pytest.mark.parametrize("name", NAMES)
def test_model_and_cache_specs_match_jax(name):
    jc, tc = _cfgs(name)
    want = {p: tuple(a.shape) for p, a in
            M.leaves(jlm.abstract_init(jc))}
    got = {p: d.shape for p, d in M.leaves(lm.model_spec(tc))}
    assert got == want
    jspec = jlm.cache_spec(jc, 3, 20)
    tspec = lm.cache_spec(tc, 3, 20)
    assert set(tspec) == {"dense", "moe"}
    for grp in ("dense", "moe"):
        if jspec[grp] is None:
            assert tspec[grp] is None
            continue
        assert {k: v[0] for k, v in tspec[grp].items()} == {
            k: tuple(v.shape) for k, v in jspec[grp].items()}
