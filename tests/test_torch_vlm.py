"""The port's vlm family (internvl2-2b: a dense GQA decoder whose prompt
opens with projected frontend embeddings) against the JAX package.

Reduced fp32 config (4 layers, d 64, 4 / 2 heads, 8 frontend tokens of
dim 32), JAX parameters through the bridge, inputs made with numpy from
a seed.  Held: the parameter tree, prefill logits and KV stacks, dense
and paged decode steps (paged rows equal to the dense ones), greedy
``generate`` on the dense cache and on bf16 / int8 pools, and a
Scheduler stream with one preemption, against the JAX engine and
Scheduler; the prefix-cache and chunked-prefill refusals.

Tolerance: 1e-4 of the logits' scale (max |logit|, at least 1), as
``test_torch_lm.py`` holds the dense family; greedy tokens identical.
The JAX side runs its Pallas kernels in interpret mode and its engine on
an explicit (1, 1) mesh with Auto axes (its default mesh fails under JAX
0.9, ROADMAP queue 3).
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
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import Scheduler as JScheduler  # noqa: E402
from repro.engine import pad_cache_from_prefill as jpad  # noqa: E402
from repro.engine import paged_cache as jpc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                Request, RequestStatus, Scheduler,
                                pad_cache_from_prefill)
from repro_torch.engine import paged_cache as tpc  # noqa: E402
from repro_torch.models import lm  # noqa: E402

NAME = "internvl2-2b"
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


def _emb(rng, cfg, *lead):
    return rng.standard_normal(
        (*lead, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def test_spec_matches_jax():
    """The vlm spec is the dense one plus ``frontend`` (frontend_dim,
    d_model), leaf for leaf the JAX tree's shapes."""
    _spec_matches_jax(*_cfgs())


def _spec_matches_jax(jc, tc):
    from repro_torch.common.module import leaves
    theirs = {tuple(k.key for k in path): tuple(a.shape) for path, a in
              jax.tree_util.tree_flatten_with_path(jlm.abstract_init(jc))[0]}
    mine = {path: tuple(d.shape) for path, d in leaves(lm.model_spec(tc))}
    assert mine == theirs
    assert mine[("frontend", "w")] == (tc.frontend_dim, tc.d_model)


@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_prefill_and_decode_match_jax(jimpl, timpl):
    """Prefill over 8 frontend + 12 token positions (logits and each
    layer's KV), then 4 dense decode steps fed the JAX greedy tokens at
    positions 20-23."""
    jc, tc = _cfgs(jimpl, timpl)
    jp, tp = _params(jc)
    rng = np.random.default_rng(0)
    B, P, steps = 2, 12, 4
    toks = rng.integers(0, jc.vocab, (B, P)).astype(np.int32)
    emb = _emb(rng, jc, B)
    jl, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                               "frontend_emb": jnp.asarray(emb)}, jc)
    tl, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(toks),
                              "frontend_emb": torch.from_numpy(emb)}, tc)
    S = P + tc.frontend_tokens
    assert tkv[0].shape == (tc.n_layers, B, S, tc.n_kv_heads, tc.d_head)
    _close(tl.numpy(), jl, "prefill logits")
    for t, j in zip(tkv, jkv):
        _close(t.numpy(), j, "prefill kv")
    jcache = jpad(jc, jkv, B, S + steps)
    tcache = pad_cache_from_prefill(tc, tkv, B, S + steps)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(steps):
        jl, jcache = jlm.decode_step(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(S + i),
            "cache": jcache}, jc)
        tl, tcache = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": S + i,
            "cache": tcache}, tc)
        _close(tl.numpy(), jl, f"decode step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_decode_step_matches_jax_and_dense(kv_dtype):
    """Two slots of different prompt lengths (each prefilled with its
    frontend, batch 1, into permuted pages) and an inactive slot, 4 paged
    steps against the JAX paged step; on model-dtype pools each active
    row also equals the port's dense decode of that request alone.  The
    int8 pools start from JAX's prefill stacks, quantized by the port."""
    jc, tc = _cfgs("pallas", "cuda")
    jp, tp = _params(jc)
    rng = np.random.default_rng(9)
    ps, n_pages, J, steps = 4, 24, 6, 4
    F = tc.frontend_tokens
    prompts = [rng.integers(0, jc.vocab, (P,)).astype(np.int32)
               for P in (5, 9)]
    embs = [_emb(rng, jc) for _ in prompts]
    table = np.zeros((3, J), np.int32)
    table[:2] = rng.permutation(n_pages)[:2 * J].reshape(2, J)
    jcache = jpc.init_paged_cache(jc, n_pages, ps, 3, kv_dtype=kv_dtype)
    tcache = tpc.init_paged_cache(tc, n_pages, ps, 3, kv_dtype=kv_dtype,
                                  device="cpu")
    tok = np.zeros((3,), np.int32)
    dense = []
    for b, (p, e) in enumerate(zip(prompts, embs)):
        batch = {"tokens": jnp.asarray(p)[None],
                 "frontend_emb": jnp.asarray(e)[None]}
        jl, jkv = jlm.prefill(jp, batch, jc)
        _, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(p)[None],
                                 "frontend_emb": torch.from_numpy(e)[None]},
                            tc)
        jcache = jpc.write_prefill(jc, jcache, jkv,
                                   jnp.asarray(table[b:b + 1]))
        # int8 pools take JAX's stacks: a last-bit difference between the
        # two prefills can move a value across an int8 rounding step
        tpc.write_prefill(tc, tcache, tkv if kv_dtype == "bf16" else tuple(
            torch.from_numpy(np.array(t)) for t in jkv), table[b:b + 1])
        dense.append(pad_cache_from_prefill(tc, tkv, 1, F + len(p) + steps))
        tok[b] = int(jnp.argmax(jl[0]))
    lens = np.array([F + 5, F + 9, 0], np.int32)
    jstep = jax.jit(lambda p, b: jlm.paged_decode_step(p, b, jc))
    for i in range(steps):
        jl, jcache = jstep(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.asarray(lens),
            "block_table": jnp.asarray(table), "cache": jcache})
        tl, tcache = lm.decode_step(tp, {
            "token": tok, "cur_len": lens, "block_table": table,
            "cache": tcache}, tc)
        _close(tl.numpy()[:2], np.asarray(jl)[:2], f"step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[:2], want[:2])
        if kv_dtype == "bf16":
            for b in range(2):
                dl, dense[b] = lm.decode_step(tp, {
                    "token": torch.from_numpy(tok[b:b + 1]),
                    "cur_len": int(lens[b]), "cache": dense[b]}, tc)
                _close(tl.numpy()[b], dl.numpy()[0], f"step {i} dense")
        tok = np.where(lens > 0, want, 0).astype(np.int32)
        lens = lens + (lens > 0)


@pytest.mark.parametrize("paged,kv_dtype", [(False, "bf16"), (True, "bf16"),
                                            (True, "int8")],
                         ids=["dense", "paged", "paged-int8"])
def test_generate_matches_jax(paged, kv_dtype):
    """Greedy ``generate`` with the frontend in the batch: the JAX
    engine's tokens, on the dense cache and on bf16 / int8 pools (the
    kernel backend, plain versions on the CPU)."""
    B, P, GEN = 2, 6, 5
    jc, tc = _cfgs()
    ekw = dict(batch=B, max_len=tc.frontend_tokens + P + GEN)
    if paged:
        ekw.update(paged=True, page_size=4, kv_dtype=kv_dtype)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_mesh())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (B, P)).astype(np.int32)
    emb = _emb(rng, jc, B)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks),
                             "frontend_emb": jnp.asarray(emb)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    assert eng.prefill_len({"tokens": toks}) == tc.frontend_tokens + P
    got, _ = eng.generate({"tokens": toks, "frontend_emb": emb}, gen=GEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (prompt length, gen): 2 slots and 9 pages of 4; the frontend's 8
# positions count against the pages, so growth preempts a request, which
# prefills its frontend again at re-admission
STREAM = [(3, 9), (5, 8), (6, 5)]


def _stream(sched_cls, req_cls, eng, cfg):
    rng = np.random.default_rng(3)
    reqs = [req_cls(rid=i, tokens=rng.integers(0, cfg.vocab, p).astype(
        np.int32), gen=g, frontend_emb=_emb(rng, cfg))
        for i, (p, g) in enumerate(STREAM)]
    sched = sched_cls(eng)
    sched.submit(reqs[0])
    sched.admit()
    sched.step()
    for r in reqs[1:]:
        sched.submit(r)
    return sched.run(), sched


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_scheduler_stream_matches_jax(kv_dtype):
    """A vlm Scheduler stream with one preemption: the JAX Scheduler's
    greedy streams and its counters (prefills, preemptions, steps, peak
    pages, table widths)."""
    jc, tc = _cfgs()
    ekw = dict(batch=2, max_len=tc.frontend_tokens + 16, paged=True,
               page_size=4, n_pages=9, kv_dtype=kv_dtype)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_mesh())
    want, jsched = _stream(JScheduler, JRequest, jeng, jc)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    got, sched = _stream(Scheduler, Request, eng, tc)
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].status is RequestStatus.FINISHED
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    for key in ("preempted", "prefills", "steps", "peak_pages",
                "table_widths"):
        assert sched.stats[key] == jsched.stats[key], key
    assert sched.stats["preempted"] > 0
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()


def test_frontend_positions_count_against_the_budget():
    """A prompt whose frontend + tokens + gen pass max_len is REJECTED,
    where the tokens alone would fit."""
    _, tc = _cfgs()
    eng = DecodeEngine(tc, EngineConfig(batch=1, max_len=12, paged=True,
                                        page_size=4), device="cpu")
    sched = Scheduler(eng)
    rng = np.random.default_rng(0)
    sched.submit(Request(rid=0, tokens=np.arange(4, dtype=np.int32),
                         gen=2, frontend_emb=_emb(rng, tc)))
    res = sched.run()[0]
    assert res.status is RequestStatus.REJECTED
    assert "exceeds engine max_len" in res.error


def test_prefix_and_chunks_are_refused():
    """Frontend positions cannot be matched by a token-keyed prefix, so
    the prefix cache and chunked prefill refuse the vlm family, as in the
    JAX package."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="token-only"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=16, paged=True,
                                      page_size=4, prefix_cache=True),
                     device="cpu")
    with pytest.raises(ValueError, match="token-only"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=16, paged=True,
                                      page_size=4, chunked_prefill=True,
                                      chunk_tokens=4), device="cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=1, max_len=16, paged=True,
                                        page_size=4), device="cpu")
    assert eng.suffix_prefill_fn is None and eng.mixed_fn is None
    for mode in ("prefix_cache", "chunked_prefill"):
        with pytest.raises(ValueError, match="token-only"):
            Scheduler(eng, **{mode: True})
    with pytest.raises(ValueError, match="token-only"):
        lm.prefill_suffix(eng.params, {"tokens": torch.zeros(1, 2),
                                       "pages": np.zeros(1, np.int32),
                                       "cache": eng.init_paged_cache()},
                          tc)
