"""The port's audio family (seamless-m4t-large-v2: an encoder-decoder
whose encoder reads projected frame embeddings, layernorm + relu FFNs,
MHA) against the JAX package.

Reduced fp32 config (2 encoder + 4 decoder layers, d 64, 4 heads, frames
of dim 32), JAX parameters through the bridge, inputs made with numpy
from a seed; encoder lengths off a page multiple.  Held: the parameter
tree, the encoder's output, prefill logits and the self and cross
stacks, dense decode steps (cross attention over the whole encoder
cache), paged decode steps over the identity-paged cross cache with
per-slot encoder lengths and an inactive slot (paged rows equal to the
dense ones, as JAX ``tests/test_paged.py``'s cross case pins), greedy
``generate`` and a Scheduler stream with one preemption against the JAX
engine and Scheduler, an encoder longer than the decoder budget (JAX
``tests/test_paged.py``'s regression), and the int8-pool, prefix-cache
and chunked-prefill refusals.

Tolerance: 1e-4 of the logits' scale (max |logit|, at least 1); greedy
tokens identical.  This random model amplifies fp32 rounding: by its
sixth decode step JAX's own fp32 logits lie 2.5e-4 of their scale from a
float64 evaluation of the same weights (the port's 1.1e-4), so the
decode steps held at 1e-4 against JAX are the first four.  The JAX side
runs its Pallas kernels in interpret mode and its engine on an explicit
(1, 1) mesh with Auto axes (ROADMAP queue 3).
"""
import functools

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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                Request, RequestStatus, Scheduler,
                                pad_cache_from_prefill)
from repro_torch.engine import paged_cache as tpc  # noqa: E402
from repro_torch.models import lm  # noqa: E402

NAME = "seamless-m4t-large-v2"
TOL = 1e-4
STEPS = 4


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


def _frames(rng, cfg, n, *lead):
    return rng.standard_normal((*lead, n, cfg.frontend_dim)).astype(
        np.float32)


def _jax_encode(jp, emb, jc):
    """The JAX backbone's encoder half (``lm.backbone``'s audio branch)."""
    enc = jlayers.frontend_proj(jp["frontend"], emb).astype(
        jnp.dtype(jc.dtype))
    body = functools.partial(jlm._dense_body, jc, jnp.arange(enc.shape[1]),
                             causal=False)
    enc, _ = jlm._scan_stack(jc, body, enc, jp["enc_layers"])
    return jlm._norm(jc, jp["enc_norm"], enc)


def test_spec_matches_jax():
    """``enc_layers``, ``enc_norm``, the decoder's ``self`` / ``cross``
    blocks and ``frontend``, leaf for leaf the JAX tree's shapes."""
    jc, tc = _cfgs()
    theirs = {tuple(k.key for k in path): tuple(a.shape) for path, a in
              jax.tree_util.tree_flatten_with_path(jlm.abstract_init(jc))[0]}
    mine = {path: tuple(d.shape) for path, d in leaves(lm.model_spec(tc))}
    assert mine == theirs
    assert ("enc_layers", "attn", "wq") in mine
    assert ("layers", "cross", "wk") in mine


@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_encoder_prefill_and_decode_match_jax(jimpl, timpl):
    """The encoder over 21 frames, the prefill of 6 decoder tokens
    (logits, self stacks (L, B, 6, ...), cross stacks (L, B, 21, ...)),
    then STEPS dense decode steps fed the JAX greedy tokens."""
    jc, tc = _cfgs(jimpl, timpl)
    jp, tp = _params(jc)
    rng = np.random.default_rng(0)
    B, P, F = 2, 6, 21
    toks = rng.integers(0, jc.vocab, (B, P)).astype(np.int32)
    emb = _frames(rng, jc, F, B)
    _close(lm.encode(tp, torch.from_numpy(emb), tc).numpy(),
           _jax_encode(jp, jnp.asarray(emb), jc), "encoder output")
    jl, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                               "frontend_emb": jnp.asarray(emb)}, jc)
    tl, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(toks),
                              "frontend_emb": torch.from_numpy(emb)}, tc)
    _close(tl.numpy(), jl, "prefill logits")
    (k, v), (xk, xv) = tkv
    assert k.shape == (tc.n_layers, B, P, tc.n_kv_heads, tc.d_head)
    assert xk.shape == (tc.n_layers, B, F, tc.n_kv_heads, tc.d_head)
    for t, j in zip((k, v, xk, xv), (*jkv[0], *jkv[1])):
        _close(t.numpy(), j, "prefill stacks")
    jcache = jpad(jc, jkv, B, P + STEPS, enc_len=F)
    tcache = pad_cache_from_prefill(tc, tkv, B, P + STEPS, enc_len=F)
    assert tcache["cross_k"].shape[2] == F
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(STEPS):
        jl, jcache = jlm.decode_step(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
            "cache": jcache}, jc)
        tl, tcache = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": P + i,
            "cache": tcache}, tc)
        _close(tl.numpy(), jl, f"decode step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want


@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_paged_decode_step_matches_jax_and_dense(jimpl, timpl):
    """Slots 0 and 2 prefilled batch 1 (decoder prompts 5 and 3, 13 and
    7 frames) into permuted pages and cross rows, slot 1 inactive
    (enc_lens 0), a cross cache of 16 positions a slot (4 pages of 4):
    STEPS paged steps against the JAX paged step, each active row equal
    to the port's dense decode of that request alone."""
    jc, tc = _cfgs(jimpl, timpl)
    jp, tp = _params(jc)
    rng = np.random.default_rng(9)
    ps, n_pages, J, enc_len = 4, 16, 3, 16
    spec = {0: (5, 13), 2: (3, 7)}
    table = np.zeros((3, J), np.int32)
    table[[0, 2]] = rng.permutation(n_pages)[:2 * J].reshape(2, J)
    jcache = jpc.init_paged_cache(jc, n_pages, ps, 3, enc_len=enc_len)
    tcache = tpc.init_paged_cache(tc, n_pages, ps, 3, enc_len=enc_len,
                                  device="cpu")
    assert tcache["cross_k"].shape == (tc.n_layers, 3, enc_len,
                                       tc.n_kv_heads, tc.d_head)
    tok, lens, enc_lens = (np.zeros((3,), np.int32) for _ in range(3))
    dense = {}
    for b, (P, F) in spec.items():
        p = rng.integers(0, jc.vocab, (1, P)).astype(np.int32)
        e = _frames(rng, jc, F, 1)
        jl, jkv = jlm.prefill(jp, {"tokens": jnp.asarray(p),
                                   "frontend_emb": jnp.asarray(e)}, jc)
        _, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(p),
                                 "frontend_emb": torch.from_numpy(e)}, tc)
        jcache = jpc.write_prefill(jc, jcache, jkv,
                                   jnp.asarray(table[b:b + 1]),
                                   enc_caches_slots=[b])
        tpc.write_prefill(tc, tcache, tkv, table[b:b + 1], enc_slots=[b])
        dense[b] = pad_cache_from_prefill(tc, tkv, 1, P + STEPS, enc_len=F)
        tok[b], lens[b], enc_lens[b] = int(jnp.argmax(jl[0])), P, F
    jstep = jax.jit(lambda p, b: jlm.paged_decode_step(p, b, jc))
    for i in range(STEPS):
        jl, jcache = jstep(jp, {
            "token": jnp.asarray(tok), "cur_len": jnp.asarray(lens),
            "block_table": jnp.asarray(table), "cache": jcache,
            "enc_lens": jnp.asarray(enc_lens)})
        tl, tcache = lm.decode_step(tp, {
            "token": tok, "cur_len": lens, "block_table": table,
            "cache": tcache, "enc_lens": enc_lens}, tc)
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        for b in spec:
            _close(tl.numpy()[b], np.asarray(jl)[b], f"step {i} slot {b}")
            assert int(tl[b].argmax()) == want[b]
            dl, dense[b] = lm.decode_step(tp, {
                "token": torch.from_numpy(tok[b:b + 1]),
                "cur_len": int(lens[b]), "cache": dense[b]}, tc)
            _close(tl.numpy()[b], dl.numpy()[0], f"step {i} slot {b} dense")
        tok = np.where(lens > 0, want, 0).astype(np.int32)
        lens = lens + (lens > 0)


def test_paged_step_meta_carries_the_cross_counts():
    """The encoder lengths ride the step's one metadata copy as per-page
    counts, 16-byte aligned like the other views, and the identity
    table is built once per (slots, pages, device)."""
    meta = lm.paged_step_meta(np.arange(3, dtype=np.int32) + 5,
                              np.array([4, 0, 9], np.int32),
                              np.arange(9, dtype=np.int32).reshape(3, 3),
                              4, torch.device("cpu"),
                              enc_lens=np.array([13, 0, 16]), enc_pages=4)
    np.testing.assert_array_equal(meta.cross_counts.numpy(),
                                  [[4, 4, 4, 1], [0, 0, 0, 0],
                                   [4, 4, 4, 4]])
    assert meta.cross_counts.data_ptr() % 16 == 0
    np.testing.assert_array_equal(meta.token.numpy(), [5, 6, 7])
    a = lm.identity_table(3, 4, torch.device("cpu"))
    assert a is lm.identity_table(3, 4, torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), np.arange(12).reshape(3, 4))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_generate_matches_jax(paged):
    """Greedy ``generate`` with 19 encoder frames and 5 decoder tokens:
    the JAX engine's tokens, on the dense cache and on the paged pools
    (kernel backend, plain versions on the CPU)."""
    B, P, F, GEN = 2, 5, 19, 4
    jc, tc = _cfgs()
    ekw = dict(batch=B, max_len=P + GEN)
    if paged:
        ekw.update(paged=True, page_size=4)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_mesh())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (B, P)).astype(np.int32)
    emb = _frames(rng, jc, F, B)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks),
                             "frontend_emb": jnp.asarray(emb)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    got, _ = eng.generate({"tokens": toks, "frontend_emb": emb}, gen=GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (decoder prompt, gen, encoder frames): 2 slots, 5 pages of 4, encoder
# lengths 9-18 under a cross budget of 20 (padded to 20); growth preempts
STREAM = [(3, 8, 18), (6, 6, 9), (4, 4, 13)]


def _stream(sched_cls, req_cls, eng, cfg, **kw):
    rng = np.random.default_rng(3)
    reqs = [req_cls(rid=i, tokens=rng.integers(0, cfg.vocab, p).astype(
        np.int32), gen=g, frontend_emb=_frames(rng, cfg, f))
        for i, (p, g, f) in enumerate(STREAM)]
    sched = sched_cls(eng, **kw)
    sched.submit(reqs[0])
    sched.admit()
    sched.step()
    for r in reqs[1:]:
        sched.submit(r)
    return sched.run(), sched


def test_scheduler_stream_matches_jax():
    """An audio Scheduler stream (``enc_len=20``, per-slot encoder
    lengths) with one preemption: the JAX Scheduler's greedy streams, its
    counters and its encoder budget."""
    jc, tc = _cfgs()
    ekw = dict(batch=2, max_len=16, paged=True, page_size=4, n_pages=5)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_mesh())
    want, jsched = _stream(JScheduler, JRequest, jeng, jc, enc_len=20)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    got, sched = _stream(Scheduler, Request, eng, tc, enc_len=20)
    assert sched.enc_budget == jsched.enc_budget == 20
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
    assert not sched.enc_lens.any()
    sched.allocator.check()


def test_scheduler_encoder_longer_than_decoder_budget():
    """40 encoder frames against a decoder max_len of 8: with
    ``enc_len=40`` the stream equals each request's solo ``generate``;
    a Scheduler whose budget is 8 rejects the request, naming the
    budget, instead of crashing at admission."""
    _, tc = _cfgs()
    P, GEN, F = 4, 4, 40
    eng = DecodeEngine(tc, EngineConfig(batch=2, max_len=P + GEN,
                                        paged=True, page_size=4),
                       device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, tc.vocab, P).astype(
        np.int32), gen=GEN, frontend_emb=_frames(rng, tc, F))
        for i in range(2)]
    sched = Scheduler(eng, enc_len=F)
    for r in reqs:
        sched.submit(r)
    out = sched.run()
    solo = DecodeEngine(tc, EngineConfig(batch=1, max_len=P + GEN),
                        params=eng.params, device="cpu")
    for r in reqs:
        want, _ = solo.generate({"tokens": r.tokens[None],
                                 "frontend_emb": r.frontend_emb[None]},
                                gen=GEN)
        np.testing.assert_array_equal(out[r.rid], want[0].numpy())
    over = Scheduler(eng, enc_len=8)
    over.submit(reqs[0])
    res = over.run()[reqs[0].rid]
    assert res.status is RequestStatus.REJECTED
    assert "encoder frames exceed" in res.error


def test_int8_prefix_and_chunks_are_refused():
    """int8 pools (the slot-dense cross cache stays at the model dtype),
    the prefix cache, chunked prefill and ``fork_page`` refuse the audio
    family with ``ValueError``, as in the JAX package."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="audio"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8, paged=True,
                                      page_size=4, kv_dtype="int8"),
                     device="cpu")
    with pytest.raises(ValueError, match="audio family"):
        tpc.paged_cache_spec(tc, 4, 4, 1, 8, kv_dtype="int8")
    for mode in (dict(prefix_cache=True),
                 dict(chunked_prefill=True, chunk_tokens=4)):
        with pytest.raises(ValueError, match="token-only"):
            DecodeEngine(tc, EngineConfig(batch=1, max_len=8, paged=True,
                                          page_size=4, **mode),
                         device="cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=1, max_len=8, paged=True,
                                        page_size=4), device="cpu")
    for mode in ("prefix_cache", "chunked_prefill"):
        with pytest.raises(ValueError, match="token-only"):
            Scheduler(eng, **{mode: True})
    with pytest.raises(ValueError, match="audio family"):
        tpc.fork_page(tc, eng.init_paged_cache(), 0, 1)
