"""The port's dense model against the JAX model: reduced tinyllama (GQA,
G = 4, untied) and qwen (QKV bias, MHA, tied) in fp32, prefill logits
plus 8 greedy decode steps, for JAX 'xla' vs the port's 'torch' and JAX
'pallas' (interpret mode) vs the port's 'cuda' (on the CPU its kernel
wrappers run their plain versions).

Tolerance: 1e-4 of the logits' scale (max |logit|, at least 1), the
Pallas-vs-XLA figure of the JAX package.  It is relative to the scale
because fp32 rounding is: at these shapes the JAX 'xla' logits are
themselves up to 1.6e-4 from a float64 evaluation of the same model
(tinyllama, decode step 1, max |logit| ~4), the port's 4.2e-5.  Greedy
tokens must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.engine import pad_cache_from_prefill as jpad  # noqa: E402
from repro.engine import paged_cache as jpc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.engine import pad_cache_from_prefill  # noqa: E402
from repro_torch.engine import paged_cache as tpc  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = 1e-4
B, P, STEPS = 2, 16, 8


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, f"{what}: max|d| {err:.3g} > {TOL * scale:.3g}"


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-0.5b"])
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
    _close(tl.numpy(), jl, "prefill logits")
    for t, j in zip(tkv, jkv):          # the per-layer KV stacks
        _close(t.numpy(), j, "prefill kv")

    max_len = P + STEPS
    jcache = jpad(jc, jkv, B, max_len)
    tcache = pad_cache_from_prefill(tc, tkv, B, max_len)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(STEPS):
        jl, jcache = jlm.decode_step(params, {
            "token": jnp.asarray(tok), "cur_len": jnp.int32(P + i),
            "cache": jcache}, jc)
        tl, tcache = lm.decode_step(tp, {
            "token": torch.from_numpy(tok), "cur_len": P + i,
            "cache": tcache}, tc)
        _close(tl.numpy(), jl, f"decode step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want
    _close(tcache["k"].numpy(), jcache["k"], "decode cache")


def test_padded_vocab_is_masked():
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        vocab=500)
    tp = lm.init(tc, seed=0, device="cpu")
    logits, _ = lm.prefill(tp, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                           tc)
    assert tc.vocab_padded == 512
    assert torch.all(logits[:, 500:] == -1e30)
    assert torch.all(logits[:, :500] > -1e29)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_prefill_suffix_matches_jax(name, kv_dtype):
    """The moe family's suffix prefill (the prefix cache's): reduced olmoe
    (GQA pools) and deepseek-v3 (MLA latent pools, a dense layer group
    first), a 9-token prompt's first two pages prefilled into the pools
    and its suffix through ``lm.prefill_suffix``, logits and both layer
    groups' suffix stacks against JAX's at 1e-4 of their scale."""
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab, 9).astype(
        np.int32)
    pages, M = np.asarray([3, 1], np.int32), 8
    jcache = jpc.write_prefill(
        jc, jpc.init_paged_cache(jc, 6, 4, 1, kv_dtype=kv_dtype),
        jlm.prefill(jp, {"tokens": jnp.asarray(toks[:M])[None]}, jc)[1],
        jnp.asarray(pages)[None])
    cache = tpc.init_paged_cache(tc, 6, 4, kv_dtype=kv_dtype, device="cpu")
    tpc.write_prefill(tc, cache, lm.prefill(
        tp, {"tokens": torch.from_numpy(toks[:M])[None]}, tc)[1],
        pages[None])
    want, (jd, jm) = jlm.prefill_suffix(
        jp, {"tokens": jnp.asarray(toks[M:])[None],
             "pages": jnp.asarray(pages), "cache": jcache}, jc)
    got, (d, m) = lm.prefill_suffix(
        tp, {"tokens": torch.from_numpy(toks[M:])[None], "pages": pages,
             "cache": cache}, tc)
    _close(got.numpy(), want, "logits")
    assert (d is None) == (jd is None) == (tc.moe.first_k_dense == 0)
    for g, w in zip((*(d or ()), *m), (*(jd or ()), *jm)):
        assert g.shape == w.shape
        _close(g.numpy(), w, "suffix stacks")


@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_families_refuse_paged(name):
    """The recurrent families serve through the dense engine's
    ``generate`` only (``test_torch_hybrid.py``, ``test_torch_xlstm.py``):
    their state is O(1) a slot, nothing to page.  The paged engine (and
    so the Scheduler), and the prefix cache and chunked prefill on either
    engine, refuse them with the JAX package's ``ValueError``, on both
    sides."""
    from jax.sharding import AxisType

    from repro.engine import DecodeEngine as JEngine
    from repro.engine import EngineConfig as JEngineConfig
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler

    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for kw, match in (
            (dict(paged=True, page_size=4), "recurrent state"),
            (dict(paged=True, page_size=4, kv_dtype="int8"),
             "recurrent state"),
            (dict(prefix_cache=True), "needs paged=True"),
            (dict(chunked_prefill=True, chunk_tokens=4), "needs paged=True"),
            (dict(paged=True, page_size=4, prefix_cache=True), "token-only"),
            (dict(paged=True, page_size=4, chunked_prefill=True,
                  chunk_tokens=4), "token-only")):
        with pytest.raises(ValueError, match=match):
            JEngine(jc, JEngineConfig(batch=1, max_len=16, **kw), mesh=mesh)
        with pytest.raises(ValueError, match=match):
            DecodeEngine(tc, EngineConfig(batch=1, max_len=16, **kw),
                         device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        tpc.init_paged_cache(tc, 4, 4, device="cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=1, max_len=16), device="cpu")
    assert eng.suffix_prefill_fn is None and eng.mixed_fn is None
    with pytest.raises(ValueError, match="paged engine"):
        Scheduler(eng)
    assert lm.ssm_decode_supported(tc) and jlm.ssm_decode_supported(jc)


@pytest.mark.parametrize("name", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_frontend_family_spec_and_prefill_match_jax(name):
    """The frontend families' spec (leaf shapes) and prefill (logits and
    every cache stack) against JAX: the vlm's 8 frontend tokens open its
    prompt, the audio encoder reads 11 frames."""
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    theirs = {tuple(k.key for k in path): tuple(a.shape) for path, a in
              jax.tree_util.tree_flatten_with_path(jlm.abstract_init(jc))[0]}
    from repro_torch.common.module import leaves
    assert {path: tuple(d.shape) for path, d in
            leaves(lm.model_spec(tc))} == theirs
    params = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, (B, 7)).astype(np.int32)
    n = jc.frontend_tokens if jc.family == "vlm" else 11
    emb = rng.standard_normal((B, n, jc.frontend_dim)).astype(np.float32)
    jl, jkv = jlm.prefill(params, {"tokens": jnp.asarray(toks),
                                   "frontend_emb": jnp.asarray(emb)}, jc)
    tl, tkv = lm.prefill(tp, {"tokens": torch.from_numpy(toks),
                              "frontend_emb": torch.from_numpy(emb)}, tc)
    _close(tl.numpy(), jl, "prefill logits")
    flat = jax.tree.leaves(jkv)
    got = [t for pair in (tkv if jc.family == "audio" else (tkv,))
           for t in pair]
    assert len(got) == len(flat)
    for t, j in zip(got, flat):
        assert t.shape == j.shape
        _close(t.numpy(), j, "prefill stacks")


def test_paged_and_seq_sharded_decode_raise():
    """``decode_shard='seq'`` without a mesh is the local step, as in
    JAX (the sharded steps run on a mesh of ranks:
    ``test_torch_dist_engine.py``): over the dense cache and over the
    page pools it gives the unsharded step's logits and cache writes,
    bit for bit.  The audio family's paged step is served too: one step
    over its self pools and cross cache."""
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    tp = lm.init(tc, seed=0, device="cpu")
    seq = tc.replace(decode_shard="seq")
    tok = torch.tensor([5], dtype=torch.int32)
    outs = []
    for cfg in (tc, seq):
        cache = lm.init_cache(cfg, 1, 8, device="cpu")
        outs.append(lm.decode_step(tp, {"token": tok, "cur_len": 0,
                                        "cache": cache}, cfg))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for name in ("k", "v"):
        assert outs[1][1][name][:, 0, 0].any()
        torch.testing.assert_close(outs[1][1][name], outs[0][1][name],
                                   rtol=0, atol=0)
    outs = []
    for cfg in (tc, seq):
        pools = tpc.init_paged_cache(cfg, 2, 4, device="cpu")
        outs.append(lm.decode_step(tp, {
            "token": np.zeros(1, np.int32), "cur_len": np.ones(1, np.int32),
            "block_table": np.zeros((1, 2), np.int32), "cache": pools},
            cfg))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    assert outs[1][1]["k"][:, 0, 1].any()
    torch.testing.assert_close(outs[1][1]["k"], outs[0][1]["k"], rtol=0,
                               atol=0)
    ac = tconfigs.reduced(tconfigs.get_config("seamless-m4t-large-v2"))
    ap = lm.init(ac, seed=0, device="cpu")
    pools = tpc.init_paged_cache(ac, 2, 4, 1, enc_len=4, device="cpu")
    pools["cross_k"].normal_()
    pools["cross_v"].normal_()
    logits, out = lm.decode_step(ap, {
        "token": np.zeros(1, np.int32), "cur_len": np.ones(1, np.int32),
        "block_table": np.zeros((1, 2), np.int32), "cache": pools,
        "enc_lens": np.full(1, 3, np.int32)}, ac)
    assert logits.shape == (1, ac.vocab_padded)
    assert bool(torch.isfinite(logits).all())
    assert out is pools and pools["self_k"][:, 0, 1].any()
