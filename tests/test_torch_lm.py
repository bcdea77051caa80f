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

from repro import configs as jconfigs  # noqa: E402
from repro.engine import pad_cache_from_prefill as jpad  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.engine import pad_cache_from_prefill  # noqa: E402
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


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b",
                                  "zamba2-1.2b", "xlstm-350m",
                                  "internvl2-2b", "seamless-m4t-large-v2"])
def test_unported_families_raise(name):
    tc = tconfigs.reduced(tconfigs.get_config(name))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        lm.model_spec(tc)


def test_paged_and_seq_sharded_decode_raise():
    """Paged decode is served now (``test_torch_paged.py``); what still
    raises is sequence-sharded decode, over the dense cache and over
    the page pools, and the paged pools of unported families."""
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    tp = lm.init(tc, seed=0, device="cpu")
    cache = lm.init_cache(tc, 1, 8, device="cpu")
    batch = {"token": torch.zeros(1, dtype=torch.int32), "cur_len": 0,
             "cache": cache}
    with pytest.raises(NotImplementedError, match="item 14"):
        lm.decode_step(tp, batch, tc.replace(decode_shard="seq"))
    paged = {"token": np.zeros(1, np.int32),
             "cur_len": np.ones(1, np.int32),
             "block_table": np.zeros((1, 2), np.int32),
             "cache": {"k": torch.zeros(tc.n_layers, 2, 4, tc.n_kv_heads,
                                        tc.d_head),
                       "v": torch.zeros(tc.n_layers, 2, 4, tc.n_kv_heads,
                                        tc.d_head)}}
    with pytest.raises(NotImplementedError, match="item 14"):
        lm.decode_step(tp, paged, tc.replace(decode_shard="seq"))
    # it raises before any pool write: the cache is left as it was
    assert not paged["cache"]["k"].any() and not paged["cache"]["v"].any()
    with pytest.raises(NotImplementedError, match="item 10"):
        lm.decode_step(tp, paged, tc.replace(family="moe"))
