"""The port's DecodeEngine against the JAX DecodeEngine: same greedy
tokens from the same parameters and prompts (mesh (1, 1), batch 2,
prompt 16, gen 8), the same input checks (the prefix-cache and chunked
prefill options included), the moe family's engine with those options
serving the JAX Scheduler's streams, and the options the port does not
serve yet refused.  The paged engine is in ``test_torch_paged.py``."""
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
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.engine import DecodeEngine, EngineConfig  # noqa: E402

B, P, GEN = 2, 16, 8


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfgs(name):
    return (jconfigs.reduced(jconfigs.get_config(name)),
            tconfigs.reduced(tconfigs.get_config(name)))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("timpl", ["torch", "cuda"])
def test_generate_matches_jax_engine(name, timpl):
    jc, tc = _cfgs(name)
    # the JAX engine's default mesh (jax.make_mesh) has Explicit axes
    # under JAX 0.9, which its embedding gather rejects; an explicit
    # (1, 1) mesh with Auto axes is the single-device layout
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(batch=B, max_len=P + GEN,
                                     mesh_shape=(1, 1)), mesh=mesh)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, P),
                                             dtype=np.int32)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)

    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=B, max_len=P + GEN,
                                        kernel_impl=timpl),
                       params=params, device="cpu")
    got, stats = eng.generate({"tokens": torch.from_numpy(toks)}, gen=GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"t_prefill_s", "t_decode_s", "prefill_tok_s",
                          "decode_tok_s"}


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "olmoe-1b-7b"])
def test_moe_generate_matches_jax_engine(name):
    """The moe family on the dense cache: reduced deepseek-v3 (MLA latent
    cache, kernel 10's plain version) and reduced olmoe (GQA), the
    port's 'cuda' backend against the JAX engine's greedy tokens."""
    jc, tc = _cfgs(name)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(batch=B, max_len=P + GEN,
                                     mesh_shape=(1, 1)), mesh=mesh)
    toks = np.random.default_rng(2).integers(0, jc.vocab, (B, P),
                                             dtype=np.int32)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(batch=B, max_len=P + GEN),
                       params=params, device="cpu")
    got, _ = eng.generate({"tokens": torch.from_numpy(toks)}, gen=GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(chunked_prefill=True, chunk_tokens=4)])
def test_moe_prefix_and_chunked_options_serve(kw):
    """A paged deepseek-v3 engine (the moe family with MLA latent pools)
    with the prefix cache or chunked prefill as its default carries the
    suffix prefill and the mixed step, and a Scheduler on it serves the
    JAX Scheduler's greedy streams, with the same counters, over two
    requests that share a two-page prompt; the JAX engine's ValueErrors
    still come first without ``paged``."""
    from repro.engine import Request as JRequest
    from repro.engine import Scheduler as JScheduler
    from repro_torch.engine import Request, Scheduler
    jc, tc = _cfgs("deepseek-v3-671b")
    ekw = dict(batch=2, max_len=20, paged=True, page_size=4, n_pages=12,
               **kw)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=mesh)
    eng = DecodeEngine(tc, EngineConfig(**ekw), params=bridge.from_jax(
        jax.tree.map(np.asarray, jeng.params), "cpu"), device="cpu")
    assert callable(eng.suffix_prefill_fn) and callable(eng.mixed_fn)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, jc.vocab, 8)
    prompts = [np.concatenate([shared, rng.integers(0, jc.vocab, n)])
               .astype(np.int32) for n in (2, 5)]
    outs = []
    for sched, req in ((JScheduler(jeng, bucket_tables=False), JRequest),
                       (Scheduler(eng, bucket_tables=False), Request)):
        for i, p in enumerate(prompts):
            sched.submit(req(rid=i, tokens=p, gen=4))
        outs.append((sched.run(), sched.stats))
    (want, jst), (got, st) = outs
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    for key in ("prefix_hits", "chunks", "mixed_steps", "prefills",
                "steps"):
        assert st[key] == jst[key], key
    assert st["prefix_hits" if "prefix_cache" in kw else "chunks"] > 0
    with pytest.raises(ValueError, match="needs paged=True"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8, **kw),
                     device="cpu")


def test_engine_rejects_overlong_generation_and_bad_batch():
    _, tc = _cfgs("tinyllama-1.1b")
    eng = DecodeEngine(tc, EngineConfig(batch=2, max_len=12), device="cpu")
    toks = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate({"tokens": toks}, gen=6)
    eng.generate({"tokens": toks}, gen=5)      # prompt + gen - 1 == max_len
    with pytest.raises(ValueError, match="batch"):
        eng.prefill({"tokens": torch.zeros(4, 8, dtype=torch.int32)})


def test_engine_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8))


@pytest.mark.parametrize("kw", [
    dict(paged=True, page_size=4, mesh_shape=(2, 1)),
    dict(paged=True, page_size=4, decode_shard="seq", prefix_cache=True)])
def test_unported_engine_options_raise(kw):
    """Sequence sharding and meshes are served now (the dense and moe
    families: ``test_torch_dist_engine.py``); a paged engine with a data
    axis and the prefix cache with ``decode_shard='seq'`` are not, and
    raise before a mesh or a parameter is made."""
    _, tc = _cfgs("tinyllama-1.1b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tc, EngineConfig(batch=2, max_len=8, **kw),
                     device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache=True), "prefix_cache=True needs paged=True"),
    (dict(chunked_prefill=True), "chunked_prefill=True needs paged=True"),
    (dict(paged=True, page_size=4, chunked_prefill=True, chunk_tokens=6),
     "positive multiple of page_size"),
    (dict(paged=True, page_size=4, chunked_prefill=True, chunk_tokens=0),
     "positive multiple of page_size"),
], ids=["prefix-dense", "chunked-dense", "chunk-not-page-multiple",
        "chunk-zero"])
def test_prefix_and_chunked_options_are_checked(kw, match):
    """The JAX engine's ValueErrors for the prefix-cache and chunked
    prefill options (``repro.engine.engine`` 134-164)."""
    _, tc = _cfgs("tinyllama-1.1b")
    with pytest.raises(ValueError, match=match):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8, **kw),
                     device="cpu")


@pytest.mark.parametrize("prefix,chunked", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_paged_engine_builds_suffix_and_mixed_steps(prefix, chunked):
    """Every paged dense engine carries the suffix prefill and the mixed
    step, whatever its defaults (a Scheduler turns the modes on per
    stream); the dense-cache engine carries neither."""
    _, tc = _cfgs("tinyllama-1.1b")
    eng = DecodeEngine(tc, EngineConfig(
        batch=1, max_len=8, paged=True, page_size=4, prefix_cache=prefix,
        chunked_prefill=chunked, chunk_tokens=4), device="cpu")
    assert callable(eng.suffix_prefill_fn) and callable(eng.mixed_fn)
    assert (eng.ecfg.prefix_cache, eng.ecfg.chunked_prefill) == (prefix,
                                                                 chunked)
    dense = DecodeEngine(tc, EngineConfig(batch=1, max_len=8),
                         device="cpu")
    assert dense.suffix_prefill_fn is None and dense.mixed_fn is None


def test_int8_kv_without_paged_raises():
    """As in the JAX engine: int8 pools need paged=True."""
    _, tc = _cfgs("tinyllama-1.1b")
    with pytest.raises(ValueError, match="requires paged=True"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8, kv_dtype="int8"),
                     device="cpu")


def test_engine_inherits_cfg_kernel_impl():
    _, tc = _cfgs("qwen1.5-0.5b")
    eng = DecodeEngine(tc.replace(kernel_impl="torch"),
                       EngineConfig(batch=1, max_len=8), device="cpu")
    assert eng.cfg.kernel_impl == "torch"
    eng2 = DecodeEngine(tc, EngineConfig(batch=1, max_len=8),
                        device="cpu")
    assert eng2.cfg.kernel_impl == "cuda"


def test_sampled_generate_is_deterministic_per_seed():
    """Sampled streams cannot match jax.random; they are pinned by the
    port's own determinism: same seed, same stream."""
    _, tc = _cfgs("qwen1.5-0.5b")
    eng = DecodeEngine(tc, EngineConfig(batch=2, max_len=24), device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 8), dtype=torch.int32)
    a, _ = eng.generate({"tokens": toks}, gen=12, temperature=1.0, seed=5)
    b, _ = eng.generate({"tokens": toks}, gen=12, temperature=1.0, seed=5)
    c, _ = eng.generate({"tokens": toks}, gen=12, temperature=1.0, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
