"""The port's DecodeEngine against the JAX DecodeEngine: same greedy
tokens from the same parameters and prompts (mesh (1, 1), batch 2,
prompt 16, gen 8), the same input checks, and the options the port does
not serve yet refused.  The paged engine is in ``test_torch_paged.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("kw", [dict(paged=True, prefix_cache=True),
                                dict(paged=True, chunked_prefill=True),
                                dict(prefix_cache=True),
                                dict(chunked_prefill=True),
                                dict(decode_shard="seq"),
                                dict(mesh_shape=(1, 2))])
def test_unported_engine_options_raise(kw):
    _, tc = _cfgs("tinyllama-1.1b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tc, EngineConfig(batch=1, max_len=8, **kw),
                     device="cpu")


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
