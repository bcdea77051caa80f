"""The JAX -> PyTorch parameter bridge and the port's own init: leaf
shapes and dtypes equal ``lm.abstract_init``; values cross exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import module as M  # noqa: E402
from repro_torch.models import lm  # noqa: E402

DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "granite-3-8b",
         "deepseek-coder-33b"]


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_layout(cfg):
    return {path: (tuple(a.shape), jnp.dtype(a.dtype).name)
            for path, a in _flat(jlm.abstract_init(cfg))}


def _torch_layout(tree):
    return {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for path, t in _flat(tree)}


@pytest.mark.parametrize("name", DENSE)
def test_bridge_matches_abstract_init(name):
    jc = jconfigs.reduced(jconfigs.get_config(name))
    params = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), "cpu")
    assert _torch_layout(tp) == _jax_layout(jc)
    for (path, t), (_, a) in zip(_flat(tp), _flat(params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), str(path))


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_abstract_init(name, dtype):
    jc = jconfigs.reduced(jconfigs.get_config(name)).replace(dtype=dtype)
    tc = tconfigs.reduced(tconfigs.get_config(name)).replace(dtype=dtype)
    tp = lm.init(tc, seed=0, device="cpu")
    assert _torch_layout(tp) == _jax_layout(jc)
    assert M.count_params(lm.model_spec(tc)) == sum(
        int(np.prod(s)) for s, _ in _jax_layout(jc).values())


def test_bf16_bridge_is_exact():
    x = jax.random.normal(jax.random.PRNGKey(1), (7, 5)).astype(jnp.bfloat16)
    t = bridge.to_torch(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


def test_init_is_seeded_and_uses_the_jax_inits():
    tc = tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b"))
    a = lm.init(tc, seed=3, device="cpu")
    b = lm.init(tc, seed=3, device="cpu")
    c = lm.init(tc, seed=4, device="cpu")
    for (_, x), (_, y), (_, z) in zip(_flat(a), _flat(b), _flat(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    lay = a["layers"]
    assert torch.all(lay["attn_norm"]["scale"] == 1)          # ones
    assert torch.all(lay["attn"]["bq"] == 0)                  # zeros
    assert abs(a["embed"]["table"].std().item() - 0.02) < 0.002
    wq = lay["attn"]["wq"]                                    # fan-in d
    assert abs(wq.std().item() - tc.n_heads ** -0.5) < 0.03


def test_init_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        lm.init(tc, seed=0)
