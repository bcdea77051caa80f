"""The port's AdamW (``repro_torch.optim``), data pipeline
(``repro_torch.data``), the checkpoint store and the bridge on training
state, against the JAX package.

AdamW: ``update`` against JAX's over 3 steps (fp32 state; bf16 params
with bf16 moments and fp32 master copies), with the global-norm clip
active; ``schedule`` at its corners; the JAX package's optimizer tests
(``tests/test_checkpoint_data_optim.py``) ported.  fp32: 1e-6 of each
leaf's scale (both run the same fp32 operations in the same order;
XLA may fuse them differently); bf16 parameters and moments: one bf16
rounding (2^-8) of the scale.  Data: SyntheticLM, ``pack_documents``
and ``MemmapTokens`` batches bitwise JAX's.  Checkpoints: the store's
key lists for ``{"params", "opt"}`` equal the JAX store's; a JAX-written
training checkpoint resumes in the port and the port's next step
matches JAX's (held as ``test_torch_train_step.hold_params`` holds a
step); a port-written one restores in the JAX store.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.checkpoint.store import _leaf_paths as jleaf_paths  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch.steps import build_train_step as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import _leaf_paths  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.data import (DataConfig, MemmapTokens,  # noqa: E402
                              Prefetcher, SyntheticLM, pack_documents)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import lm, ssm, xlstm  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402
from test_torch_train_step import hold_params  # noqa: E402


def _tree(rng, dtype):
    """A small parameter tree (nested dicts, a stacked leaf)."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": {"table": a(16, 8)},
            "layers": {"w": a(3, 8, 8), "norm": {"scale": a(3, 8)}},
            "bias": a(5)}, dtype


def _to(tree, dtype):
    return {k: (_to(v, dtype) if isinstance(v, dict)
                else torch.from_numpy(v).to(dtype))
            for k, v in tree.items()}


def _jto(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def _jflat(tree):
    return {tuple(str(getattr(p, "key", getattr(p, "name", p)))
                  for p in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_update_matches_jax(kind):
    """3 AdamW steps from the same grads: parameters, moments, master
    copies, step and metrics; the clip is active (grad norm > 1)."""
    bf16 = kind == "bf16"
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
              moment_dtype="bfloat16" if bf16 else "float32")
    jcfg, tcfg = jadamw.OptConfig(**kw), OptConfig(**kw)
    rng = np.random.default_rng(0)
    base, _ = _tree(rng, None)
    jp, tp = _jto(base, jdt), _to(base, tdt)
    jst, tst = jadamw.init(jcfg, jp), adamw.init(tcfg, tp)
    assert (tst.master is None) == (jst.master is None) == (not bf16)
    tol = 2 ** -8 if bf16 else 1e-6
    for s in range(3):
        g, _ = _tree(np.random.default_rng(10 + s), None)
        g = jax.tree.map(lambda x: 3 * x, g)
        jp, jst, jm = jadamw.update(jcfg, _jto(g, jdt), jst, jp)
        tp, tst, tm = adamw.update(tcfg, _to(g, tdt), tst, tp)
        assert float(jm["grad_norm"]) > jcfg.grad_clip
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        _close(tm["lr"], jm["lr"], 1e-6, "lr")
        assert int(tst.step) == int(jst.step) == s + 1
        assert tst.step.dtype == torch.int32
        for name in ("m", "v", "master"):
            want = getattr(jst, name)
            if want is None:
                continue
            want = _jflat(want)
            for k, t in leaves(getattr(tst, name)):
                assert t.dtype == {"m": tdt, "v": tdt}.get(
                    name, torch.float32), (name, k)
                _close(t, want[k], tol, (s, name, k))
        want = _jflat(jp)
        for k, t in leaves(tp):
            assert t.dtype == tdt
            _close(t, want[k], tol, (s, "params", k))


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 120])
def test_schedule_matches_jax(step):
    """Step 0, mid-warmup, the warmup's end, mid-decay, the end and past
    it."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = jadamw.schedule(jadamw.OptConfig(**kw), jnp.int32(step))
    got = adamw.schedule(OptConfig(**kw), torch.tensor(step,
                                                       dtype=torch.int32))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6, step)


def test_global_norm_matches_jax():
    base, _ = _tree(np.random.default_rng(4), None)
    _close(adamw.global_norm(_to(base, torch.float32)),
           jadamw.global_norm(_jto(base, jnp.float32)), 1e-6, "norm")


# ------------------------------------ the JAX package's optimizer tests

def test_adamw_converges_quadratic():
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, grad_clip=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    st = adamw.init(cfg, params)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, st, _ = adamw.update(cfg, g, st, params)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_bf16_moments_master():
    cfg = OptConfig(lr=0.01, warmup_steps=0, total_steps=10,
                    moment_dtype="bfloat16")
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    st = adamw.init(cfg, params)
    assert st.m["w"].dtype == torch.bfloat16
    assert st.master["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    params, st, m = adamw.update(cfg, g, st, params)
    assert params["w"].dtype == torch.bfloat16
    assert np.isfinite(float(m["grad_norm"]))


def test_grad_clip():
    cfg = OptConfig(lr=0.0, warmup_steps=0, total_steps=10,
                    grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((3,))}
    st = adamw.init(cfg, params)
    g = {"w": torch.full((3,), 100.0)}
    _, _, m = adamw.update(cfg, g, st, params)
    assert float(m["grad_norm"]) > 100


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    s0, s10, s100 = (float(adamw.schedule(cfg, s)) for s in (0, 10, 100))
    assert s0 < 0.2 and abs(s10 - 1.0) < 0.01 and abs(s100 - 0.1) < 0.01


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_batches_are_jax_bitwise(shards):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, n_shards=shards,
              seed=3)
    mine, ref = SyntheticLM(DataConfig(**kw)), jdata.SyntheticLM(
        jdata.DataConfig(**kw))
    for step in (0, 7):
        for shard in range(shards):
            a, b = mine.batch(step, shard), ref.batch(step, shard)
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert next(iter(mine))["tokens"].tolist() == \
        ref.batch(0)["tokens"].tolist()


def test_synthetic_determinism():
    d = SyntheticLM(DataConfig(vocab=1000, seq_len=64, global_batch=8,
                               n_shards=2))
    np.testing.assert_array_equal(d.batch(7, shard=1)["tokens"],
                                  d.batch(7, shard=1)["tokens"])
    assert not np.array_equal(d.batch(7, 1)["tokens"],
                              d.batch(8, 1)["tokens"])
    b = SyntheticLM(DataConfig(vocab=1000, seq_len=64,
                               global_batch=8)).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="n_shards"):
        SyntheticLM(DataConfig(vocab=10, seq_len=4, global_batch=3,
                               n_shards=2))


def test_pack_and_memmap_are_jax_bitwise(tmp_path):
    docs = [[5, 6, 7], [9] * 10, [3, 4], [8] * 5]
    rows = pack_documents(docs, seq_len=8, eos_id=1)
    np.testing.assert_array_equal(
        rows, jdata.pack_documents(docs, seq_len=8, eos_id=1))
    assert rows.dtype == np.int32 and rows.shape[1] == 8
    flat = np.concatenate([rows.reshape(-1), np.zeros(1, np.int32)])
    path = str(tmp_path / "toks.bin")
    flat.astype(np.int32).tofile(path)
    kw = dict(vocab=16, seq_len=4, global_batch=2)
    mm = MemmapTokens(path, DataConfig(**kw))
    ref = jdata.MemmapTokens(path, jdata.DataConfig(**kw))
    assert mm.n_steps == ref.n_steps
    for step in range(mm.n_steps + 1):
        a, b = mm.batch(step), ref.batch(step)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    b = mm.batch(0)
    assert (b["loss_mask"][b["tokens"] == 1] == 0).all()


def test_prefetcher():
    pf = Prefetcher(iter([{"x": i} for i in range(5)]), depth=2)
    assert [b["x"] for b in pf] == list(range(5))
    pf.t.join(timeout=10)
    assert not pf.t.is_alive()


def test_data_and_optim_import_no_torch_cuda_or_jax():
    """``data/pipeline.py`` imports the standard library and numpy only."""
    import ast
    import repro_torch.data.pipeline as mod
    tree = ast.parse(inspect.getsource(mod))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "queue", "threading", "dataclasses",
                     "typing", "numpy"}, names


# ------------------------------------------- training state on disk

def _train_cfgs():
    j = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"))
    t = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        kernel_impl="torch")
    return j, t


@pytest.mark.parametrize("bf16", [False, True])
def test_training_checkpoint_keys_match_jax(bf16):
    """{"params", "opt"}: the port's store keys are the JAX store's, in
    the same order (``opt/.step``, ``opt/.m/...``, ``opt/.v/...``,
    ``opt/.master/...`` when the params are bf16, ``params/...``)."""
    j, t = _train_cfgs()
    if bf16:
        j, t = j.replace(dtype="bfloat16"), t.replace(dtype="bfloat16")
    jp = jlm.init(j, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jkeys = list(jleaf_paths({"params": jp, "opt": jadamw.init(
        jadamw.OptConfig(), jp)}))
    tkeys = list(_leaf_paths({"params": tp, "opt": adamw.init(
        OptConfig(), tp)}))
    assert tkeys == jkeys
    assert tkeys[0] == "opt/.step"
    assert any(k.startswith("opt/.master/") for k in tkeys) == bf16


def _jstate(j, n_steps):
    """JAX params + OptState after ``n_steps`` jitted train steps."""
    oc = jadamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jp = jlm.init(j, jax.random.PRNGKey(0))
    jo = jadamw.init(oc, jp)
    step = jax.jit(jbuild(j, oc))
    get = train.make_batch_fn(j, 2, 32)
    for s in range(n_steps):
        jp, jo, _ = step(jp, jo, {k: jnp.asarray(v)
                                  for k, v in get(s).items()})
    return oc, step, get, jp, jo


def test_jax_training_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX-written {"params", "opt"} checkpoint (reduced fp32, master
    None) restores bit for bit into fresh port tensors, and the port's
    next step matches JAX's next step (``hold_params``)."""
    j, t = _train_cfgs()
    oc, jstep, get, jp, jo = _jstate(j, 2)
    assert jo.master is None
    JStore(str(tmp_path)).save(2, {"params": jp, "opt": jo})
    toc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tp = lm.init(t, seed=1, device="cpu")
    to = adamw.init(toc, tp)
    CheckpointStore(str(tmp_path)).restore(2, {"params": tp, "opt": to})
    assert int(to.step) == 2
    want = _jflat({"params": jp, "m": jo.m, "v": jo.v})
    for k, a in leaves({"params": tp, "m": to.m, "v": to.v}):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want[k]))
    jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                for k, v in get(2).items()})
    tp, to, tm = steps.build_train_step(t, toc)(tp, to, get(2))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])
    hold_params(tp, jax.tree.map(np.asarray, jp), float(jm["lr"]))


def test_port_training_checkpoint_restores_in_jax(tmp_path):
    """The port's {"params", "opt"} after 2 steps reads in the JAX store
    bit for bit, OptState and all."""
    _, t = _train_cfgs()
    toc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tp = lm.init(t, seed=0, device="cpu")
    to = adamw.init(toc, tp)
    step = steps.build_train_step(t, toc)
    get = train.make_batch_fn(t, 2, 32)
    for s in range(2):
        tp, to, _ = step(tp, to, get(s))
    CheckpointStore(str(tmp_path)).save(2, {"params": tp, "opt": to})
    spec = {"params": jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(tuple(a.shape), jnp.float32), tp),
        "opt": jadamw.OptState(
            step=jax.ShapeDtypeStruct((), jnp.int32),
            m=jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                tuple(a.shape), jnp.float32), to.m),
            v=jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                tuple(a.shape), jnp.float32), to.v), master=None)}
    out = JStore(str(tmp_path)).restore(2, spec)
    assert int(out["opt"].step) == 2
    want = _jflat({"params": out["params"], "m": out["opt"].m,
                   "v": out["opt"].v})
    for k, a in leaves({"params": tp, "m": to.m, "v": to.v}):
        np.testing.assert_array_equal(np.asarray(want[k]), a.numpy())


# ------------------------------------------- the bridge, state builders

def test_bridge_makes_the_ports_namedtuples():
    """JAX NamedTuples (OptState, the recurrent states) become the port's
    own classes; a NamedTuple the port lacks raises."""
    j = jconfigs.reduced(jconfigs.get_config("zamba2-1.2b"))
    jp = {"w": jnp.ones((2, 3))}
    out = bridge.from_jax({
        "opt": jax.tree.map(np.asarray, jadamw.init(jadamw.OptConfig(), jp)),
        "mamba": jax.tree.map(np.asarray, jssm.init_state(j, 2)),
        "mlstm": jax.tree.map(np.asarray, jxlstm.mlstm_init_state(
            jconfigs.reduced(jconfigs.get_config("xlstm-350m")), 2)),
        "slstm": jax.tree.map(np.asarray, jxlstm.slstm_init_state(
            jconfigs.reduced(jconfigs.get_config("xlstm-350m")), 2))},
        "cpu")
    assert type(out["opt"]) is adamw.OptState
    assert type(out["mamba"]) is ssm.Mamba2State
    assert type(out["mlstm"]) is xlstm.MLSTMState
    assert type(out["slstm"]) is xlstm.SLSTMState
    assert out["opt"].master is None and out["opt"].step.dtype == torch.int32
    assert isinstance(out["mamba"].ssm, torch.Tensor)
    Other = dataclasses.make_dataclass  # noqa: F841  (a non-tuple is a leaf)
    from typing import NamedTuple

    class Foreign(NamedTuple):
        a: np.ndarray

    with pytest.raises(TypeError, match="no counterpart"):
        bridge.from_jax({"x": Foreign(np.zeros(1))}, "cpu")


@pytest.mark.parametrize("fn", [ssm.init_state, xlstm.mlstm_init_state,
                                xlstm.slstm_init_state],
                         ids=lambda f: f.__name__)
def test_state_builders_take_a_device(fn):
    """No CPU default: an entry point may not fall to the CPU unasked."""
    name = "zamba2-1.2b" if fn is ssm.init_state else "xlstm-350m"
    cfg = tconfigs.reduced(tconfigs.get_config(name))
    assert inspect.signature(fn).parameters["device"].default is \
        inspect.Parameter.empty
    with pytest.raises(TypeError):
        fn(cfg, 2)
    st = fn(cfg, 2, "cpu")
    assert all(f.device.type == "cpu" for f in st)
