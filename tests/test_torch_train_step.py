"""The port's train step (``steps.build_train_step``: microbatched
gradient accumulation, AdamW, metrics), the JAX trainer's own tests
(``tests/test_train_integration.py``) ported, and the launcher
``launch.train`` (``width_reduce``, ``make_batch_fn``, ``main``).

Reduced fp32 configs (deepseek-v3 at capacity factor 4), JAX parameters
through the bridge, the launcher's batches (``make_batch_fn``) at B 4,
S 32.  ``build_train_step`` is held against JAX's step by step, each
step from JAX's (params, opt state) bridged in: two free-running fp32
trainings part as Adam's first steps turn fp32 gradient noise into
sign flips of near-zero gradient elements (tinyllama: 1.1e-3 of a
leaf's norm after 3 steps; ``test_torch_train.py`` gives the gradient
gaps), so free-running only deepseek-v3 is held, whose gradients agree
to 5e-5.  Parameters: ``hold_params`` (every element within 1e-5 of
its leaf's scale but for at most 1e-3 of them, flipped Adam steps of
near-zero gradient elements, none past 2.5 lr); the first moments 2e-3
of each leaf's norm (the gradient's tolerance); loss, ce, z-loss and lr
1e-5 relative; the gradient norm 2e-3.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import build_train_step as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfgs(name, **kw):
    """(JAX, port) reduced fp32 configs, the port's on 'torch'; the moe
    family at capacity factor 4 (no drops)."""
    j = jconfigs.reduced(jconfigs.get_config(name)).replace(**kw)
    t = tconfigs.reduced(tconfigs.get_config(name)).replace(
        kernel_impl="torch", **kw)
    if j.moe is not None:
        j = j.replace(moe=dataclasses.replace(j.moe, capacity_factor=4.0))
        t = t.replace(moe=dataclasses.replace(t.moe, capacity_factor=4.0))
    return j, t


def _jflat(tree):
    """{path tuple: numpy leaf} of a JAX tree, keyed as ``leaves``."""
    return {tuple(str(getattr(p, "key", getattr(p, "name", p)))
                  for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _opt():
    return (jadamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30),
            adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30))


def _hold_norm(got, want, tol):
    want = _jflat(want)
    for k, g in leaves(got):
        r = want[k]
        assert np.linalg.norm(g.numpy() - r) <= tol * np.linalg.norm(r), k


def hold_params(got, want, lr):
    """Parameters after Adam steps of total learning rate ``lr``: every
    element within 1e-5 of its leaf's scale, but for at most 1e-3 of
    them (a near-zero gradient element whose fp32 noise flips the sign
    of its Adam step; reduced tinyllama: <= 5.4e-4), and none farther
    than 2.5 lr (a flipped step moves 2 lr at most, 1.97 lr seen)."""
    want = _jflat(want)
    off = total = 0
    for k, g in leaves(got):
        d = np.abs(g.numpy() - want[k])
        off += int((d > 1e-5 * np.abs(want[k]).max()).sum())
        total += d.size
        assert d.max() <= 2.5 * lr, (k, d.max(), lr)
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("name,nm", [("tinyllama-1.1b", 1),
                                     ("deepseek-v3-671b", 1),
                                     ("deepseek-v3-671b", 2)])
def test_train_step_matches_jax(name, nm):
    """3 steps of ``build_train_step`` against JAX's, each from JAX's
    (params, opt state) bridged in: params, moments and metrics."""
    jc, tc = _cfgs(name, n_microbatches=nm)
    joc, toc = _opt()
    jstep = jax.jit(jbuild(jc, joc))
    tstep = steps.build_train_step(tc, toc)
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    jo = jadamw.init(joc, jp)
    get = train.make_batch_fn(tc, 4, 32)
    for s in range(3):
        b = get(s)
        tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
        to = bridge.from_jax({"o": jax.tree.map(np.asarray, jo)}, "cpu")["o"]
        assert isinstance(to, adamw.OptState)
        jp, jo, jm = jstep(jp, jo, _jbatch(b))
        tp, to, tm = tstep(tp, to, b)
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "z_loss", "lr"):
            assert _rel(tm[k], jm[k]) <= 1e-5, k
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 2e-3
        assert int(to.step) == int(jo.step) == s + 1
        hold_params(tp, jp, float(jm["lr"]))
        _hold_norm(to.m, jo.m, 2e-3)


def test_train_step_free_running_matches_jax():
    """deepseek-v3 (MLA, the moe aux losses, e_bias with a zero grad):
    3 free-running steps on both sides, held as ``hold_params``."""
    jc, tc = _cfgs("deepseek-v3-671b")
    joc, toc = _opt()
    jstep = jax.jit(jbuild(jc, joc))
    tstep = steps.build_train_step(tc, toc)
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    jo = jadamw.init(joc, jp)
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    to = adamw.init(toc, tp)
    get = train.make_batch_fn(tc, 4, 32)
    lr = 0.0
    for s in range(3):
        b = get(s)
        jp, jo, jm = jstep(jp, jo, _jbatch(b))
        tp, to, tm = tstep(tp, to, b)
        assert _rel(tm["loss"], jm["loss"]) <= 1e-5
        lr += float(jm["lr"])
    hold_params(tp, jp, lr)


# ---------------------------------------- the JAX trainer's own tests

def _setup(steps_=30):
    cfg = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        kernel_impl="torch")
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=steps_)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=4))
    step = steps.build_train_step(cfg, opt_cfg)
    params = lm.init(cfg, seed=0, device="cpu")
    return cfg, data, step, params, adamw.init(opt_cfg, params)


def test_loss_decreases():
    cfg, data, step, params, opt = _setup(steps_=50)
    losses = []
    for s in range(50):
        params, opt, m = step(params, opt, data.batch(s))
        losses.append(float(m["loss"]))
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    assert tail < head - 0.3, (head, tail)
    assert all(np.isfinite(x) for x in losses)


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def _nm_runs():
    cfg = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        kernel_impl="torch")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8))
    batch = data.batch(0)
    params = lm.init(cfg, seed=0, device="cpu")
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    for nm in (1, 4):
        p = _clone(params)
        out[nm] = steps.build_train_step(cfg.replace(n_microbatches=nm),
                                         opt_cfg)(
            p, adamw.init(opt_cfg, p), batch)
    return cfg, params, batch, out


def test_microbatch_accumulation_close_to_full_batch():
    """nm=4 grad accumulation ~= one big batch (same data)."""
    _, _, _, out = _nm_runs()
    p4 = dict(leaves(out[4][0]))
    d = max(float((p4[k] - a).abs().max()) for k, a in leaves(out[1][0]))
    assert d < 5e-5, d


def test_microbatch_metrics_average_all_microbatches():
    """Logged metrics under nm>1 equal the nm=1 metrics on the same
    batch, and the last microbatch's alone differ."""
    cfg, params, batch, out = _nm_runs()
    m1, m4 = out[1][2], out[4][2]
    assert set(m1) == set(m4)
    for k in ("ce", "z_loss", "loss"):
        np.testing.assert_allclose(float(m4[k]), float(m1[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    (_, last), _ = steps.value_and_grad(
        params, {k: v[6:] for k, v in batch.items()}, cfg)
    assert abs(float(last["ce"]) - float(m1["ce"])) > 1e-4


def test_checkpoint_resume_exact(tmp_path):
    """Stop at step 10, save, restore into fresh tensors, reach step 20
    bit for bit as an uninterrupted run."""
    cfg, data, step, params, opt = _setup()
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30)
    store = CheckpointStore(str(tmp_path))
    p_ref = _clone(params)
    o_ref = adamw.init(opt_cfg, p_ref)
    for s in range(20):
        p_ref, o_ref, _ = step(p_ref, o_ref, data.batch(s))
    p, o = params, opt
    for s in range(10):
        p, o, _ = step(p, o, data.batch(s))
    store.save(10, {"params": p, "opt": o})
    p2 = lm.init(cfg, seed=1, device="cpu")
    o2 = adamw.init(opt_cfg, p2)
    store.restore(10, {"params": p2, "opt": o2})
    assert int(o2.step) == 10
    for s in range(10, 20):
        p2, o2, _ = step(p2, o2, data.batch(s))
    p2 = dict(leaves(p2))
    for k, a in leaves(p_ref):
        assert torch.equal(p2[k], a), k


# ---------------------------------------------------------- the launcher

@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_width_reduce_and_batches_match_jax(name):
    """``width_reduce`` is field-equal to JAX's and ``make_batch_fn``'s
    batches (frontend embeddings included) bitwise JAX's."""
    j = jtrain.width_reduce(jconfigs.get_config(name))
    t = train.width_reduce(tconfigs.get_config(name))
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    jd.pop("kernel_impl"), td.pop("kernel_impl")
    assert td == jd
    jb = jtrain.make_batch_fn(j, 2, 64)(3)
    tb = train.make_batch_fn(t, 2, 64)(3)
    assert set(tb) == set(jb)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """--device cpu --reduce smoke: trains on kernel_impl='torch' (said in
    the header), checkpoints, writes --metrics-out; a second run resumes
    from the last step and goes on."""
    ck = str(tmp_path / "ck")
    args = ["--arch", "tinyllama-1.1b", "--reduce", "smoke", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt", ck,
            "--ckpt-every", "2", "--log-every", "1"]
    out1 = str(tmp_path / "m1.json")
    losses = train.main(args + ["--steps", "4", "--metrics-out", out1])
    text = capsys.readouterr().out
    assert "kernel_impl='torch'" in text.splitlines()[0]
    assert [s for s, _ in losses] == [0, 1, 2, 3]
    assert re.search(r"\[train\] done: .* tok/s", text)
    assert CheckpointStore(ck).steps() == [2, 4]
    rec = json.load(open(out1))
    assert rec["tok_per_s"] > 0 and len(rec["losses"]) == 4
    losses = train.main(args + ["--steps", "6"])
    text = capsys.readouterr().out
    assert "resumed from step 4" in text
    assert [s for s, _ in losses] == [4, 5]
    assert CheckpointStore(ck).latest_step() == 6


def test_launcher_refusals():
    """``--data-model 2 1`` trains over two gloo ranks and logs ``1 1``'s
    losses (1e-5 relative); a 'model' axis (tensor-parallel layers) is
    item 14; a recurrent sequence off the chunk raises, as the JAX
    launcher asserts."""
    args = ["--arch", "tinyllama-1.1b", "--reduce", "smoke", "--device",
            "cpu", "--batch", "4", "--seq", "32", "--steps", "3",
            "--log-every", "1"]
    one = train.main(args)
    two = train.main(args + ["--data-model", "2", "1"])
    assert [s for s, _ in two] == [s for s, _ in one] == [0, 1, 2]
    for (_, a), (_, b) in zip(two, one):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    with pytest.raises(NotImplementedError, match="item 14"):
        train.main(["--arch", "tinyllama-1.1b", "--reduce", "smoke",
                    "--device", "cpu", "--data-model", "1", "2"])
    with pytest.raises(ValueError, match="chunk"):
        train.main(["--arch", "zamba2-1.2b", "--reduce", "smoke",
                    "--device", "cpu", "--seq", "24"])
