"""Data-parallel training over gloo CPU ranks against the JAX package's
single-device training (JAX's own distributed tests are red, ROADMAP
queue 3, so the port is held to what one device computes on the global
batch).

One world of 2 ranks, reduced fp32 configs, B 4, S 32 from the
launcher's batches (``make_batch_fn``):

  * the (2, 1) train step with ZeRO-1 (``build_train_step(mesh=)``)
    from JAX's (params, opt state) bridged in, against JAX's
    ``build_train_step`` on the global batch: tinyllama and qwen with
    rank 1's rows half masked (the ranks' mask counts differ), qwen with
    ``n_microbatches`` 2, tinyllama with B 3 (the batch left whole on
    both ranks), olmoe at capacity factor 4; and the half-masked
    tinyllama step again with ZeRO-1 off (the whole state a rank).  Loss, ce, z-loss, the moe aux
    and lr within 1e-5 relative, the gradient norm 2e-3 (as the
    one-device test holds it) and 1e-4 of the port's one rank, parameters
    ``hold_params`` (every element within 1e-5 of its leaf's scale but
    for 1e-3 of them, flipped Adam steps of near-zero gradient
    elements); olmoe's ``lb_loss`` is JAX's global one, and the mean of
    the ranks' own ``lb_loss`` is not;
  * ZeRO-1's state after 2 steps: each rank's m / v blocks within 2e-3
    of each leaf's norm of ``local_block`` of the one-rank state, the
    master blocks of a bf16 init exactly the cast parameters, about 1/D
    of the state's bytes a rank;
  * ``compressed_psum`` against JAX's own under ``jax.vmap(...,
    axis_name="data")``: the int8 payloads equal, the means within
    1e-6, and JAX's two-step error-feedback contract;
  * ``pipeline_apply`` over a ``{"pipe": 2}`` mesh of the same ranks
    against the sequential composition with jnp stages, 1e-5;
  * the launcher's rank body (``launch.train._train_rank``) on (2, 1)
    with a checkpoint: its losses within 1e-5 of ``1 1``'s (run by rank
    0), ``1 1`` resumes from its checkpoint, and (2, 1) from a ``1 1``
    checkpoint, like an uninterrupted run (1e-4).

The ranks do the port's work, the one-rank references included, while
the test process takes JAX's steps; torch runs on one thread a rank.

The rank functions are module-level (``run_ranks`` pickles them by
name), so this module imports no JAX at its top level.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, run_ranks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

B, S = 4, 32
# case: (arch, n_microbatches, batch rows, rank 1's rows half masked)
CASES = {"tinyllama-uneven": ("tinyllama-1.1b", 1, 4, True),
         "qwen-uneven-nm2": ("qwen1.5-0.5b", 2, 4, True),
         "tinyllama-b3": ("tinyllama-1.1b", 1, 3, False),
         "olmoe": ("olmoe-1b-7b", 1, 4, True)}
# the case also stepped with ZeRO-1 off (the whole state on every rank)
WHOLE_STATE = "tinyllama-uneven"
STEP_KEYS = list(CASES) + [WHOLE_STATE + "/zero1-off"]
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)
# the pipeline: stages, microbatches, rows a microbatch, width
PIPE = (2, 8, 4, 16)
LAUNCH = ["--arch", "tinyllama-1.1b", "--reduce", "smoke", "--batch", "4",
          "--seq", "32", "--device", "cpu", "--ckpt-every", "2",
          "--log-every", "1"]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _tcfg(name, nm=1):
    c = tconfigs.reduced(tconfigs.get_config(name)).replace(
        kernel_impl="torch", n_microbatches=nm)
    if c.moe is not None:
        c = c.replace(moe=dataclasses.replace(c.moe, capacity_factor=4.0))
    return c


def _batch(cfg, rows, uneven):
    b = train.make_batch_fn(cfg, rows, S)(0)
    if uneven:
        # rank 1's rows (the second half) lose half their targets
        b["loss_mask"] = b["loss_mask"].copy()
        b["loss_mask"][rows // 2:, : S // 2] = 0.0
    return b


def _host(tree):
    return {"/".join(k): v.detach().numpy().copy() for k, v in leaves(tree)}


# ----------------------------------------------------------------------
# the world (every rank runs it; rank 0's result comes back)
# ----------------------------------------------------------------------

def _steps(mesh, jax_states):
    """Each case's one (2, 1) step from JAX's bridged state."""
    from repro_torch import bridge
    from repro_torch.models import lm

    out = {}
    for key, (name, nm, rows, uneven) in CASES.items():
        cfg = _tcfg(name, nm)
        jp, jo = jax_states[key]
        params = bridge.from_jax(jp, "cpu")
        whole = bridge.from_jax({"o": jo}, "cpu")["o"]
        oc = adamw.OptConfig(**OPT)
        opt = adamw.state_blocks(oc, whole, params, mesh)
        batch = _batch(cfg, rows, uneven)
        if key == "olmoe":
            # the rank's own lb_loss, on its rows alone
            spec = SH.train_batch_pspecs(cfg, mesh, batch)
            local = {k: SH.local_block(torch.as_tensor(v), spec[k], mesh)
                     for k, v in batch.items()}
            out["olmoe-rank-lb"] = float(lm.train_loss(
                params, local, cfg)[1]["lb_loss"])
        one = steps.build_train_step(cfg, oc)(
            bridge.from_jax(jp, "cpu"), whole, batch)[2]["grad_norm"]
        runs = [(key, True, params, opt)]
        if key == WHOLE_STATE:
            runs.append((key + "/zero1-off", False,
                         bridge.from_jax(jp, "cpu"),
                         bridge.from_jax({"o": jo}, "cpu")["o"]))
        for k, zero1, params, opt in runs:
            step = steps.build_train_step(cfg, oc, mesh=mesh, zero1=zero1)
            params, opt, m = step(params, opt, batch)
            out[k] = {"metrics": {n: float(v) for n, v in m.items()},
                      "params": _host(params), "sync": dict(step.last_sync),
                      "one_rank_grad_norm": float(one)}
    return out


def _zero1_state(mesh):
    """2 steps of reduced tinyllama from a seed on (2, 1) and on one rank
    (in this rank): each m / v block's gap to ``local_block`` of the
    one-rank state, relative to its norm; the state's bytes; a bf16
    init's master blocks against the cast parameters."""
    from repro_torch.models import lm

    cfg = _tcfg("tinyllama-1.1b")
    oc = adamw.OptConfig(**OPT)
    runs = {}
    for m in (mesh, None):
        p = lm.init(cfg, seed=0, device="cpu")
        o = adamw.init(oc, p, mesh=m)
        step = steps.build_train_step(cfg, oc, mesh=m)
        for s in range(2):
            p, o, _ = step(p, o, _batch(cfg, B, True))
        runs[m is None] = (p, o)
    (p, o), (_, one) = runs[False], runs[True]
    specs = adamw.state_specs(oc, p, mesh).m
    gaps = {}
    for name in ("m", "v"):
        for k, t in leaves(getattr(one, name)):
            want = SH.local_block(t, adamw._at(specs, k), mesh)
            got = adamw._at(getattr(o, name), k)
            gaps[(name,) + k] = (float((got - want).norm() / want.norm()
                                       .clamp_min(1e-30))
                                 if got.shape == want.shape else None)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in leaves(tree))

    pb = lm.init(cfg.replace(dtype="bfloat16"), seed=0, device="cpu")
    ob = adamw.init(oc, pb, mesh=mesh)
    specs = adamw.state_specs(oc, pb, mesh).master
    master_exact = all(torch.equal(
        t, SH.local_block(adamw._at(pb, k), adamw._at(specs, k),
                          mesh).float()) for k, t in leaves(ob.master))
    return {"gaps": gaps, "params": _host(p),
            "bytes": nbytes(o.m) + nbytes(o.v),
            "whole_bytes": 2 * nbytes(p),
            "bf16_bytes": nbytes(ob.m) + nbytes(ob.v) + nbytes(ob.master),
            "bf16_whole_bytes": 3 * 4 * sum(t.numel() for _, t in
                                            leaves(pb)),
            "master_exact": master_exact}


def _compressed(mesh, g):
    from repro_torch.dist.compression import compressed_psum
    from repro_torch.kernels.quant import quantize_int8

    x = torch.from_numpy(g[mesh.coord("data")])
    err = torch.zeros_like(x)
    out1, err1 = compressed_psum(x, err, mesh)
    q1, _ = quantize_int8(x + err)
    out2, err2 = compressed_psum(x, err1, mesh)
    return {k: v.numpy() for k, v in (("out1", out1), ("err1", err1),
                                      ("q1", q1), ("out2", out2),
                                      ("err2", err2))}


def _pipeline(w, x):
    from repro_torch.dist.pipeline import pipeline_apply

    pipe = make_mesh({"pipe": PIPE[0]}, device="cpu")
    stage = SH.local_block(torch.from_numpy(w), SH.PS("pipe", None, None),
                           pipe)[0]
    got = pipeline_apply(pipe, lambda wt, xb: torch.tanh(xb @ wt), stage,
                         torch.from_numpy(x), n_micro=PIPE[1])
    return {"coords": dict(pipe.coords), "got": got.numpy()}


def _world(mesh, jax_states, g, w, x, ckpt):
    torch.set_num_threads(1)
    out = {"steps": _steps(mesh, jax_states), "zero1": _zero1_state(mesh),
           "compressed": _compressed(mesh, g), "pipeline": _pipeline(w, x)}
    parse = train.build_parser().parse_args
    out["launcher"] = train._train_rank(
        mesh, parse(LAUNCH + ["--steps", "4", "--ckpt", ckpt]))
    # and back: a 1 1 checkpoint (rank 0 alone) resumed on (2, 1)
    back = ckpt + "-back"
    if mesh.coord("data") == 0:
        train._train(parse(LAUNCH + ["--steps", "2", "--ckpt", back]))
    mesh.gather_objects(None)
    out["launcher_back"] = train._train_rank(
        mesh, parse(LAUNCH + ["--steps", "4", "--ckpt", back]))
    if mesh.coord("data") == 0:
        # 1 1: uninterrupted, and resumed from the (2, 1) checkpoint
        out["straight"] = train._train(parse(LAUNCH + ["--steps", "6"]))
        out["resumed"] = train._train(parse(
            LAUNCH + ["--steps", "6", "--ckpt", ckpt]))
    ranks = mesh.gather_objects(out)
    # a tensor in the result comes back after the ranks have exited
    out["tensor"] = torch.arange(6.0)
    out["ranks"] = [{"zero1": r["zero1"], "compressed": r["compressed"],
                     "pipeline": r["pipeline"],
                     "rank_lb": r["steps"]["olmoe-rank-lb"]}
                    for r in ranks]
    return out


# ----------------------------------------------------------------------
# the JAX side, and the world, once a module
# ----------------------------------------------------------------------

def _jax_cfg(name, nm):
    from repro import configs as jconfigs
    c = jconfigs.reduced(jconfigs.get_config(name)).replace(
        n_microbatches=nm)
    if c.moe is not None:
        c = c.replace(moe=dataclasses.replace(c.moe, capacity_factor=4.0))
    return c


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's initial states, then the world (in a thread) while JAX takes
    each case's step on the global batch."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from repro.launch.steps import build_train_step as jbuild
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw

    joc = jadamw.OptConfig(**OPT)
    init = {}
    for key, (name, nm, rows, uneven) in CASES.items():
        jp = jlm.init(_jax_cfg(name, nm), jax.random.PRNGKey(0))
        init[key] = (jp, jadamw.init(joc, jp))
    # numpy leaves in the port's OptState: a JAX NamedTuple would make
    # every rank import JAX to unpickle it
    states = {k: (jax.tree.map(np.asarray, jp),
                  adamw.OptState(*jax.tree.map(np.asarray, tuple(jo))))
              for k, (jp, jo) in init.items()}
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 256)).astype(np.float32)
    n_stages, n_micro, mb, d = PIPE
    w = (rng.standard_normal((n_stages, d, d)) / d ** 0.5).astype(np.float32)
    x = rng.standard_normal((n_micro * mb, d)).astype(np.float32)
    ckpt = str(tmp_path_factory.mktemp("dp_ckpt"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _world, 2, 1,
                            args=(states, g, w, x, ckpt), device="cpu",
                            threads=1)
        want = {}
        for key, (name, nm, rows, uneven) in CASES.items():
            batch = {k: jnp.asarray(v) for k, v in
                     _batch(_tcfg(name, nm), rows, uneven).items()}
            jp, jo, jm = jax.jit(jbuild(_jax_cfg(name, nm), joc))(
                *init[key], batch)
            want[key] = {"metrics": {k: float(v) for k, v in jm.items()},
                         "params": jp, "lr": float(jm["lr"])}
        got = ranks.result()
    return {"got": got, "want": want, "g": g, "w": w, "x": x,
            "ckpt": ckpt}


# ----------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------

def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("key", STEP_KEYS)
def test_step_matches_jax_single_device(world, key):
    from test_torch_train_step import hold_params

    case = key.split("/")[0]
    name, nm, rows, uneven = CASES[case]
    if uneven:
        # the ranks' mask counts differ: a mean of the ranks' losses
        # would be wrong here
        mask = _batch(_tcfg(name, nm), rows, True)["loss_mask"]
        assert mask[: rows // 2].sum() != mask[rows // 2:].sum()
    got, want = world["got"]["steps"][key], world["want"][case]
    gm, wm = got["metrics"], want["metrics"]
    assert set(gm) == set(wm)
    for k in wm:
        if k != "grad_norm":
            assert _rel(gm[k], wm[k]) <= 1e-5, (k, gm[k], wm[k])
    # the gradient norm as the one-device test holds it (2e-3: fp32
    # gradient noise of the ill-conditioned init), and within 1e-4 of
    # the port's one-rank step on the same state
    assert _rel(gm["grad_norm"], wm["grad_norm"]) <= 2e-3
    assert _rel(gm["grad_norm"], got["one_rank_grad_norm"]) <= 1e-4
    params = {tuple(k.split("/")): torch.from_numpy(v)
              for k, v in got["params"].items()}
    nested = {}
    for path, v in params.items():
        node = nested
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    hold_params(nested, want["params"], want["lr"])
    # a ring's bytes: half of each split leaf, twice that of a whole one
    assert got["sync"]["bytes"] > 0 and got["sync"]["s"] >= 0


def test_moe_lb_loss_is_the_global_one(world):
    """olmoe's lb_loss is JAX's over the global batch's tokens; the mean
    of the ranks' own lb_loss (each a product of its rows' means) is
    not."""
    got = world["got"]["steps"]
    want = world["want"]["olmoe"]["metrics"]["lb_loss"]
    assert _rel(got["olmoe"]["metrics"]["lb_loss"], want) <= 1e-5
    mean = sum(r["rank_lb"] for r in world["got"]["ranks"]) / 2
    assert _rel(mean, want) > 1e-4, (mean, want)


def test_zero1_state_blocks(world):
    """After 2 steps each rank's m / v blocks are ``local_block`` of the
    one-rank state (2e-3 of each leaf's norm, the gradient's tolerance);
    a rank holds about half the state's bytes; a bf16 init's master
    blocks are the cast parameters."""
    ranks = world["got"]["ranks"]
    for r in ranks:
        z = r["zero1"]
        assert len(z["gaps"]) > 0
        for k, gap in z["gaps"].items():
            assert gap is not None and gap <= 2e-3, (k, gap)
        assert z["master_exact"]
        assert 0.45 <= z["bytes"] / z["whole_bytes"] <= 0.55, z["bytes"]
        assert 0.45 <= z["bf16_bytes"] / z["bf16_whole_bytes"] <= 0.55
    # the ranks' parameters are the same bits after the all-gathers
    a, b = (r["zero1"]["params"] for r in ranks)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_compressed_psum_matches_jax(world):
    import jax
    import jax.numpy as jnp
    from repro.dist.compression import compressed_psum as jpsum
    from repro.kernels.quant import quantize_int8 as jquant

    g = world["g"]
    err0 = jnp.zeros_like(jnp.asarray(g))
    fn = jax.vmap(lambda x, e: jpsum(x, e, "data", 2), axis_name="data")
    jout1, jerr1 = fn(jnp.asarray(g), err0)
    jout2, _ = fn(jnp.asarray(g), jerr1)
    want = g.mean(0)
    for d, r in enumerate(world["got"]["ranks"]):
        c = r["compressed"]
        jq, _ = jquant(jnp.asarray(g[d]))
        np.testing.assert_array_equal(c["q1"], np.asarray(jq))
        np.testing.assert_allclose(c["out1"], np.asarray(jout1[d]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c["err1"], np.asarray(jerr1[d]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c["out2"], np.asarray(jout2[d]),
                                   rtol=1e-6, atol=1e-7)
        # JAX's contract: close, a residual, two steps closer than one
        one = np.abs(c["out1"] - want).max()
        assert one < 0.05 and np.abs(c["err1"]).max() > 0
        two = np.abs((c["out1"] + c["out2"]) / 2 - want).max()
        assert two <= one + 1e-6
    a, b = (r["compressed"]["out1"] for r in world["got"]["ranks"])
    np.testing.assert_array_equal(a, b)


def test_pipeline_matches_sequential(world):
    import jax.numpy as jnp

    want = jnp.asarray(world["x"])
    for s in range(PIPE[0]):
        want = jnp.tanh(want @ jnp.asarray(world["w"][s]))
    for d, r in enumerate(world["got"]["ranks"]):
        assert r["pipeline"]["coords"] == {"pipe": d}
        np.testing.assert_allclose(r["pipeline"]["got"], np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_launcher_checkpoint_restores_across_meshes(world):
    """The (2, 1) run's losses are ``1 1``'s (1e-5 relative); ``1 1``
    resumes from the (2, 1) checkpoint at step 4 and its steps 4-5 are
    an uninterrupted ``1 1`` run's, and (2, 1) resumed from a ``1 1``
    checkpoint at step 2 gives its steps 2-3 (1e-4)."""
    from repro_torch.checkpoint import CheckpointStore

    got = world["got"]
    # the 1 1 run resumed from the (2, 1) checkpoint added step 6
    assert CheckpointStore(world["ckpt"]).steps() == [2, 4, 6]
    dp, straight, resumed = (got[k] for k in ("launcher", "straight",
                                              "resumed"))
    assert [s for s, _ in straight] == list(range(6))
    assert [s for s, _ in dp] == [0, 1, 2, 3]
    for (s, a), (_, b) in zip(dp, straight):
        assert _rel(a, b) <= 1e-5, (s, a, b)
    assert [s for s, _ in resumed] == [4, 5]
    for (s, a), (_, b) in zip(resumed, straight[4:]):
        assert _rel(a, b) <= 1e-4, (s, a, b)
    # and back: (2, 1) resumed at step 2 from a 1 1 checkpoint
    back = got["launcher_back"]
    assert [s for s, _ in back] == [2, 3]
    for (s, a), (_, b) in zip(back, straight[2:4]):
        assert _rel(a, b) <= 1e-4, (s, a, b)


def test_rank_result_holds_tensors(world):
    assert torch.equal(world["got"]["tensor"], torch.arange(6.0))


def test_model_axis_is_refused():
    cfg = _tcfg("tinyllama-1.1b")
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match="item 14"):
        steps.build_train_step(cfg, adamw.OptConfig(), mesh=mesh)

