"""Tensor-parallel serving on gloo CPU ranks against the JAX package's
single-device engine (the JAX mesh engine fails under JAX 0.9, ROADMAP
queue 3): the same parameters (the JAX init, bridged) and prompts give
the same greedy tokens, and the prefill and first decode-step logits
agree within 1e-4 of their scale.

``DecodeEngine(mesh=...)`` with ``decode_shard='none'`` cuts the whole
parameters into each rank's blocks under ``param_pspecs(cfg, mesh,
'serve')`` and its cache into its kv heads; the layers compute with
explicit collectives.

World A (2 ranks, (1, 2)): reduced tinyllama (4 query heads over 1 kv
head: the kv head stays whole, each rank's 2 query heads read it), qwen
(4 / 4 heads: kv split, qkv bias, the tied table split by vocab) and
olmoe (8 experts, 4 a rank) with ``ep='gspmd'`` and ``ep='full_ep'``
through ``generate``; the paged ``Scheduler`` over tinyllama's and
qwen's fp32 and int8 pools with the dist tests' ``STREAM`` (a
preemption, slot reuse), tables equal on every rank; ``moe_ffn`` of
olmoe and deepseek (sigmoid scores with a selection bias, a shared
expert) with forced drops, gspmd and full_ep, on the rank's expert
blocks against JAX's on the same parameters and group.  World B (4
ranks): tinyllama and olmoe (2 experts a rank) on (2, 2), and olmoe with
6 experts on (1, 4), where the experts do not divide the ranks and
``expert_ff`` takes 'model'; ``shard_params``' blocks gathered back
equal the whole tree.  Each rank holds only its blocks' bytes.  The
options still refused raise before any state changes, naming ROADMAP
queue 1 item 14."""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig, Request,  # noqa
                                Scheduler)
from repro_torch.launch.mesh import Mesh, make_local_mesh, run_ranks  # noqa

B, P, GEN = 4, 12, 6
LOGIT_TOL = 1e-4
# (prompt length, gen): 2 slots over 8 pages of 4, growth preempts
STREAM = [(3, 12), (5, 10), (9, 6)]
PAGED = dict(batch=2, max_len=24, paged=True, page_size=4, n_pages=8)
# (name, MoE overrides): the configs served, keyed as in the results
CASES = {"tinyllama": ("tinyllama-1.1b", {}),
         "qwen": ("qwen1.5-0.5b", {}),
         "olmoe": ("olmoe-1b-7b", {}),
         "olmoe-full_ep": ("olmoe-1b-7b", {"ep": "full_ep"}),
         "olmoe-6": ("olmoe-1b-7b", {"n_experts": 6})}
WORLD_A = {"tinyllama": (1, 2), "qwen": (1, 2), "olmoe": (1, 2),
           "olmoe-full_ep": (1, 2)}
# world B's keys: (case, mesh)
WORLD_B = {"tinyllama-22": ("tinyllama", (2, 2)),
           "olmoe-22": ("olmoe", (2, 2)), "olmoe-6": ("olmoe-6", (1, 4))}
STREAMS = ("tinyllama", "qwen")
# (config, ep) of the ``moe_ffn`` cases on world A's expert blocks
MOE_OPS = {"gspmd": ("olmoe-1b-7b", "gspmd"),
           "full_ep": ("olmoe-1b-7b", "full_ep"),
           "deepseek-gspmd": ("deepseek-v3-671b", "gspmd"),
           "deepseek-full_ep": ("deepseek-v3-671b", "full_ep")}


def _cfgs(case):
    from repro import configs as jconfigs
    name, moe = CASES[case]
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    if moe:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _jax_mesh():
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _stream(sched_cls, req_cls, eng, record=None):
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, 256, p).astype(np.int32), g)
             for p, g in STREAM]
    sched = sched_cls(eng, bucket_tables=False)
    if record is not None:
        step = sched.step

        def recorded():
            step()
            record.append(hashlib.sha256(
                sched.table.tobytes() + sched.lens.tobytes()).hexdigest())
        sched.step = recorded
    sched.submit(req_cls(rid=0, tokens=specs[0][0], gen=specs[0][1]))
    sched.admit()
    sched.step()
    sched.step()
    for i in (1, 2):
        sched.submit(req_cls(rid=i, tokens=specs[i][0], gen=specs[i][1]))
    return sched.run(), sched


def _jax_side(case, toks):
    """The JAX single-device engine's greedy tokens, prefill logits and
    first decode-step logits (and its params, bridged), and for the
    stream cases its Scheduler streams on fp32 and int8 pools."""
    import jax
    import jax.numpy as jnp
    from repro.engine import DecodeEngine as JEngine
    from repro.engine import EngineConfig as JEngineConfig
    from repro_torch import bridge

    jc, tc = _cfgs(case)
    jeng = JEngine(jc, JEngineConfig(batch=B, max_len=P + GEN),
                   mesh=_jax_mesh())
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    logits, cache = jeng.prefill({"tokens": jnp.asarray(toks)})
    tok = np.asarray(logits).argmax(-1).astype(np.int32)
    step, _ = jeng.decode_step(jnp.asarray(tok), P, cache)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    out = {"generate": np.asarray(want), "prefill": np.asarray(logits),
           "step": np.asarray(step)}
    if case in STREAMS:
        from repro.engine import Request as JRequest
        from repro.engine import Scheduler as JScheduler
        for kv in ("bf16", "int8"):
            peng = JEngine(jc, JEngineConfig(**PAGED, kv_dtype=kv),
                           params=jeng.params, mesh=_jax_mesh())
            res = _stream(JScheduler, JRequest, peng)[0]
            out[kv] = {k: np.asarray(v) for k, v in res.items()}
    return tc, params, out


def _jax_moe(name, ep):
    """JAX's ``moe_ffn`` at capacity factor 0.5 (assignments dropped) on
    a (3, 16) group: (the port's config, the JAX-initialised parameters
    bridged, the group, JAX's y and aux losses)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common import module as JM
    from repro.models import moe as jmoe
    from repro_torch import bridge

    kw = dict(ep=ep, capacity_factor=0.5)
    jc = jconfigs.reduced(jconfigs.get_config(name))
    jc = jc.replace(moe=dataclasses.replace(jc.moe, **kw))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, **kw))
    jp = JM.init_params(jmoe.moe_spec(jc), jax.random.PRNGKey(3))
    if "e_bias" in jp:      # a selection bias that moves the choice
        jp["e_bias"] = jax.random.normal(jax.random.PRNGKey(4),
                                         jp["e_bias"].shape) * 0.05
    x = np.random.default_rng(2).standard_normal(
        (3, 16, tc.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jc)
    return (tc, bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu"), x,
            np.asarray(jy), {k: float(v) for k, v in jaux.items()})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def _serve(mesh, cfg, params, toks, streams):
    """One engine on ``mesh``: generate, the prefill and first decode-step
    logits of this rank's rows, its parameter bytes beside the sum of
    ``local_block`` sizes, and with ``streams`` the Scheduler streams."""
    shape = (mesh.axis_size("data"), mesh.axis_size("model"))
    eng = DecodeEngine(cfg, EngineConfig(batch=B, max_len=P + GEN,
                                         mesh_shape=shape),
                       params=params, device="cpu", mesh=mesh)
    got, _ = eng.generate({"tokens": toks}, gen=GEN)
    logits, cache = eng.prefill({"tokens": toks})
    step, _ = eng.decode_step(logits.argmax(-1).to(torch.int32), P, cache)
    specs = TSH.param_pspecs(cfg, mesh, "serve")
    blocks = TSH.shard_params(params, specs, mesh)
    out = {"generate": got.numpy(), "rows": (eng.rows.start, eng.rows.stop),
           "prefill": logits.numpy(), "step": step.numpy(),
           "bytes": _nbytes(eng.params), "block_bytes": _nbytes(blocks),
           "whole_bytes": _nbytes(params),
           "cache_kv": (cache["moe"]["k"] if cfg.family == "moe"
                        else cache["k"]).shape[3]}
    if cfg.family == "moe":
        out["moe_wi"] = tuple(eng.params["layers"]["moe"]["wi"].shape[1:])
    for kv in streams:
        peng = DecodeEngine(cfg, EngineConfig(**PAGED, kv_dtype=kv,
                                              mesh_shape=shape),
                            params=params, device="cpu", mesh=mesh)
        steps = []
        res = _stream(Scheduler, Request, peng, steps)[0]
        out[kv] = {k: np.asarray(v) for k, v in res.items()}
        out[kv + "-steps"] = steps
        out[kv + "-pool_kv"] = peng.init_paged_cache()["k"].shape[3]
    return out


def _unstacked(specs):
    """One layer's specs out of a stacked group's: the layer dim off."""
    return {k: (_unstacked(v) if isinstance(v, dict) else TSH.PS(*v[1:]))
            for k, v in specs.items()}


def _moe_ops(mesh, cases):
    """``moe_ffn`` of each ``_jax_moe`` case on this rank's blocks of the
    MoE layer under ``param_pspecs(..., 'serve')``, with the layout read
    off the model's spec tree: y, the aux losses, the rank's experts."""
    from repro_torch.common.hints import shard_hint
    from repro_torch.models import moe

    out = {}
    for key, (tc, whole, x, _, _) in cases.items():
        specs = TSH.param_pspecs(tc, mesh, "serve")
        mine = TSH.shard_params(
            whole, _unstacked(specs["layers"]["moe"]), mesh)
        y, aux = moe.moe_ffn(mine, torch.from_numpy(x), tc,
                             layout=TSH.tp_layout(specs, mesh))
        out[key] = {"y": y.numpy(), "aux": {k: v.item()
                                            for k, v in aux.items()},
                    "experts": mine["wi"].shape[0]}
    # the hint cuts only where the mesh has every axis and they divide
    t = torch.arange(8.0).view(1, 8)
    out["hint"] = (shard_hint(t, TSH.PS(None, ("data", "model")),
                              mesh).tolist(),
                   shard_hint(t, TSH.PS(None, "pipe"), mesh).tolist(),
                   shard_hint(torch.arange(3.0).view(1, 3),
                              TSH.PS(None, "model"), mesh).tolist())
    # the hint cuts only where the mesh has every axis and they divide
    t = torch.arange(8.0).view(1, 8)
    out["hint"] = (shard_hint(t, TSH.PS(None, ("data", "model")),
                              mesh).tolist(),
                   shard_hint(t, TSH.PS(None, "pipe"), mesh).tolist(),
                   shard_hint(torch.arange(3.0).view(1, 3),
                              TSH.PS(None, "model"), mesh).tolist())
    return out


def _gathered_params(mesh, cfg, params):
    """``shard_params`` then ``gather_block`` of every leaf: the whole
    tree back, on every rank."""
    specs = TSH.param_pspecs(cfg, mesh, "serve")
    blocks = TSH.shard_params(params, specs, mesh)
    return all(torch.equal(TSH.gather_block(b, s, mesh), w)
               for (_, b), (_, s), (_, w) in zip(
                   leaves(blocks), leaves(specs), leaves(params)))


def _world(mesh, jobs, toks, moe_cases):
    """Every job of this world on this rank (and on world A the
    ``moe_ffn`` cases); each rank's results, gathered from every rank
    (rank 0's list comes back)."""
    torch.set_num_threads(1)
    out = {}
    for key, (cfg, params, shape, streams) in jobs.items():
        m = mesh if shape == (mesh.axis_size("data"),
                              mesh.axis_size("model")) else \
            make_local_mesh(*shape, device="cpu")
        out[key] = _serve(m, cfg, params, toks, streams)
        if mesh.size == 4:
            out[key]["gathered"] = _gathered_params(m, cfg, params)
    if mesh.size == 2:
        out["moe_ops"] = _moe_ops(mesh, moe_cases)
    return mesh.gather_objects(out)


@pytest.fixture(scope="module")
def served(monkeypatch_module):
    toks = np.random.default_rng(1).integers(0, 256, (B, P),
                                             dtype=np.int32)
    want, jobs_a, jobs_b = {}, {}, {}
    for case in CASES:
        tc, params, w = _jax_side(case, toks)
        want[case] = w
        streams = ("bf16", "int8") if case in STREAMS else ()
        if case in WORLD_A:
            jobs_a[case] = (tc, params, WORLD_A[case], streams)
        for key, (c, shape) in WORLD_B.items():
            if c == case:
                jobs_b[key] = (tc, params, shape, ())
    moe_cases = {k: _jax_moe(*c) for k, c in MOE_OPS.items()}
    want["moe_ops"] = {k: c[3:] for k, c in moe_cases.items()}
    got = {"a": run_ranks(_world, 1, 2, args=(jobs_a, toks, moe_cases),
                          device="cpu", threads=1),
           "b": run_ranks(_world, 2, 2, args=(jobs_b, toks, {}),
                          device="cpu", threads=1)}
    return want, got


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE", "0")
    yield mp
    mp.undo()


def _ranks(got, key):
    """(world, case) of a results key: every rank's results of it."""
    world = "a" if key in WORLD_A else "b"
    return [r[key] for r in got[world]]


def _case(key):
    return key if key in WORLD_A else WORLD_B[key][0]


ALL = list(WORLD_A) + list(WORLD_B)


@pytest.mark.parametrize("key", ALL)
def test_tp_generate_equals_jax(served, key):
    """Greedy tokens on every rank equal the JAX single device's."""
    want, got = served
    for r in _ranks(got, key):
        np.testing.assert_array_equal(r["generate"],
                                      want[_case(key)]["generate"])


@pytest.mark.parametrize("what", ["prefill", "step"])
@pytest.mark.parametrize("key", ALL)
def test_tp_logits_within_1e4_of_scale(served, key, what):
    """The prefill logits and the first decode step's, each rank's rows
    against the JAX single device's, within 1e-4 of the logits' scale."""
    want, got = served
    w = want[_case(key)][what]
    scale = max(1.0, float(np.abs(w).max()))
    for r in _ranks(got, key):
        r0, r1 = r["rows"]
        err = float(np.abs(r[what] - w[r0:r1]).max())
        assert err <= LOGIT_TOL * scale, (key, what, err, scale)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", STREAMS)
def test_tp_scheduler_stream_equals_jax(served, case, kv):
    """The paged Scheduler on (1, 2) (tinyllama's pools keep their one kv
    head whole, qwen's split theirs with their int8 scales): every
    request's tokens equal JAX's single-device Scheduler's, and the
    tables and lengths after every step are equal on every rank."""
    want, got = served
    ranks = _ranks(got, case)
    for r in ranks:
        assert r[kv].keys() == want[case][kv].keys()
        for rid in want[case][kv]:
            np.testing.assert_array_equal(r[kv][rid], want[case][kv][rid])
    assert ranks[0][kv + "-steps"] == ranks[1][kv + "-steps"]
    assert len(ranks[0][kv + "-steps"]) > len(STREAM)
    _, tc = _cfgs(case)
    split = tc.n_kv_heads % 2 == 0
    assert ranks[0][kv + "-pool_kv"] == tc.n_kv_heads // (2 if split
                                                          else 1)


@pytest.mark.parametrize("key", ALL)
def test_each_rank_holds_its_blocks(served, key):
    """A rank's parameter bytes are the sum of its ``local_block`` sizes
    under ``param_pspecs(..., 'serve')``: about 1/M of the tensor-parallel
    leaves (the norms, and the experts' router where they do not divide,
    stay whole); its dense cache holds its kv heads."""
    _, got = served
    _, tc = _cfgs(_case(key))
    M = (WORLD_A.get(key) or WORLD_B[key][1])[1]
    for r in _ranks(got, key):
        assert r["bytes"] == r["block_bytes"]
        # every matrix but the norms and an unsplit router is split
        assert r["bytes"] < r["whole_bytes"] / M * 1.1
        assert r["cache_kv"] == (tc.n_kv_heads // M
                                 if tc.n_kv_heads % M == 0
                                 else tc.n_kv_heads)


@pytest.mark.parametrize("key,experts,ff", [
    ("olmoe", 4, 32), ("olmoe-full_ep", 4, 32), ("olmoe-22", 2, 32),
    ("olmoe-6", 6, 8)])
def test_experts_split_over_every_axis_or_ffn_over_model(served, key,
                                                         experts, ff):
    """olmoe's 8 experts (d_expert 32): 4 a rank on (1, 2), 2 on (2, 2)
    (its rows gathered over 'data' for the MoE groups); 6 experts on
    (1, 4) do not divide, so each rank holds all 6 with its quarter of
    ``expert_ff``."""
    _, got = served
    for r in _ranks(got, key):
        assert r["moe_wi"] == (experts, 64, ff)


@pytest.mark.parametrize("ep", list(MOE_OPS))
def test_moe_ffn_on_expert_blocks_drops_what_one_device_drops(served, ep):
    """At capacity factor 0.5 (assignments dropped), the expert-parallel
    ``moe_ffn`` on each rank's half of the experts equals JAX's on the
    whole parameters and the same group: the output and the aux losses
    (``drop_frac``, ``lb_loss``, ``z_loss``) at 1e-5."""
    want, got = served
    jy, jaux = want["moe_ops"][ep]
    E = tconfigs.reduced(tconfigs.get_config(MOE_OPS[ep][0])).moe.n_experts
    assert jaux["drop_frac"] > 0
    for r in got["a"]:
        ops = r["moe_ops"][ep]
        assert ops["experts"] == E // 2
        np.testing.assert_allclose(ops["y"], jy, atol=1e-5, rtol=1e-5)
        assert ops["aux"].keys() == jaux.keys()
        for k, w in jaux.items():
            assert ops["aux"][k] == pytest.approx(w, rel=1e-5, abs=1e-5), k


def test_shard_hint_cuts_only_where_every_axis_divides(served):
    _, got = served
    split, foreign, ragged = got["a"][0]["moe_ops"]["hint"]
    assert split == [[0.0, 1.0, 2.0, 3.0]]
    assert foreign == [list(map(float, range(8)))]
    assert ragged == [[0.0, 1.0, 2.0]]
    assert got["a"][1]["moe_ops"]["hint"][0] == [[4.0, 5.0, 6.0, 7.0]]


def test_whole_trees_come_back_from_the_blocks(served):
    _, got = served
    for key in WORLD_B:
        assert all(r["gathered"] for r in _ranks(got, key))


# ---------------------------------------------------------------- refusals

def _abstract(data, model, coords=None):
    return Mesh({"data": data, "model": model}, coords)


def _mla():
    from repro_torch.common.config import MLAConfig
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    return tc.replace(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                    rope_head_dim=8, nope_head_dim=16,
                                    v_head_dim=16))


@pytest.mark.parametrize("make,ekw,mesh", [
    (_mla, {}, (1, 2)),
    (lambda: tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")),
     dict(param_strategy="fsdp_tp"), (1, 2)),
    (lambda: tconfigs.reduced(tconfigs.get_config("olmoe-1b-7b")),
     dict(paged=True, page_size=4), (2, 2)),
    (lambda: tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b")),
     dict(paged=True, page_size=4, prefix_cache=True), (1, 2)),
    (lambda: tconfigs.reduced(tconfigs.get_config("olmoe-1b-7b")),
     dict(paged=True, page_size=4, chunked_prefill=True, chunk_tokens=4),
     (1, 2))], ids=["mla", "fsdp_tp", "paged-data", "prefix", "chunked"])
def test_unserved_tp_options_raise_item_14(make, ekw, mesh):
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        DecodeEngine(make(), EngineConfig(batch=2, max_len=16, **ekw),
                     device="cpu", mesh=_abstract(*mesh))


def test_tp_scheduler_refuses_prefix_chunks_and_durability():
    """On a tensor-parallel engine the Scheduler's prefix cache, chunked
    prefill and durability hooks raise before it allocates anything; the
    engine's blocks are already cut (rank 1's half of each split leaf)."""
    tc = tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b"))
    eng = DecodeEngine(tc, EngineConfig(**PAGED, mesh_shape=(1, 2)),
                       device="cpu",
                       mesh=_abstract(1, 2, {"data": 0, "model": 1}))
    assert eng.distributed and eng.page_slab is None
    assert eng.params["layers"]["attn"]["wq"].shape[2] == tc.n_heads // 2
    assert eng.params["embed"]["table"].shape[0] == tc.vocab_padded // 2
    for kw in (dict(prefix_cache=True), dict(chunked_prefill=True),
               dict(journal=object()), dict(snapshotter=object())):
        with pytest.raises(NotImplementedError, match="item 14"):
            Scheduler(eng, **kw)


def test_train_step_with_a_model_axis_still_raises():
    from repro_torch.launch.steps import ITEM_14_TP, build_train_step
    from repro_torch.optim.adamw import OptConfig

    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    with pytest.raises(NotImplementedError) as e:
        build_train_step(tc, OptConfig(), mesh=_abstract(1, 2))
    assert str(e.value) == ITEM_14_TP
