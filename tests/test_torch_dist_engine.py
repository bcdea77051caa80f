"""Distributed serving on gloo CPU ranks against the JAX package's
single-device engine (the JAX mesh engine fails under JAX 0.9, ROADMAP
queue 3): the same parameters (the JAX init, bridged) and prompts give
the same greedy tokens.

World A (2 ranks): reduced tinyllama (GQA), the dense family with MLA
and reduced olmoe (the moe family, GQA) through ``DecodeEngine.
generate`` on (1, 2) with the cache sequence-sharded and on (2, 1) with
the batch split (a sampled generate there too, against the port's one
rank), and the paged engine on (1, 2) seq:
``generate`` and a Scheduler stream (a preemption, slot reuse) on fp32
and int8 pools.  World B (4 ranks): both dense configs on (2, 2) seq.
Tokens, the Scheduler's tables and lengths after every step, and the
parameters an engine builds from a seed are equal on every rank.  On
(2, 1) without sequence sharding each rank holds its blocks of the
parameters under ``param_pspecs(..., 'serve')`` (olmoe's experts split
over 'data'); tensor-parallel serving on a 'model' axis is
``test_torch_tp_engine.py``'s.  The options still refused raise before
any state changes and name ROADMAP queue 1 item 14; a rank that raises
or a collective that never completes fails ``run_ranks``."""
import hashlib
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig, Request,  # noqa
                                Scheduler)
from repro_torch.launch.mesh import (Mesh, make_local_mesh,  # noqa: E402
                                     run_ranks)

B, P, GEN = 4, 12, 6
# a sampled generate on (2, 1) against the port's one rank
TEMP, SEED = 1.0, 5
# (prompt length, gen): 2 slots over 8 pages of 4, growth preempts
STREAM = [(3, 12), (5, 10), (9, 6)]
PAGED = dict(batch=2, max_len=24, paged=True, page_size=4, n_pages=8)


def _mla_kw():
    return dict(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16)


def _cfgs(name):
    from repro import configs as jconfigs
    from repro.common.config import MLAConfig as JMLA
    from repro_torch.common.config import MLAConfig as TMLA
    base = "tinyllama-1.1b" if name == "dense-mla" else name
    jc = jconfigs.reduced(jconfigs.get_config(base))
    tc = tconfigs.reduced(tconfigs.get_config(base))
    if name == "dense-mla":
        jc, tc = jc.replace(mla=JMLA(**_mla_kw())), tc.replace(
            mla=TMLA(**_mla_kw()))
    return jc, tc


def _jax_mesh():
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _jax_side(name, toks, paged=False):
    """The JAX single-device engine's greedy tokens (and its params,
    bridged), or with ``paged`` its Scheduler streams on fp32 and int8
    pools."""
    import jax
    import jax.numpy as jnp
    from repro.engine import DecodeEngine as JEngine
    from repro.engine import EngineConfig as JEngineConfig
    from repro_torch import bridge

    jc, tc = _cfgs(name)
    ekw = dict(batch=B, max_len=P + GEN)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_jax_mesh())
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    out = {"generate": np.asarray(want)}
    if paged:
        from repro.engine import Request as JRequest
        from repro.engine import Scheduler as JScheduler
        for kv in ("bf16", "int8"):
            peng = JEngine(jc, JEngineConfig(**PAGED, kv_dtype=kv),
                           params=jeng.params, mesh=_jax_mesh())
            res = _stream(JScheduler, JRequest, peng)[0]
            out[kv] = {k: np.asarray(v) for k, v in res.items()}
    return tc, params, out


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


def _digest(params) -> str:
    h = hashlib.sha256()
    for path, t in leaves(params):
        h.update("/".join(path).encode() + t.numpy().tobytes())
    return h.hexdigest()


def _auto_in_a_world(cache):
    """'auto' with the tuner on, inside a world of ranks: a lookup only
    (nothing measured, no cache file written), the first backend on a
    miss."""
    from repro_torch.kernels import autotune, dispatch
    os.environ.pop("REPRO_AUTOTUNE", None)
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache
    autotune.reset()
    args = ({"wi": torch.randn(64, 128), "wo": torch.randn(128, 64)},
            torch.randn(2, 8, 64), "relu")
    impl = dispatch.resolve("mlp", "auto", args)
    return (impl is dispatch._REGISTRY["mlp"]["cuda"],
            autotune.stats["measured"], os.path.exists(cache))


def _world(mesh, jobs, toks, cache=None):
    """Every job on this rank; the tokens, and what every rank saw."""
    torch.set_num_threads(1)
    out = {}
    if cache is not None:
        out["auto"] = _auto_in_a_world(f"{cache}.{mesh.coord('model')}")
    for key, (cfg, params, shape, ekw) in jobs.items():
        m = mesh if shape == (mesh.axis_size("data"),
                              mesh.axis_size("model")) else \
            make_local_mesh(*shape, device="cpu")
        eng = DecodeEngine(cfg, EngineConfig(**ekw, mesh_shape=shape),
                           params=params, device="cpu", mesh=m)
        got, _ = eng.generate({"tokens": toks}, gen=GEN)
        out[key] = got.numpy()
        if shape == (2, 1):
            out[f"{key}-sampled"] = eng.generate(
                {"tokens": toks}, gen=GEN, temperature=TEMP,
                seed=SEED)[0].numpy()
        if key.endswith("paged"):
            for kv in ("bf16", "int8"):
                peng = DecodeEngine(cfg, EngineConfig(
                    **PAGED, kv_dtype=kv, mesh_shape=shape,
                    decode_shard="seq"), params=params, device="cpu",
                    mesh=m)
                steps = []
                res = _stream(Scheduler, Request, peng, steps)[0]
                out[f"{key}-{kv}"] = {k: np.asarray(v)
                                      for k, v in res.items()}
                out[f"{key}-{kv}-steps"] = steps
    if mesh.size == 2:
        try:
            make_local_mesh(2, 2, device="cpu")
        except ValueError as e:
            out["wrong_world"] = str(e)
        cfg = next(iter(jobs.values()))[0]
        out["digest"] = _digest(DecodeEngine(
            cfg, EngineConfig(batch=1, max_len=8, mesh_shape=(1, 2),
                              decode_shard="seq"),
            device="cpu", mesh=mesh, seed=3).params)
    ranks = mesh.gather_objects(out)
    out["same_on_every_rank"] = all(
        _equal(r[k], out[k]) for r in ranks for k in out)
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def served(monkeypatch_module, tmp_path_factory):
    toks = np.random.default_rng(1).integers(0, 256, (B, P),
                                             dtype=np.int32)
    want, jobs_a, jobs_b = {}, {}, {}
    for name in ("tinyllama-1.1b", "dense-mla", "olmoe-1b-7b"):
        tc, params, w = _jax_side(name, toks, paged=name == "tinyllama-1.1b")
        want[name] = w
        ekw = dict(batch=B, max_len=P + GEN)
        w["sampled"] = DecodeEngine(tc, EngineConfig(**ekw), params=params,
                                    device="cpu").generate(
            {"tokens": toks}, gen=GEN, temperature=TEMP,
            seed=SEED)[0].numpy()
        seq = dict(ekw, decode_shard="seq")
        jobs_a[f"{name}-12"] = (tc, params, (1, 2), seq)
        jobs_a[f"{name}-21"] = (tc, params, (2, 1), ekw)
        if name != "olmoe-1b-7b":
            jobs_b[f"{name}-22"] = (tc, params, (2, 2), seq)
    jobs_a["tinyllama-1.1b-12-paged"] = (
        jobs_a["tinyllama-1.1b-12"][:3]
        + (dict(PAGED, batch=B, n_pages=2 * B * 6, decode_shard="seq"),))
    cache = str(tmp_path_factory.mktemp("tuner") / "autotune.json")
    got = run_ranks(_world, 1, 2, args=(jobs_a, toks, cache),
                    device="cpu", threads=1)
    got.update(run_ranks(_world, 2, 2, args=(jobs_b, toks), device="cpu",
                         threads=1))
    return want, got


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE", "0")
    yield mp
    mp.undo()


@pytest.mark.parametrize("mesh", ["12", "21", "22"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "dense-mla"])
def test_sharded_generate_equals_jax(served, name, mesh):
    want, got = served
    np.testing.assert_array_equal(got[f"{name}-{mesh}"],
                                  want[name]["generate"])


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_moe_seq_generate_equals_jax(served, mesh):
    """olmoe on (1, 2) seq, and on (2, 1), where each decode step's MoE
    group gathers both data ranks' rows (one group, as JAX's)."""
    want, got = served
    np.testing.assert_array_equal(got[f"olmoe-1b-7b-{mesh}"],
                                  want["olmoe-1b-7b"]["generate"])


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "dense-mla",
                                  "olmoe-1b-7b"])
def test_sampled_generate_on_a_data_axis_equals_one_rank(served, name):
    """Sampling on (2, 1) draws for the whole batch on each data rank and
    keeps its rows, so each row's draw is the one a single rank makes
    (not one stream of draws per rank, which would repeat row b's draws
    at row b + B / 2)."""
    want, got = served
    np.testing.assert_array_equal(got[f"{name}-21-sampled"],
                                  want[name]["sampled"])
    assert not np.array_equal(want[name]["sampled"],
                              want[name]["generate"])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_seq_generate_and_stream_equal_jax(served, kv):
    want, got = served
    w = want["tinyllama-1.1b"]
    np.testing.assert_array_equal(got["tinyllama-1.1b-12-paged"],
                                  w["generate"])
    stream = got[f"tinyllama-1.1b-12-paged-{kv}"]
    assert stream.keys() == w[kv].keys()
    for rid in w[kv]:
        np.testing.assert_array_equal(stream[rid], w[kv][rid])
    assert len(got[f"tinyllama-1.1b-12-paged-{kv}-steps"]) > len(STREAM)


def test_ranks_agree_and_build_the_same_params(served):
    _, got = served
    assert got["same_on_every_rank"]
    assert "needs a world of 4 ranks, this one has 2" in got["wrong_world"]
    # 'auto' under a mesh only looks up: no rank measures or writes
    assert got["auto"] == (True, 0, False)
    _, tc = _cfgs("tinyllama-1.1b")
    assert got["digest"] == _digest(DecodeEngine(
        tc, EngineConfig(batch=1, max_len=8), device="cpu",
        seed=3).params)


# ---------------------------------------------------------------- refusals

def _abstract(data, model):
    return Mesh({"data": data, "model": model})


@pytest.mark.parametrize("name,ekw,mesh", [
    ("internvl2-2b", dict(decode_shard="seq"), (1, 1)),
    ("seamless-m4t-large-v2", {}, (1, 2)),
    ("zamba2-1.2b", dict(decode_shard="seq"), (1, 2)),
    ("xlstm-350m", {}, (2, 1)),
    ("tinyllama-1.1b", dict(paged=True, page_size=4), (2, 1)),
    ("dense-mla", {}, (1, 2)),
    ("tinyllama-1.1b", dict(param_strategy="fsdp_tp"), (1, 2)),
    ("tinyllama-1.1b", dict(paged=True, page_size=4, prefix_cache=True,
                            decode_shard="seq"), (1, 2)),
    ("olmoe-1b-7b", dict(paged=True, page_size=4, chunked_prefill=True,
                         chunk_tokens=4, decode_shard="seq"), (1, 1)),
], ids=["vlm", "audio", "hybrid", "ssm", "paged-data", "mla-tp",
        "fsdp_tp", "prefix-seq", "chunked-seq"])
def test_unserved_options_raise_item_14(name, ekw, mesh):
    """MLA and any ``param_strategy`` but 'serve' on a tensor-parallel
    'model' axis (no sequence sharding) are refused too."""
    tc = (_cfgs(name)[1] if name == "dense-mla"
          else tconfigs.reduced(tconfigs.get_config(name)))
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        DecodeEngine(tc, EngineConfig(batch=2, max_len=16, **ekw),
                     device="cpu", mesh=_abstract(*mesh))


def test_scheduler_and_durable_serving_refuse_a_seq_engine(tmp_path):
    """On a seq-sharded engine the prefix cache, chunked prefill and the
    durability hooks raise before the Scheduler allocates anything, and
    ``serve_with_recovery`` before it makes its directory."""
    from repro_torch.runtime.resilience import serve_with_recovery

    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    eng = DecodeEngine(tc, EngineConfig(**PAGED, decode_shard="seq"),
                       device="cpu")
    assert eng.distributed and eng.page_slab == (0, 8)
    for kw in (dict(prefix_cache=True), dict(chunked_prefill=True),
               dict(journal=object()), dict(snapshotter=object())):
        with pytest.raises(NotImplementedError, match="item 14"):
            Scheduler(eng, **kw)
    where = tmp_path / "snaps"
    with pytest.raises(NotImplementedError, match="item 14"):
        serve_with_recovery(eng, str(where), lambda s: None)
    assert not where.exists()


@pytest.mark.parametrize("paged,shape", [(False, (2, 2)), (False, (2, 1)),
                                         (True, (1, 2))])
def test_engine_blocks_are_the_specs_blocks(paged, shape):
    """At every coordinate the engine's rows and slab are the block that
    ``local_block`` cuts from the whole cache under ``cache_pspecs`` /
    ``paged_cache_pspecs``."""
    from repro_torch.dist import sharding as TSH

    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    seq = dict(decode_shard="seq") if shape[1] > 1 else {}
    ekw = (dict(PAGED, batch=4, n_pages=16, **seq) if paged
           else dict(batch=4, max_len=16, **seq))
    params = DecodeEngine(tc, EngineConfig(**ekw), device="cpu").params
    for d in range(shape[0]):
        for m in range(shape[1]):
            mesh = Mesh({"data": shape[0], "model": shape[1]},
                        {"data": d, "model": m})
            eng = DecodeEngine(tc, EngineConfig(**ekw), params=params,
                               device="cpu", mesh=mesh)
            if paged:
                spec = TSH.paged_cache_pspecs(tc, mesh, 4, seq_shard=True,
                                              n_pages=16)["k"]
                whole = torch.arange(2 * 16 * 4).reshape(2, 16, 4)
                p0, pp = eng.page_slab
                want = whole[:, p0:p0 + pp]
            else:
                spec = TSH.cache_pspecs(tc, mesh, 4,
                                        seq_shard=bool(seq))["k"]
                whole = torch.arange(2 * 4 * 16).reshape(2, 4, 16, 1, 1)
                t0, T = eng.seq_slab or (0, 16)
                want = whole[:, eng.rows, t0:t0 + T]
            assert torch.equal(TSH.local_block(whole, spec[:whole.ndim],
                                               mesh), want)
            # the step runs over 'data' only where the rows are split
            assert (eng.step_mesh.axis_size("data") > 1) == (
                eng.rows != slice(0, 4))


def test_engine_checks_and_mesh_construction():
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    with pytest.raises(ValueError, match="max_len=15 divisible"):
        DecodeEngine(tc, EngineConfig(batch=2, max_len=15,
                                      decode_shard="seq"),
                     device="cpu", mesh=_abstract(1, 2))
    with pytest.raises(ValueError, match="n_pages=7 divisible"):
        DecodeEngine(tc, EngineConfig(**dict(PAGED, n_pages=7),
                                      decode_shard="seq"),
                     device="cpu", mesh=_abstract(1, 2))
    # no silent (n, 1) fallback: a mesh without its world raises
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        make_local_mesh(1, 2, device="cpu")
    assert make_local_mesh(1, 1, device="cpu").size == 1


def _raises_on_rank_1(mesh):
    if mesh.coord("model") == 1:
        raise ValueError("rank 1 fails")
    return "ok"


def _stuck(mesh):
    if mesh.coord("model") == 0:
        mesh.all_reduce(torch.zeros(1), "model")
    else:
        time.sleep(30)


@pytest.mark.parametrize("fn,match", [
    (_raises_on_rank_1, "(?s)rank 1 raised.*rank 1 fails"),
    (_stuck, "rank 0 raised")])
def test_run_ranks_fails_with_the_rank_traceback(fn, match):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        run_ranks(fn, 1, 2, device="cpu", timeout_s=3, threads=1)
    assert time.monotonic() - t0 < 30
