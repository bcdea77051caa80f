"""The port's autotuner (``kernels.autotune``) and the 'auto' backend
(``kernels.dispatch``), against the JAX package's.

The cache keys (``cache_key`` and the ``dispatch:<op>`` key of one call)
equal JAX's; ``_measure`` drops its first call and reports the median;
a miss measures and persists, a hit measures nothing, a persist merges
with the file on disk; ``REPRO_AUTOTUNE=0`` gives the rule's plans and
does no file I/O; the plan hooks only look up outside a tuning pass and
measure every retiled plan, uncounted, inside one; 'auto' keeps its
first backend within ``AUTO_MARGIN``; a stale name falls back to
``AUTO_ORDER[0]``;
the plan candidates put the rule's plan first and stay within the
kernels' limits; the roofline terms (``launch.roofline``) equal JAX's
on every arch, over the H100's constants.  Every test that
touches the tuner points ``REPRO_AUTOTUNE_CACHE`` at its own file.
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune, dispatch  # noqa: E402
from repro_torch.kernels import vwr_conv2d as K16  # noqa: E402
from repro_torch.kernels import vwr_matmul as KM  # noqa: E402
from repro_torch.models import lm  # noqa: E402,F401  (registers the ops)


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """Redirect the JSON cache to a tmp file and reset in-memory state."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset()
    yield path
    autotune.reset()


def _both(*shape, dtype=np.float32, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def _calls():
    """(JAX args, kwargs), (port args, kwargs) of one call per op whose
    argument lists the two packages share."""
    jwq, twq = _both(64, 4, 16, seed=1)
    jwk, twk = _both(64, 2, 16, seed=2)
    jwo, two = _both(4, 16, 64, seed=3)
    jx, tx = _both(2, 8, 64, seed=4)
    jo, to = _both(2, 8, 4, 16, seed=5)
    jwi, twi = _both(64, 128, seed=6)
    jwd, twd = _both(128, 64, seed=7)
    jq, tq = _both(2, 4, 16, seed=8)
    jk, tk = _both(2, 32, 2, 16, seed=9)
    jp = {"wq": jwq, "wk": jwk, "wv": jwk, "wo": jwo}
    tp = {"wq": twq, "wk": twk, "wv": twk, "wo": two}
    jm = {"wg": jwi, "wi": jwi, "wo": jwd}
    tm = {"wg": twi, "wi": twi, "wo": twd}
    jx2 = jx.reshape(16, 64)
    tx2 = tx.reshape(16, 64)
    return {
        "qkv_proj": (((jp, jx), {}), ((tp, tx), {})),
        "o_proj": (((jp, jo), {"residual": jx}),
                   ((tp, to), {"residual": tx})),
        "mlp": (((jm, jx, "swiglu"), {"residual": None}),
                ((tm, tx, "swiglu"), {"residual": None})),
        "swiglu": (((jx2.astype(jnp.bfloat16), jwi.astype(jnp.bfloat16),
                     jwi.astype(jnp.bfloat16)), {}),
                   ((tx2.bfloat16(), twi.bfloat16(), twi.bfloat16()), {})),
        # cur_len: a traced 0-d int32 in JAX, a host int in the port
        "decode_partial": (((jq, jk, jk, jnp.int32(20)), {}),
                           ((tq, tk, tk, 20), {})),
    }


@pytest.mark.parametrize("op", sorted(_calls()))
def test_dispatch_key_equals_jax(op):
    (ja, jkw), (ta, tkw) = _calls()[op]
    jshape, jdtype = JD._arg_signature(ja, jkw)
    tshape, tdtype = dispatch._arg_signature(ta, tkw, op)
    assert (tshape, tdtype) == (jshape, jdtype)
    assert autotune.cache_key(f"dispatch:{op}", tshape, tdtype, "cpu") == \
        jautotune.cache_key(f"dispatch:{op}", jshape, jdtype, "cpu")


def test_cache_key_and_static_ints_as_jax():
    for args in (("matmul", (512, 2048, 5632), "bfloat16", "cuda:x"),
                 ("conv", (1, 9, 9, 512, 3, 3, 512), "float32", "cpu"),
                 ("dispatch:mlp", (4, -1, 2, -1), "float32;relu", "cpu")):
        assert autotune.cache_key(*args) == jautotune.cache_key(*args)
    # an int that is not a length stays a static value of the key, as
    # in JAX; a length int reads as a 0-d int32 operand
    jx, tx = _both(4, 8)
    assert dispatch._arg_signature((tx, 5, True), {}, "mlp") == \
        JD._arg_signature((jx, 5, True), {})
    assert dispatch._arg_signature((tx, tx, tx, 7), {"pos0": 3},
                                   "decode_partial") == \
        JD._arg_signature((jx, jx, jx, jnp.int32(7)),
                          {"pos0": jnp.int32(3)})
    # the key of a decode step does not change with the step
    assert dispatch._arg_signature((tx, tx, tx, 7), {}, "decode_partial") \
        == dispatch._arg_signature((tx, tx, tx, 8), {}, "decode_partial")


def test_measure_drops_first_call_and_reports_median(monkeypatch):
    clock = iter([0.0, 5e-6, 10.0, 10.000001, 20.0, 20.000004,
                  30.0, 30.000002, 40.0, 40.000003])
    monkeypatch.setattr(autotune.time, "perf_counter", lambda: next(clock))
    log = []
    us = autotune._measure(lambda: log.append("run"), reps=5,
                           sync=lambda: log.append("sync"))
    # one discarded call, then 5 timed ones, each with the device
    # waited on before it starts and before it is read
    assert log == ["run"] + ["sync", "run", "sync"] * 5
    assert us == pytest.approx(3.0)      # median of 5, 1, 4, 2, 3 us
    # a device clock times each call in place of the host clock
    times = iter([4e-6, 9e-6, 1e-6, 7e-6, 2e-6])
    log.clear()

    def clock(run):
        run()
        return next(times)

    us = autotune._measure(lambda: log.append("run"), reps=5, clock=clock)
    assert log == ["run"] * 6 and us == pytest.approx(4.0)
    assert autotune.device_clock("cpu") is None
    assert autotune.device_sync("cpu") is None


def test_miss_measures_and_persists_hit_measures_nothing(tuner,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_TOPK", "3")
    autotune.reset()
    runs = []

    def runner(cand):
        return lambda: runs.append(cand)

    kw = dict(candidates=lambda: [(2,), (3,), (1,), (4,)],
              prior=lambda c: (float(c[0]), 0.5), runner=runner,
              first=(4,))
    got = autotune.get_blocks("op", (8, 16), "bfloat16", "cpu", **kw)
    assert autotune.stats == {"hits": 0, "misses": 1, "measured": 3}
    # the rule's candidate is measured first, then the prior's order
    assert [c for c in dict.fromkeys(runs)] == [(4,), (1,), (2,)]
    assert got in {(4,), (1,), (2,)}
    entry, = json.load(open(tuner)).values()
    assert set(entry) == {"blocks", "us", "prior_t_s",
                          "prior_e_fj_per_bit", "measured"}
    assert tuple(entry["blocks"]) == got and entry["measured"] == 3
    assert len(autotune.measurements) == 3
    n = len(runs)
    assert autotune.get_blocks("op", (8, 16), "bfloat16", "cpu",
                               **kw) == got
    autotune.reset()                     # a new process reads the file
    assert autotune.get_blocks("op", (8, 16), "bfloat16", "cpu",
                               **kw) == got
    assert len(runs) == n and autotune.stats["misses"] == 0
    assert autotune.stats["hits"] == 1


def test_autotune_off_gives_the_rules_and_no_file_io(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune.reset()                     # the knobs are read once
    x = torch.zeros(4, 2048, dtype=torch.bfloat16)
    w = torch.zeros(2048, 5632, dtype=torch.bfloat16)
    assert autotune.matmul_plan("splitk", x, w, None, None, None) == \
        KM.splitk_plan(4, 5632, 2048)
    x = torch.zeros(512, 2048, dtype=torch.bfloat16)
    assert autotune.matmul_plan("wgmma", x, w, None, None, None) == \
        KM.tile_plan(512, 5632, 2048)
    assert autotune.swiglu_plan(x, w, w) == \
        KM.swiglu_tile_plan(512, 5632, 2048)
    xc = torch.zeros(32, 30, 30, 128, dtype=torch.bfloat16)
    wc = torch.zeros(3, 3, 128, 128, dtype=torch.bfloat16)
    assert autotune.conv_plan(xc, wc, None, "relu") == \
        K16.plan(32, 30, 30, 128, 3, 3, 128)

    def no_io(*a, **k):
        raise AssertionError("file I/O with the tuner off")

    monkeypatch.setattr(autotune, "_load", no_io)
    monkeypatch.setattr(autotune, "_persist", no_io)
    assert autotune.get_blocks("op", (1,), "float32", "cpu",
                               candidates=[(1,), (2,)],
                               prior=lambda c: (float(-c[0]), 0.0),
                               runner=None) == (2,)
    x = torch.randn(2, 8, 64)
    p = {"wi": torch.randn(64, 128), "wo": torch.randn(128, 64)}
    assert dispatch._resolve_auto("mlp", dispatch._REGISTRY["mlp"],
                                  (p, x, "relu"), {}) == "cuda"
    assert autotune.stats == {"hits": 0, "misses": 0, "measured": 0}
    assert not os.path.exists(tuner)


def test_split_k_keeps_its_rule_with_the_tuner_on(tuner):
    """Split-K's plan is its K split: tuning it would change the sums."""
    x = torch.zeros(4, 2048, dtype=torch.bfloat16)
    w = torch.zeros(2048, 5632, dtype=torch.bfloat16)
    assert autotune.matmul_plan("splitk", x, w, None, None, None) == \
        KM.splitk_plan(4, 5632, 2048)
    assert autotune.stats == {"hits": 0, "misses": 0, "measured": 0}


def test_cpu_tensors_never_reach_the_tuner(tuner):
    x = torch.randn(8, 64).bfloat16()
    w = torch.randn(64, 64).bfloat16()
    KM.vwr_matmul(x, w)
    KM.vwr_swiglu(x, w, w)
    K16.vwr_conv2d(torch.randn(1, 6, 6, 8).bfloat16(),
                   torch.randn(3, 3, 8, 8).bfloat16())
    assert autotune.stats == {"hits": 0, "misses": 0, "measured": 0}
    assert not os.path.exists(tuner)


def test_knobs_are_read_once_a_process_until_reset(tuner, monkeypatch):
    assert autotune.enabled() and autotune.cache_path() == tuner
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", tuner + ".other")
    assert autotune.enabled() and autotune.cache_path() == tuner
    autotune.reset()
    assert not autotune.enabled()
    assert autotune.cache_path() == tuner + ".other"


def _wgmma_operands():
    x = torch.zeros(512, 2048, dtype=torch.bfloat16)
    w = torch.zeros(2048, 5632, dtype=torch.bfloat16)
    return x, w, KM.tile_plan(512, 5632, 2048)


def test_plan_hooks_only_look_up_outside_a_tuning_pass(tuner, monkeypatch):
    """Serving never measures a plan: a hook gives a persisted plan, else
    the rule's, with no measurement and no write."""
    x, w, rule = _wgmma_operands()

    def no_launch(*a, **k):
        raise AssertionError("a plan was measured outside tuning()")

    monkeypatch.setattr(KM, "launch", no_launch)
    for _ in range(2):
        assert autotune.matmul_plan("wgmma", x, w, None, None, None) == rule
    assert autotune.stats == {"hits": 0, "misses": 0, "measured": 0}
    assert not os.path.exists(tuner)
    other = autotune.retiled(rule, autotune.ROW_TILES)[1]
    key = autotune.cache_key("matmul.wgmma", (512, 2048, 5632), "bfloat16",
                             "cpu")
    json.dump({key: {"blocks": list(other), "us": 1.0}}, open(tuner, "w"))
    autotune.reset()                     # a new process reads the file
    assert autotune.matmul_plan("wgmma", x, w, None, None, None) == other
    assert autotune.stats == {"hits": 1, "misses": 0, "measured": 0}


def test_a_tuning_pass_measures_every_retiled_plan_uncounted(tuner,
                                                             monkeypatch):
    from repro_torch.kernels import build

    x, w, rule = _wgmma_operands()
    runs = []

    def fake_launch(x, w, bias, residual, activation, kind, plan=None):
        runs.append(plan)
        build.count_launch("vwr_matmul", kind)

    monkeypatch.setattr(KM, "launch", fake_launch)
    before = dict(build.LAUNCHES)
    with autotune.tuning():
        got = autotune.matmul_plan("wgmma", x, w, None, None, None)
    tuned = autotune.retiled(rule, autotune.ROW_TILES)
    assert list(dict.fromkeys(runs)) == list(tuned) and got in tuned
    assert build.LAUNCHES == before      # the tuner's launches: uncounted
    assert autotune.stats == {"hits": 0, "misses": 1,
                              "measured": len(tuned)}
    entry, = json.load(open(tuner)).values()
    assert entry["measured"] == len(tuned) and entry["prior_t_s"] > 0
    n = len(runs)
    with autotune.tuning():              # a hit measures nothing
        assert autotune.matmul_plan("wgmma", x, w, None, None, None) == got
    assert len(runs) == n


@pytest.mark.parametrize("times,winner", [([100.0, 95.0], "cuda"),
                                          ([100.0, 85.0], "torch"),
                                          ([80.0, 100.0], "cuda")])
def test_auto_keeps_the_first_backend_within_the_margin(tuner, monkeypatch,
                                                        times, winner):
    args, key = _mlp_call()
    monkeypatch.setattr(autotune, "_measure_all",
                        lambda runs, **kw: list(times))
    assert dispatch.AUTO_MARGIN == 0.10
    assert dispatch.resolve("mlp", "auto", args) is \
        dispatch._REGISTRY["mlp"][winner]
    assert json.load(open(tuner))[key]["blocks"] == [winner]


def test_measure_all_takes_turns_and_reports_each_median():
    log = []
    runs = [lambda: log.append("a"), lambda: log.append("b")]
    times = iter([3e-6, 1e-6, 1e-6, 2e-6, 2e-6, 3e-6])

    def clock(run):
        run()
        return next(times)

    us = autotune._measure_all(runs, reps=3, clock=clock)
    assert "".join(log) == "ab" + "ab" * 3
    assert us == [pytest.approx(2.0), pytest.approx(2.0)]


def test_persist_merges_with_the_file_on_disk(tuner):
    table = autotune._load(tuner)
    table["a"] = {"blocks": [1]}
    autotune._persist(tuner, table)
    # another process adds an entry behind this one's back
    on_disk = json.load(open(tuner))
    on_disk["b"] = {"blocks": [2]}
    json.dump(on_disk, open(tuner, "w"))
    table["c"] = {"blocks": [3]}
    autotune._persist(tuner, table)
    assert set(json.load(open(tuner))) == {"a", "b", "c"}
    assert set(autotune._load(tuner)) == {"a", "b", "c"}


def _mlp_call():
    x = torch.randn(2, 8, 64)
    p = {"wi": torch.randn(64, 128), "wo": torch.randn(128, 64)}
    args = (p, x, "relu")
    shape, dtype = dispatch._arg_signature(args, {}, "mlp")
    key = autotune.cache_key("dispatch:mlp", shape, dtype, "cpu")
    return args, key


def test_auto_measures_persists_and_hits_by_name(tuner):
    args, key = _mlp_call()
    impl = dispatch.resolve("mlp", "auto", args)
    assert autotune.stats["misses"] == 1 and autotune.stats["measured"] == 2
    name, = json.load(open(tuner))[key]["blocks"]
    assert name in ("cuda", "torch")
    assert impl is dispatch._REGISTRY["mlp"][name]
    torch.testing.assert_close(dispatch.dispatch("mlp", "auto", *args),
                               dispatch.dispatch("mlp", "torch", *args))
    assert autotune.stats["measured"] == 2 and autotune.stats["hits"] >= 1
    assert dispatch.cached_backend("mlp", "auto", args) == name
    assert dispatch.cached_backend("mlp", "cuda", args) == "cuda"


def test_stale_name_falls_back_to_the_first_backend(tuner):
    args, key = _mlp_call()
    json.dump({key: {"blocks": ["pallas"], "us": 1.0}}, open(tuner, "w"))
    assert dispatch._resolve_auto("mlp", dispatch._REGISTRY["mlp"],
                                  args, {}) == dispatch.AUTO_ORDER[0]
    assert dispatch.cached_backend("mlp", "auto", args) == "cuda"
    assert autotune.stats["measured"] == 0


def test_a_failing_backend_raises_under_auto(tuner, monkeypatch):
    """No hidden fallback: 'auto' does not pick 'torch' because the
    kernel path raised while it was measured."""
    args, _ = _mlp_call()

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setitem(dispatch._REGISTRY["mlp"], "cuda", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        dispatch.dispatch("mlp", "auto", *args)


def test_training_backend_narrows_auto_to_torch():
    assert dispatch.training_backend("auto") == "torch"
    with pytest.raises(ValueError, match="forward-only"):
        dispatch.training_backend("cuda")


@pytest.mark.parametrize("kind,M,N,K", [
    ("wgmma", 512, 2048, 5632), ("wgmma", 512, 256, 2048),
    ("wgmma", 72, 2048, 5632), ("wgmma", 8, 5632, 2048),
    ("splitk", 4, 2048, 5632), ("splitk", 1, 7168, 18432),
    ("splitk", 2, 72, 104)])
def test_matmul_candidates_rule_first_and_legal(kind, M, N, K):
    cands = autotune.matmul_candidates(kind, M, N, K)
    rule = (KM.splitk_plan if kind == "splitk" else KM.tile_plan)(M, N, K)
    assert cands[0] == rule and len(set(cands)) == len(cands)
    for plan in cands:
        if kind == "wgmma":
            bm, nsplit, kt_split = plan
            kt = -(-K // KM.TILE_BK)
            assert bm in (64, 128) and (nsplit - 1) * kt_split < kt
            assert nsplit * kt_split >= kt
        else:
            mt, nsplit, ksplit = plan
            assert mt == rule[0] and ksplit % 16 == 0 and ksplit >= 64
            assert ksplit * mt <= KM.SPLITK_X_FLOATS
            assert nsplit == -(-K // ksplit)
    if kind == "wgmma":
        tuned = autotune.retiled(rule, autotune.ROW_TILES)
        assert tuned[0] == rule and {p[0] for p in tuned} == {64, 128}
        assert {p[1:] for p in tuned} == {rule[1:]}


@pytest.mark.parametrize("M,N,K", [(512, 5632, 2048), (72, 5632, 2048),
                                   (4, 5632, 2048), (1, 18432, 7168)])
def test_swiglu_candidates_rule_first_and_legal(M, N, K):
    cands = autotune.swiglu_candidates(M, N, K)
    assert cands[0] == KM.swiglu_tile_plan(M, N, K)
    kt = -(-K // KM.TILE_BK)
    for bm, bn, nsplit, kt_split in cands:
        assert bm in (64, 128) and bn in KM.SWIGLU_TILE_BNS
        assert nsplit * kt_split >= kt > (nsplit - 1) * kt_split
        assert M <= 128 or nsplit == 1
    # the tuner's: every tile on the rule's K split, the rule first
    tuned = autotune.retiled(cands[0], autotune.TILES)
    assert tuned[0] == cands[0] and len(set(tuned)) == 4
    assert {p[1] for p in tuned} == set(KM.SWIGLU_TILE_BNS)
    assert {p[2:] for p in tuned} == {cands[0][2:]}


@pytest.mark.parametrize("N,H,W,C,KH,F", [(32, 30, 30, 128, 3, 128),
                                          (1, 9, 9, 512, 3, 512),
                                          (1, 31, 31, 96, 5, 256)])
def test_conv_candidates_rule_first_and_legal(N, H, W, C, KH, F):
    cands = autotune.conv_candidates(N, H, W, C, KH, KH, F)
    assert cands[0] == K16.plan(N, H, W, C, KH, KH, F)
    kt = KH * KH * -(-C // K16.SLICE)
    for plan in cands:
        bm, bn, nsplit, kt_split = plan
        assert K16.smem_bytes(bm, bn) <= K16.SMEM_LIMIT
        assert nsplit * kt_split >= kt > (nsplit - 1) * kt_split
    for plan in autotune.retiled(cands[0], autotune.TILES):
        assert plan[2:] == cands[0][2:]
        assert K16.smem_bytes(*plan[:2]) <= K16.SMEM_LIMIT


def test_backend_tags_dtype_names_and_default_path(monkeypatch):
    assert autotune.backend_tag("cpu") == "cpu"
    assert autotune.dtype_name(torch.bfloat16) == "bfloat16"
    assert autotune.dtype_name(torch.int32) == "int32"
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    autotune.reset()
    # apart from the JAX package's ~/.cache/repro/autotune.json
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")
    autotune.reset()


# ---------------------------------------------------------------- roofline

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_roofline_terms_match_jax(name, kind):
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as troof
    shape = types.SimpleNamespace(name=kind, kind=kind, global_batch=4,
                                  seq_len=256)
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    for fn in ("model_flops", "attention_flops", "analytic_traffic"):
        assert getattr(troof, fn)(tcfg, shape) == \
            getattr(jroof, fn)(jcfg, shape), fn
    rec = {"flops": 2e15, "bytes_accessed": 3e12, "collective_bytes": 1e9}
    r = troof.build_roofline(tcfg, shape, rec)
    # one H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s HBM3, 50 GB/s a link
    assert r.chips == 1
    assert r.t_comp == pytest.approx(2e15 / troof.PEAK_FLOPS[
        "float32" if tcfg.dtype == "float32" else "bfloat16"])
    assert r.t_mem == pytest.approx(3e12 / 3.35e12)
    assert r.t_coll == pytest.approx(1e9 / 50e9)
    assert r.row()["dominant"] == "compute" and r.step_time == r.t_comp
