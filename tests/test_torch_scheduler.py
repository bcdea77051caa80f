"""The port's continuous-batching Scheduler.

Against the JAX Scheduler: the same greedy token streams for reduced
tinyllama (GQA) and qwen (MHA, bias), with model-dtype ('bf16', fp32
here) and int8 pools, over staggered submissions with slot reuse and a
pool small enough to force a preemption, with bucketed and fixed-width
tables.  The JAX side runs on an explicit (1, 1) mesh with Auto axes
(its default mesh fails under JAX 0.9, ROADMAP queue 3).

Then the port counterparts of the lifecycle cases of
``tests/test_paged.py`` and ``tests/test_resilience.py``, each held
against the port's own fault-free run: rejection without losing
results, waiting for pages, a full-budget prompt, preemption, parking,
cancel, deadlines, ``max_steps``, NaN/inf quarantine with the
survivors bit-identical, transient retry heal and exhaustion, a prefill
fault, pool pressure, allocator invariants, the monitors, and sampled
determinism (sampling is the port's own: JAX's ``fold_in`` keys cannot
be reproduced, ROADMAP queue 3).
"""
import json

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import Scheduler as JScheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                PageAllocator, PagePoolExhausted, Request,
                                RequestResult, RequestStatus, Scheduler)
from repro_torch.engine import faults as F  # noqa: E402
from repro_torch.engine import scheduler as S  # noqa: E402
from repro_torch.runtime.resilience import (Heartbeat,  # noqa: E402
                                            RetryPolicy, StragglerMonitor,
                                            call_with_retries, percentiles)

P, G = 8, 6


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


# ------------------------------------------------- against JAX

# (prompt length, gen): request 0 runs two steps alone, then 1 and 2
# arrive; 2 slots and 7 pages of 4 make growth preempt, and request 2
# reuses a retired slot
STREAM = [(3, 12), (5, 10), (9, 6)]


def _stream(sched_cls, req_cls, eng, seed=0, **kw):
    rng = np.random.default_rng(seed)
    specs = [(rng.integers(0, 512, p).astype(np.int32), g)
             for p, g in STREAM]
    sched = sched_cls(eng, **kw)
    sched.submit(req_cls(rid=0, tokens=specs[0][0], gen=specs[0][1]))
    sched.admit()
    sched.step()
    sched.step()
    for i in (1, 2):
        sched.submit(req_cls(rid=i, tokens=specs[i][0], gen=specs[i][1]))
    return sched.run(), sched


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-0.5b"])
def test_scheduler_streams_match_jax(name, kv_dtype):
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    ekw = dict(batch=2, max_len=24, paged=True, page_size=4, n_pages=7,
               kv_dtype=kv_dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=mesh)
    want, jsched = _stream(JScheduler, JRequest, jeng)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    for bucket in (True, False):
        got, sched = _stream(Scheduler, Request, eng, bucket_tables=bucket)
        assert set(got) == set(want)
        for rid in want:
            assert got[rid].status is RequestStatus.FINISHED
            np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                          err_msg=f"rid {rid}")
        for key in ("preempted", "prefills", "steps", "peak_pages"):
            assert sched.stats[key] == jsched.stats[key], key
        assert sched.stats["preempted"] > 0
        widths = sched.stats["table_widths"]
        if bucket:
            assert widths == jsched.stats["table_widths"]
            assert len(widths) > 1
        else:
            assert set(widths) == {eng.max_pages}
        _drained(sched, eng)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "olmoe-1b-7b"])
def test_moe_scheduler_streams_match_jax(name, kv_dtype):
    """The moe family through the Scheduler: reduced deepseek-v3 on MLA
    latent pools (kernels 11 and 13's plain versions) and reduced olmoe
    on GQA pools, model-dtype and int8, the same stream as above (a
    preemption, slot reuse).  The MoE FFN runs every slot as one decode
    group, inactive slots included, as the JAX step does."""
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    ekw = dict(batch=2, max_len=24, paged=True, page_size=4, n_pages=7,
               kv_dtype=kv_dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=mesh)
    # fixed-width tables: one compiled JAX step, not one a bucket
    want, jsched = _stream(JScheduler, JRequest, jeng, bucket_tables=False)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    got, sched = _stream(Scheduler, Request, eng, bucket_tables=False)
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].status is RequestStatus.FINISHED
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    for key in ("preempted", "prefills", "steps", "peak_pages",
                "table_widths"):
        assert sched.stats[key] == jsched.stats[key], key
    assert sched.stats["preempted"] > 0
    _drained(sched, eng)


@pytest.mark.parametrize("mode", ["prefix_cache", "chunked_prefill"])
def test_moe_scheduler_serves_prefix_and_chunked(mode):
    """The moe family's prefix cache and chunked prefill, on reduced olmoe
    (the moe family with GQA pools; the MLA configs run in
    ``test_torch_prefix_cache.py`` and ``test_torch_chunked.py``): the
    Scheduler turned on by argument serves the JAX Scheduler's greedy
    streams over requests that share a two-page prompt, with the same
    counters, and an engine with the mode as its default serves too."""
    jc = jconfigs.reduced(jconfigs.get_config("olmoe-1b-7b"))
    tc = tconfigs.reduced(tconfigs.get_config("olmoe-1b-7b"))
    ekw = dict(batch=2, max_len=24, paged=True, page_size=4, n_pages=16,
               chunk_tokens=4)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=mesh)
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=bridge.from_jax(jax.tree.map(
                           np.asarray, jeng.params), "cpu"), device="cpu")
    assert callable(eng.suffix_prefill_fn) and callable(eng.mixed_fn)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 512, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n)]).astype(
        np.int32) for n in (3, 1, 6)]

    def run(sched):
        for i, p in enumerate(prompts):
            sched.submit((JRequest if isinstance(sched, JScheduler)
                          else Request)(rid=i, tokens=p, gen=5))
        return sched.run(), sched

    want, jsched = run(JScheduler(jeng, bucket_tables=False,
                                  **{mode: True}))
    default = DecodeEngine(tc, EngineConfig(**ekw, **{mode: True}),
                           params=eng.params, device="cpu")
    for e in (eng, default):
        got, sched = run(Scheduler(e, bucket_tables=False,
                                   **({mode: True} if e is eng else {})))
        for rid in want:
            assert got[rid].status is RequestStatus.FINISHED
            np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                          err_msg=f"rid {rid}")
        for key in ("prefix_hits", "prefix_hit_tokens", "chunks",
                    "mixed_steps", "prefills", "steps"):
            assert sched.stats[key] == jsched.stats[key], key
        assert sched.stats["prefix_hits" if mode == "prefix_cache"
                           else "chunks"] > 0
        sched.allocator.check()


# ------------------------------------------------- lifecycle (port)

def _cfg(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                dtype="float32", remat="none", attn_block_q=32,
                attn_block_kv=32)
    base.update(kw)
    return ModelConfig(**base)


def _engine(batch=2, max_len=16, page_size=4, n_pages=8, **kw):
    return DecodeEngine(_cfg(), EngineConfig(
        batch=batch, max_len=max_len, paged=True, page_size=page_size,
        n_pages=n_pages, **kw), device="cpu", seed=0)


@pytest.fixture(scope="module")
def eng():
    return _engine()


def _reqs(cfg, gens=(G, G, 4), **kw):
    rng = np.random.default_rng(7)
    return [Request(rid=i, tokens=rng.integers(
                2, cfg.vocab, (P,)).astype(np.int32), gen=g, **kw)
            for i, g in enumerate(gens)]


def _run(eng, reqs, **sched_kw):
    sched = Scheduler(eng, **sched_kw)
    for r in reqs:
        sched.submit(r)
    return sched.run(), sched


@pytest.fixture(scope="module")
def baseline(eng):
    """Fault-free streams of the standard 3-request set."""
    out, _ = _run(eng, _reqs(eng.cfg))
    return {rid: np.asarray(res) for rid, res in out.items()}


def _drained(sched, eng):
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()


def _solo(eng, req):
    """The request alone through the port's dense engine."""
    solo = DecodeEngine(eng.cfg, EngineConfig(batch=1,
                                              max_len=eng.ecfg.max_len),
                        params=eng.params, device="cpu")
    out, _ = solo.generate({"tokens": torch.from_numpy(req.tokens)[None]},
                           gen=req.gen)
    return out[0].numpy()


def test_scheduler_needs_a_paged_engine_and_refuses_unported_modes(eng):
    dense = DecodeEngine(_cfg(), EngineConfig(batch=1, max_len=8),
                         device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Scheduler(dense)
    # durable serving is served: the journal and the snapshotter are
    # taken and kept (tests/test_torch_snapshot.py drives them)
    journal, snapshotter = object(), object()
    sched = Scheduler(eng, journal=journal, snapshotter=snapshotter)
    assert sched.journal is journal and sched.snapshotter is snapshotter
    # the prefix cache and chunked prefill are served: the constructor
    # takes them, with the JAX Scheduler's checks
    sched = Scheduler(eng, prefix_cache=True, chunked_prefill=True)
    assert sched.prefix is not None and sched.chunked
    assert sched.chunk_tokens == eng.ecfg.chunk_tokens
    assert sched.token_budget == eng.ecfg.batch + eng.ecfg.chunk_tokens
    odd = DecodeEngine(_cfg(), eng.ecfg.replace(chunk_tokens=6),
                       params=eng.params, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        Scheduler(odd, chunked_prefill=True)


def test_slot_reuse_and_no_reprefill(eng):
    """3 requests over 2 slots: the third admits into a retired slot,
    one prefill per request, every stream equals a solo run."""
    reqs = _reqs(eng.cfg, gens=(3, 7, 5))
    sched = Scheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.admit()
    assert sched.n_active == 2 and len(sched.pending) == 1
    out = sched.run()
    assert sched.stats["prefills"] == 3 and sched.stats["retired"] == 3
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], _solo(eng, r))
    _drained(sched, eng)


def test_rejects_unadmittable_without_losing_results():
    eng = _engine(batch=1, max_len=16, n_pages=2)
    good = _reqs(eng.cfg, gens=(3,))[0]
    good.tokens = good.tokens[:4]
    sched = Scheduler(eng)
    sched.submit(good)
    sched.submit(Request(rid="huge", tokens=np.zeros(12, np.int32),
                         gen=2))
    out = sched.run()                   # does not raise
    assert out[0].status is RequestStatus.FINISHED and len(out[0]) == 3
    assert out["huge"].status is RequestStatus.REJECTED
    assert "pool" in out["huge"].error and len(out["huge"]) == 0
    np.testing.assert_array_equal(out[0], _solo(eng, good))
    _drained(sched, eng)


def test_waits_for_pages_then_admits():
    eng = _engine(max_len=P + 4, n_pages=3)
    reqs = _reqs(eng.cfg, gens=(2, 2))
    sched = Scheduler(eng)
    for r in reqs:
        sched.submit(r)
    sched.admit()
    assert sched.n_active == 1          # the second waits on pages
    out = sched.run()
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], _solo(eng, r))
    _drained(sched, eng)


def test_full_budget_prompt_fits_table():
    """P == max_len, a page multiple, gen 1: no page is reserved for a
    decode write that never comes."""
    eng = _engine(max_len=16, page_size=8, n_pages=None)
    req = Request(rid=0, tokens=np.arange(16, dtype=np.int32) % 200,
                  gen=1)
    out, sched = _run(eng, [req])
    np.testing.assert_array_equal(out[0], _solo(eng, req))
    _drained(sched, eng)


@pytest.mark.parametrize("max_preemptions", [3, 0])
def test_preempts_instead_of_dying_and_parks(max_preemptions):
    """Growth on a dry pool preempts the latest-admitted slot; with
    max_preemptions=0 the victim is parked until the pool quiets.
    Every request completes with its solo stream."""
    eng = _engine(max_len=P + 16, page_size=8, n_pages=4)
    reqs = _reqs(eng.cfg, gens=(16, 16))
    out, sched = _run(eng, reqs, max_preemptions=max_preemptions)
    assert sched.stats["preempted"] > 0
    assert (sched.stats["parked"] > 0) == (max_preemptions == 0)
    for r in reqs:
        assert out[r.rid].status is RequestStatus.FINISHED
        np.testing.assert_array_equal(out[r.rid], _solo(eng, r))
    _drained(sched, eng)


def test_nan_logits_quarantine_only_affected_slot(eng, baseline):
    reqs = _reqs(eng.cfg)
    sched = Scheduler(eng)
    proxy = F.inject(sched,
                     decode_faults=[F.NonFiniteLogits(step=2, slot=0)])
    for r in reqs:
        sched.submit(r)
    out = sched.run()
    assert proxy.decode_fn.injected == 1
    assert out[0].status is RequestStatus.FAILED
    assert "non-finite" in out[0].error
    np.testing.assert_array_equal(out[0], baseline[0][:3])
    for rid in (1, 2):
        assert out[rid].status is RequestStatus.FINISHED
        np.testing.assert_array_equal(out[rid], baseline[rid])
    _drained(sched, eng)


def test_inf_logits_also_quarantined(eng):
    sched = Scheduler(eng)
    F.inject(sched, decode_faults=[
        F.NonFiniteLogits(step=1, slot=0, value=float("inf"))])
    for r in _reqs(eng.cfg, gens=(G,)):
        sched.submit(r)
    assert sched.run()[0].status is RequestStatus.FAILED
    _drained(sched, eng)


def test_transient_step_fault_retried_bit_identical(eng, baseline):
    sched = Scheduler(eng, retry=RetryPolicy(max_retries=2,
                                             backoff_s=0.0))
    F.inject(sched, decode_faults=[F.TransientError(step=1)])
    for r in _reqs(eng.cfg):
        sched.submit(r)
    out = sched.run()
    assert sched.stats["step_retries"] == 1
    for rid, want in baseline.items():
        np.testing.assert_array_equal(out[rid], want)
    _drained(sched, eng)


def test_persistent_step_fault_exhausts_retries(eng):
    sched = Scheduler(eng, retry=RetryPolicy(max_retries=2,
                                             backoff_s=0.0))
    F.inject(sched, decode_faults=[F.TransientError(step=1, count=50)])
    for r in _reqs(eng.cfg, gens=(G,)):
        sched.submit(r)
    with pytest.raises(F.InjectedFault):
        sched.run()
    assert sched.stats["step_retries"] == 2


def test_crash_fault_escapes_the_step_retry(eng):
    sched = Scheduler(eng)
    F.inject(sched, decode_faults=[F.CrashFault(step=1)])
    for r in _reqs(eng.cfg, gens=(G,)):
        sched.submit(r)
    with pytest.raises(F.CrashError):
        sched.run()
    assert sched.stats["step_retries"] == 0


def test_prefill_fault_fails_request_not_stream(eng, baseline):
    sched = Scheduler(eng, retry=RetryPolicy(max_retries=2,
                                             backoff_s=0.0))
    # prefill call 0 = rid 0; calls 1..3 = rid 1's three attempts
    F.inject(sched, prefill_faults=[F.TransientError(step=1, count=3)])
    for r in _reqs(eng.cfg):
        sched.submit(r)
    out = sched.run()
    assert out[1].status is RequestStatus.FAILED
    assert "prefill failed" in out[1].error and len(out[1]) == 0
    assert sched.stats["prefill_retries"] == 2
    for rid in (0, 2):
        np.testing.assert_array_equal(out[rid], baseline[rid])
    _drained(sched, eng)


def test_pool_pressure_serializes_and_completes(eng, baseline):
    sched = Scheduler(eng)
    release = F.hold_pages(sched, 4)
    for r in _reqs(eng.cfg):
        sched.submit(r)
    out = sched.run()
    for rid, want in baseline.items():
        np.testing.assert_array_equal(out[rid], want)
    assert sched.stats["peak_pages"] <= 8
    assert sched.allocator.free_pages == eng.n_pages - 4
    release()
    release()                           # idempotent
    _drained(sched, eng)


def test_over_budget_request_rejected_mid_stream(eng, baseline):
    reqs = _reqs(eng.cfg)
    bad = Request(rid="bad", tokens=reqs[0].tokens.copy(), gen=64)
    out, sched = _run(eng, [reqs[0], bad, reqs[1], reqs[2]])
    assert out["bad"].status is RequestStatus.REJECTED
    assert "exceeds engine max_len" in out["bad"].error
    for rid, want in baseline.items():
        np.testing.assert_array_equal(out[rid], want)
    _drained(sched, eng)


def test_cancel_pending_and_mid_flight(eng, baseline):
    sched = Scheduler(eng)
    for r in _reqs(eng.cfg):
        sched.submit(r)
    sched.admit()
    assert sched.cancel(2)              # still queued
    assert sched.finished[2].status is RequestStatus.CANCELLED
    assert "pending" in sched.finished[2].error
    sched.step()
    sched.step()
    assert sched.cancel(1)              # mid-flight
    np.testing.assert_array_equal(sched.finished[1], baseline[1][:3])
    assert not sched.cancel(1) and not sched.cancel("nope")
    out = sched.run()
    np.testing.assert_array_equal(out[0], baseline[0])
    assert sched.stats["cancelled"] == 2
    _drained(sched, eng)


def test_deadline_while_queued_times_out_without_prefill(eng):
    reqs = _reqs(eng.cfg, gens=(G,))
    reqs[0].deadline_s = 1e-9
    out, sched = _run(eng, reqs)
    assert out[0].status is RequestStatus.TIMED_OUT
    assert "while queued" in out[0].error
    assert sched.stats["prefills"] == 0
    _drained(sched, eng)


def test_max_steps_bounds_a_request(eng, baseline):
    reqs = _reqs(eng.cfg, gens=(G, G))
    reqs[0].max_steps = 2
    out, sched = _run(eng, reqs)
    assert out[0].status is RequestStatus.TIMED_OUT
    assert "max_steps" in out[0].error
    np.testing.assert_array_equal(out[0], baseline[0][:3])
    np.testing.assert_array_equal(out[1], baseline[1])
    _drained(sched, eng)


def test_wall_deadline_mid_flight(eng):
    reqs = _reqs(eng.cfg, gens=(G,))
    reqs[0].deadline_s = 0.15
    sched = Scheduler(eng)
    F.inject(sched, decode_faults=[F.SlowStep(step=1, delay_s=0.5)])
    for r in reqs:
        sched.submit(r)
    out = sched.run()
    assert out[0].status is RequestStatus.TIMED_OUT and len(out[0]) < G
    _drained(sched, eng)


def test_status_machine_and_result_surface(eng):
    req = _reqs(eng.cfg, gens=(3,))[0]
    sched = Scheduler(eng)
    sched.submit(req)
    sched.admit()
    assert req.status is RequestStatus.RUNNING
    res = sched.run()[req.rid]
    assert req.status is RequestStatus.FINISHED
    assert isinstance(res, RequestResult) and res.ok and res.error is None
    assert res.latency_s >= 0 and isinstance(res.tokens, np.ndarray)
    assert "FINISHED" in repr(res)
    assert res[:2].status is RequestStatus.FINISHED
    assert len(res.token_times) == 3
    assert set(sched.latency_percentiles()) == {"p50", "p90", "p99"}
    assert set(sched.itl_percentiles()) == {"p50", "p90", "p99"}


def test_straggler_flag_and_heartbeat(eng, tmp_path):
    hb_path = str(tmp_path / "hb.json")
    sched = Scheduler(
        eng, straggler=StragglerMonitor(window=16, threshold=3.0, warmup=2),
        heartbeat=Heartbeat(hb_path, interval_s=0.0))
    F.inject(sched, decode_faults=[F.SlowStep(step=4, delay_s=0.75)])
    for r in _reqs(eng.cfg, gens=(G, G)):
        sched.submit(r)
    sched.run()
    assert sched.stats["straggler_flags"] >= 1
    with open(hb_path) as f:
        beat = json.load(f)
    assert beat["step"] == sched.stats["steps"]
    assert {"active", "pending", "finished", "failed"} <= set(beat)


def test_generate_check_finite():
    solo = DecodeEngine(_cfg(), EngineConfig(batch=1, max_len=12),
                        device="cpu")
    toks = torch.arange(4, dtype=torch.int32)[None]
    out, _ = solo.generate({"tokens": toks}, gen=4, check_finite=True)
    assert out.shape == (1, 4)
    solo.decode_fn = F.FaultyStepFn(solo.decode_fn,
                                    [F.NonFiniteLogits(step=0, slot=0)])
    with pytest.raises(F.NonFiniteLogitsError, match="non-finite"):
        solo.generate({"tokens": toks}, gen=4, check_finite=True)


def test_call_with_retries_and_percentiles():
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise RuntimeError("boom")
        return x + 1

    assert call_with_retries(
        flaky, 1, policy=RetryPolicy(max_retries=3, backoff_s=0.0)) == 2
    assert len(calls) == 3
    with pytest.raises(RuntimeError, match="always"):
        call_with_retries(
            (lambda: (_ for _ in ()).throw(RuntimeError("always"))),
            policy=RetryPolicy(max_retries=1, backoff_s=0.0))
    with pytest.raises(KeyError):       # fatal: no retry spent
        call_with_retries(
            (lambda: calls.append(0) or {}["x"]),
            policy=RetryPolicy(max_retries=5, backoff_s=0.0,
                               fatal=(KeyError,)))
    assert percentiles([]) == {}
    pct = percentiles(list(range(1, 101)))
    assert pct["p50"] == pytest.approx(50.5)
    assert pct["p99"] == pytest.approx(99.01)


def test_random_plan_is_seed_deterministic():
    kw = dict(slots=4, p_nonfinite=0.2, p_transient=0.2, p_slow=0.1)
    a, b = F.random_plan(5, 64, **kw), F.random_plan(5, 64, **kw)
    assert len(a) > 0 and repr(a) == repr(b)
    assert repr(a) != repr(F.random_plan(6, 64, **kw))


# ------------------------------------------------- allocator

def test_page_allocator_invariants_and_refcounts():
    al = PageAllocator(4)
    a = al.alloc(3)
    assert al.free_pages == 1 and al.used_pages == 3
    with pytest.raises(PagePoolExhausted, match="exhausted"):
        al.alloc(2)
    al.incref(a[:1])
    assert al.refcount(a[0]) == 2
    with pytest.raises(ValueError, match="shared page"):
        al.free(a[:1])
    al.decref(a[:1])
    al.free(a[:2])
    assert al.free_pages == 3
    with pytest.raises(ValueError, match="double free"):
        al.free([a[0]])
    with pytest.raises(ValueError, match="invalid page"):
        al.free([99])
    with pytest.raises(ValueError, match="not currently handed out"):
        al.decref([a[0]])
    al.check()


def test_allocator_double_free_and_foreign_free():
    al = PageAllocator(4)
    got = al.alloc(2)
    al.free([got[0]])
    with pytest.raises(ValueError, match="double free"):
        al.free([got[0]])               # already back in the pool
    with pytest.raises(ValueError, match="double free"):
        al.free([3])                    # never handed out
    pages = al.alloc(1)
    with pytest.raises(ValueError, match="within one"):
        al.free(pages + pages)
    al.check()


def test_allocator_invariants_seeded_sweep():
    rng = np.random.default_rng(11)
    for n_pages in (1, 3, 8, 13):
        al = PageAllocator(n_pages)
        owned = []
        for _ in range(200):
            k = int(rng.integers(0, 5))
            if rng.random() < 0.5:
                if k > al.free_pages:
                    with pytest.raises(PagePoolExhausted):
                        al.alloc(k)
                else:
                    owned.extend(al.alloc(k))
            elif owned:
                take, owned = owned[:k], owned[k:]
                if take:
                    al.free(take)
            al.check()
            assert al.used_pages == len(owned)
        al.free(owned)
        assert al.free_pages == n_pages


# ------------------------------------------------- sampling

def test_sampled_streams_deterministic_and_seeds_decorrelate(eng):
    """Same (seed, request) -> the same sampled stream; adjacent seeds
    -> different streams; and the noise of a (seed, step) pair does not
    depend on the other slots of the batch."""
    def run(seeds):
        reqs = _reqs(eng.cfg, gens=(G, G))
        for r, s in zip(reqs, seeds):
            r.temperature, r.seed = 1.0, s
        out, _ = _run(eng, reqs)
        return [np.asarray(out[r.rid]) for r in reqs]

    a, b, c = run((5, 6)), run((5, 6)), run((6, 5))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # no two (seed, step) pairs of a grid share a noise row
    seeds, steps = np.meshgrid(np.arange(8), np.arange(8))
    rows = S.gumbel_noise(seeds.ravel(), steps.ravel(), 64, "cpu")
    assert len({tuple(r.tolist()) for r in rows}) == 64
    one = S.gumbel_noise([3], [4], 64, "cpu")
    torch.testing.assert_close(one[0], rows[4 * 8 + 3], rtol=0, atol=0)
    big = S.gumbel_noise(np.arange(16), np.zeros(16), 4096, "cpu")
    assert abs(float(big.mean()) - 0.5772) < 0.02     # Euler's gamma


def test_pick_is_one_batched_transfer():
    """The pick returns greedy, sampled and finite flags as one (3, B)
    int32 array; with no sampling slot the sampled row is the greedy
    one."""
    logits = torch.tensor([[0.0, 2.0, 1.0], [float("nan"), 0.0, 0.0]])
    out = S.pick_tokens(logits, np.zeros(2), np.zeros(2), np.zeros(2))
    assert out.dtype == np.int32 and out.shape == (3, 2)
    assert out[0, 0] == 1 and out[1, 0] == 1
    assert out[2].tolist() == [1, 0]
