"""Durable serving in the port: engine snapshots, the request journal
and crash recovery, against the port's own crash-free runs and the JAX
package's snapshots.

The headline property of ``tests/test_snapshot.py`` holds in the port: a
crash at a chosen step, recovered from the latest snapshot plus the
journal suffix by ``serve_with_recovery``, ends with the crash-free
run's statuses and greedy token streams bit for bit, and with the same
page accounting, across gqa/mla x model-dtype/int8 pools x prefix cache
x chunked prefill (fp32 model, so 'bf16' pools hold fp32 here, as in the
JAX tests).  The crash-free streams with both modes on equal the JAX
Scheduler's.  Snapshots cross between the packages both ways: a JAX
snapshot cut mid-stream restores into the port's Scheduler and a port
snapshot into the JAX Scheduler, and either continues to the JAX
crash-free streams (model-dtype and int8 pools).

Then the port copies of the JAX snapshot and journal units, and what is
new in the port: an async snapshot followed by more steps restores the
state at the cut (the port writes its pools in place), restored scale
leaves keep their 16-byte layer stride, a ``"sched"`` block the port
does not derive is refused, and sampled streams recover identical (the
Gumbel noise is a hash of (seed, step)).  The frontend families (vlm,
audio): ``frontend_emb`` rides the journal and snapshots in the JAX
encoding, JAX and port snapshots with frontends and encoder lengths
restore in the other package, and their streams crash and recover
identical.

Widths are those of ``tests/test_snapshot.py`` (2 layers, d 64, page 4,
chunk 8, fp32).  The JAX engines run on an explicit (1, 1) mesh with
Auto axes (their default mesh fails under JAX 0.9, ROADMAP queue 3).
"""
import json
import os
import threading
import types

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.common import config as jconfig  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import Scheduler as JScheduler  # noqa: E402
from repro.engine import restore as jrestore  # noqa: E402
from repro.engine import snapshot as jsnapshot  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import _leaf_paths  # noqa: E402
from repro_torch.common import config as tconfig  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                EngineSnapshotter, Request, RequestJournal,
                                RequestResult, RequestStatus, Scheduler,
                                faults, read_events, replay, restore,
                                snapshot)
from repro_torch.runtime.resilience import (RestartPolicy,  # noqa: E402
                                            serve_with_recovery)

PS = 4          # page_size used throughout
CT = 8          # chunk_tokens (2 pages) used throughout
N_PAGES = 24
_BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
             remat="none", attn_block_q=32, attn_block_kv=32)
_MLA = dict(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
            nope_head_dim=16, v_head_dim=16)
KINDS = ("gqa", "mla")
BOTH = dict(prefix_cache=True, chunked_prefill=True)
# the cross-package cut: two results finished, the long prompt's second
# chunk in flight, 5 pages in the trie
CUT = 8


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _ekw(kv_dtype, n_pages=N_PAGES):
    return dict(batch=2, max_len=32, paged=True, page_size=PS,
                n_pages=n_pages, chunked_prefill=True, chunk_tokens=CT,
                kv_dtype=kv_dtype)


_MESH = None
_JENGINES = {}
_ENGINES = {}


def _jax_engine(kind, kv_dtype):
    """One JAX engine a (config, pool dtype)."""
    global _MESH
    if _MESH is None:
        _MESH = jax.make_mesh((1, 1), ("data", "model"),
                              axis_types=(AxisType.Auto, AxisType.Auto))
    key = (kind, kv_dtype)
    if key not in _JENGINES:
        kw = dict(_BASE)
        if kind == "mla":
            kw["mla"] = jconfig.MLAConfig(**_MLA)
        _JENGINES[key] = JEngine(jconfig.ModelConfig(**kw),
                                 JEngineConfig(**_ekw(kv_dtype)), mesh=_MESH)
    return _JENGINES[key]


def _cfg(kind):
    kw = dict(_BASE)
    if kind == "mla":
        kw["mla"] = tconfig.MLAConfig(**_MLA)
    return tconfig.ModelConfig(**kw)


def _engine(kind, kv_dtype):
    """The port's engine of a (config, pool dtype) on the CPU, with the
    parameters of the JAX engine it is compared with."""
    key = (kind, kv_dtype)
    if key not in _ENGINES:
        jeng = _jax_engine(kind, kv_dtype if kind == "gqa" else "bf16")
        params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params),
                                 "cpu")
        _ENGINES[key] = DecodeEngine(
            _cfg(kind), EngineConfig(**_ekw(kv_dtype), kernel_impl="cuda"),
            params=params, device="cpu")
    return _ENGINES[key]


# the workload every cell runs (``tests/test_snapshot.py``'s): two
# prompts sharing a 2-page system prefix (so prefix-cache cells hit),
# one long prompt (so chunked cells chunk), turnover on a batch of 2
def _requests(vocab, req_cls=Request, temperature=0.0):
    rng = np.random.default_rng(0)
    sys_p = rng.integers(2, vocab, (2 * PS,)).astype(np.int32)
    t0 = rng.integers(2, vocab, (4,)).astype(np.int32)
    t1 = rng.integers(2, vocab, (2,)).astype(np.int32)
    long_p = rng.integers(2, vocab, (18,)).astype(np.int32)
    specs = [(np.concatenate([sys_p, t0]), 6),
             (np.concatenate([sys_p, t1]), 5),
             (long_p, 6)]
    return [req_cls(rid=i, tokens=p, gen=g, seed=i, temperature=temperature)
            for i, (p, g) in enumerate(specs)]


def _assert_same_results(got, want):
    assert set(got) == set(want)
    for rid, res in want.items():
        assert got[rid].status.value == res.status.value, f"req {rid}"
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(res), err_msg=f"req {rid}")


def _run(eng, reqs, **kw):
    sched = Scheduler(eng, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


class _CutAt:
    """A snapshotter stand-in that cuts one snapshot with ``fn`` (the
    JAX package's or the port's ``snapshot``) after step ``step``, so a
    plain ``run()`` drains around it."""

    def __init__(self, fn, directory, step):
        self.fn, self.dir, self.step, self.state = fn, directory, step, None

    def on_step(self, sched):
        if sched.stats["steps"] == self.step:
            self.fn(sched, self.dir)
            self.state = ([s and s.req.status.value for s in sched.slots],
                          sched.prefix is not None
                          and sched.prefix.cached_pages,
                          len(sched.finished))

    def wait(self):
        pass


_JAX_RUNS = {}


def _jax_run(kind, kv_dtype, tmp_path_factory):
    """The JAX Scheduler's crash-free run with the prefix cache and
    chunked prefill on (one a config and pool dtype), with one snapshot
    cut after step CUT: (results, snapshot directory)."""
    key = (kind, kv_dtype)
    if key not in _JAX_RUNS:
        jeng = _jax_engine(kind, kv_dtype)
        d = str(tmp_path_factory.mktemp(f"jax-{kind}-{kv_dtype}"))
        cut = _CutAt(jsnapshot, d, CUT)
        sched = JScheduler(jeng, snapshotter=cut, **BOTH)
        for r in _requests(jeng.cfg.vocab, JRequest):
            sched.submit(r)
        want = sched.run()
        assert all(res.ok for res in want.values())
        # the cut holds a chunk in flight, a trie and finished results
        assert "PREFILLING" in cut.state[0] and cut.state[1] > 0
        assert cut.state[2] > 0
        _JAX_RUNS[key] = (want, d)
    return _JAX_RUNS[key]


# ------------------------------------------------- crash + recover matrix

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no-prefix", "prefix"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["no-chunk", "chunk"])
def test_crash_recover_bit_identical(kind, kv_dtype, prefix, chunked,
                                     tmp_path, tmp_path_factory):
    """Crash at step 5 with snapshots every 2 steps: the recovered
    streams, statuses and page accounting are the crash-free run's; with
    both modes on, on model-dtype pools, the crash-free streams are the
    JAX Scheduler's."""
    eng = _engine(kind, kv_dtype)
    kw = dict(prefix_cache=prefix, chunked_prefill=chunked)
    _, want = _run(eng, _requests(eng.cfg.vocab), **kw)
    assert all(res.ok for res in want.values())
    if prefix and chunked and kv_dtype == "bf16":
        _assert_same_results(want, _jax_run(kind, kv_dtype,
                                            tmp_path_factory)[0])

    starts, proxies = [], []

    def on_start(sched, fresh):
        starts.append(fresh)
        if fresh:        # the crash hits only the pre-recovery process
            proxies.append(faults.inject(sched, decode_faults=[
                faults.CrashFault(step=5)]))

    def submit(sched):
        for r in _requests(eng.cfg.vocab):
            sched.submit(r)

    sched = serve_with_recovery(
        eng, str(tmp_path), submit, snapshot_every=2,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.0),
        on_start=on_start, sched_kwargs=kw)

    assert starts[0] is True and False in starts[1:]
    assert sum(p.decode_fn.injected
               + (p.mixed_fn.injected if p.mixed_fn else 0)
               for p in proxies) >= 1
    assert sched.snapshotter.saved >= 1
    _assert_same_results(sched.finished, want)
    sched.allocator.check()
    cached = sched.prefix.cached_pages if sched.prefix is not None else 0
    assert sched.allocator.free_pages == eng.n_pages - cached
    if sched.prefix is not None:
        sched.prefix.check()


# ------------------------------------------------- across the packages

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_jax_snapshot_restores_into_the_port(kv_dtype, tmp_path_factory):
    """A JAX snapshot cut mid-stream (a chunk in flight, a trie) restores
    into the port's Scheduler, which continues to the JAX crash-free
    streams, pages accounted for."""
    want, d = _jax_run("gqa", kv_dtype, tmp_path_factory)
    eng = _engine("gqa", kv_dtype)
    sched = restore(d, eng)
    assert sched.stats["steps"] == CUT
    assert sched.prefix is not None and sched.chunked
    assert any(s is not None and s.req.status is RequestStatus.PREFILLING
               for s in sched.slots)
    _assert_same_results(sched.run(), want)
    sched.allocator.check()
    sched.prefix.check()
    assert sched.allocator.free_pages == \
        eng.n_pages - sched.prefix.cached_pages


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_port_snapshot_restores_into_jax(kv_dtype, tmp_path,
                                         tmp_path_factory):
    """A port snapshot cut at the same step restores into the JAX
    Scheduler, which continues to the JAX crash-free streams."""
    want, _ = _jax_run("gqa", kv_dtype, tmp_path_factory)
    eng = _engine("gqa", kv_dtype)
    cut = _CutAt(snapshot, str(tmp_path), CUT)
    sched = Scheduler(eng, snapshotter=cut, **BOTH)
    for r in _requests(eng.cfg.vocab):
        sched.submit(r)
    _assert_same_results(sched.run(), want)
    jsched = jrestore(str(tmp_path), _jax_engine("gqa", kv_dtype))
    assert jsched.stats["steps"] == CUT
    _assert_same_results(jsched.run(), want)
    jsched.allocator.check()


# ------------------------------------------------- snapshot/restore unit

def _pools(sched):
    """Copies of the scheduler's pool leaves, by store key."""
    return {k: t.clone() for k, t in _leaf_paths(sched.cache).items()}


def _trie(sched):
    """The trie as {token path: (page, LRU stamp)} with its clock and
    counters: ``to_state`` lists nodes in walk order, which a reload may
    change."""
    state, paths, out = sched.prefix.to_state(), [], {}
    for nd in state["nodes"]:
        path = (paths[nd["parent"]] if nd["parent"] >= 0 else ()) + (
            tuple(nd["key"]),)
        paths.append(path)
        out[path] = (nd["page"], nd["last_used"])
    return out, state["clock"], state["stats"]


def test_snapshot_restore_roundtrip_mid_stream(tmp_path):
    """Cut a snapshot mid-drain; the restored scheduler carries the same
    pools bit for bit, allocator partition (free-list ORDER included),
    block tables and knobs, and both finish with identical results."""
    eng = _engine("gqa", "int8")
    a = Scheduler(eng, **BOTH)
    for r in _requests(eng.cfg.vocab):
        a.submit(r)
    a.admit()
    for _ in range(3):
        a.step()
    step = snapshot(a, str(tmp_path))
    assert step == a.stats["steps"]

    b = restore(str(tmp_path), eng)
    assert b.prefix is not None and b.chunked   # knobs from the snapshot
    assert b.stats == a.stats
    assert b.allocator.to_state() == a.allocator.to_state()
    assert _trie(b) == _trie(a)
    np.testing.assert_array_equal(b.table, a.table)
    np.testing.assert_array_equal(b.lens, a.lens)
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert list(b._prefilling) == list(a._prefilling)
    assert [s and s.req.rid for s in b.slots] == \
        [s and s.req.rid for s in a.slots]
    got, want = _pools(b), _pools(a)
    assert set(got) == {"k", "v", "k_scale", "v_scale"}
    for k in want:
        assert torch.equal(got[k], want[k]), k

    a.run()
    b.run()
    _assert_same_results(b.finished, a.finished)
    b.allocator.check()
    b.prefix.check()


def test_crash_before_first_snapshot_recovers_from_journal(tmp_path):
    """snapshot_every=0: journal-only durability.  The crash beats any
    snapshot, recovery replays the whole journal into a fresh scheduler,
    and the streams still match the crash-free run."""
    eng = _engine("gqa", "bf16")
    _, want = _run(eng, _requests(eng.cfg.vocab))

    def on_start(sched, fresh):
        if fresh:
            faults.inject(sched, decode_faults=[faults.CrashFault(step=3)])

    def submit(sched):
        for r in _requests(eng.cfg.vocab):
            sched.submit(r)

    sched = serve_with_recovery(
        eng, str(tmp_path), submit, snapshot_every=0,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.0),
        on_start=on_start)
    assert sched.snapshotter.saved == 0
    assert sched.snapshotter.latest_step() is None
    _assert_same_results(sched.finished, want)
    assert sched.allocator.free_pages == eng.n_pages


def test_replay_recovers_terminals_verbatim_without_recompute(tmp_path):
    """A journal whose every submit already went terminal replays into a
    fresh scheduler as pure bookkeeping: each submit re-queues, each
    terminal drops the queued residue and records the result VERBATIM —
    zero decode steps run, zero pages stay held; replaying again is all
    no-ops."""
    eng = _engine("gqa", "bf16")
    jpath = str(tmp_path / "journal.jsonl")
    j = RequestJournal(jpath)
    a = Scheduler(eng, journal=j)
    for r in _requests(eng.cfg.vocab):
        a.submit(r)
    want = a.run()
    j.close()

    events = read_events(jpath)
    assert [e["ev"] for e in events].count("terminal") == len(want)

    b = Scheduler(eng)
    stats = replay(b, events)
    assert stats["requeued"] == len(want)
    assert stats["recovered"] == len(want)
    assert b.stats["steps"] == 0
    assert not b.pending and b.allocator.free_pages == eng.n_pages
    _assert_same_results(b.finished, want)
    for rid, res in want.items():
        assert b.finished[rid].latency_s == res.latency_s
        assert b.finished[rid].token_times == res.token_times

    again = replay(b, events)
    assert again == {"recovered": 0, "requeued": 0, "cancelled": 0,
                     "noop": len(events)}


def test_journal_cancel_replays_against_live_request(tmp_path):
    """A journaled cancel with no terminal yet (the crash landed between
    the cancel append and its effect) re-applies on replay."""
    eng = _engine("gqa", "bf16")
    jpath = str(tmp_path / "journal.jsonl")
    j = RequestJournal(jpath)
    j.submit(_requests(eng.cfg.vocab)[0])
    j.cancel(0)
    j.close()

    sched = Scheduler(eng)
    stats = replay(sched, read_events(jpath))
    assert stats == {"recovered": 0, "requeued": 1, "cancelled": 1,
                     "noop": 0}
    assert not sched.finished[0].ok
    assert sched.allocator.free_pages == eng.n_pages


def test_journal_torn_tail_tolerated_mid_corruption_raises(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.submit(Request(rid=0, tokens=np.arange(2, 5, dtype=np.int32), gen=2))
    j.cancel(0)
    j.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"ev": "subm')                 # died mid-append
    assert [e["ev"] for e in read_events(p)] == ["submit", "cancel"]

    with open(p, "a", encoding="utf-8") as f:   # torn line now MID-file
        f.write('\n{"ev": "cancel", "rid": 0}\n')
    with pytest.raises(ValueError, match="corrupt"):
        read_events(p)

    assert read_events(str(tmp_path / "missing.jsonl")) == []


def test_journal_reopen_repairs_torn_tail(tmp_path):
    """Double crash: the reopen truncates the torn fragment so the new
    appends land on a clean line boundary, and a clean journal reopens
    untouched."""
    p = str(tmp_path / "j.jsonl")
    j = RequestJournal(p)
    j.submit(Request(rid=0, tokens=np.arange(2, 5, dtype=np.int32), gen=2))
    j.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"ev": "subm')                 # crash #1, mid-append

    j2 = RequestJournal(p)                      # recovered process
    j2.cancel(0)
    j2.terminal(0, RequestResult(np.arange(3, dtype=np.int32),
                                 RequestStatus.CANCELLED,
                                 error="cancelled mid-flight"))
    j2.close()

    evs = read_events(p)
    assert [e["ev"] for e in evs] == ["submit", "cancel", "terminal"]
    assert evs[2]["status"] == RequestStatus.CANCELLED.value

    before = open(p, encoding="utf-8").read()
    RequestJournal(p).close()
    assert open(p, encoding="utf-8").read() == before


def test_replay_cancel_intent_before_terminal_is_noop(tmp_path):
    """The scheduler journals a cancel as INTENT before the authoritative
    terminal; on replay the cancel must not re-run against the restored
    partial state."""
    eng = _engine("gqa", "bf16")
    jpath = str(tmp_path / "journal.jsonl")
    j = RequestJournal(jpath)
    a = Scheduler(eng, journal=j)
    reqs = _requests(eng.cfg.vocab)
    for r in reqs:
        a.submit(r)
    a.admit()
    for _ in range(2):
        a.step()
    assert a.cancel(reqs[0].rid)    # journal order: cancel, terminal
    want = a.run()
    j.close()

    events = read_events(jpath)
    kinds = [(e["ev"], e["rid"]) for e in events]
    assert kinds.index(("cancel", 0)) < kinds.index(("terminal", 0))

    b = Scheduler(eng)
    stats = replay(b, events)
    assert stats["cancelled"] == 0
    _assert_same_results(b.finished, want)
    assert b.finished[0].latency_s == want[0].latency_s
    assert b.finished[0].token_times == want[0].token_times
    assert b.allocator.free_pages == eng.n_pages


def test_journal_events_read_across_the_packages(tmp_path):
    """The port's journal lines are the JAX journal's: the same request
    and result give the same events, and either replays the other's."""
    from repro.engine import RequestJournal as JJournal
    from repro.engine import RequestResult as JResult
    from repro.engine import RequestStatus as JStatus
    toks = np.arange(2, 7, dtype=np.int32)
    for cls, req, res, name in (
            (RequestJournal, Request(rid=3, tokens=toks, gen=2, seed=5),
             RequestResult(toks[:2], RequestStatus.FINISHED,
                           latency_s=0.5, token_times=[1.0, 2.0]), "t"),
            (JJournal, JRequest(rid=3, tokens=toks, gen=2, seed=5),
             JResult(toks[:2], JStatus.FINISHED, latency_s=0.5,
                     token_times=[1.0, 2.0]), "j")):
        j = cls(str(tmp_path / f"{name}.jsonl"))
        j.submit(req)
        j.cancel(3)
        j.terminal(3, res)
        j.close()
    a = (tmp_path / "t.jsonl").read_text()
    assert a == (tmp_path / "j.jsonl").read_text()
    b = Scheduler(_engine("gqa", "bf16"))
    assert replay(b, read_events(str(tmp_path / "j.jsonl"))) == {
        "recovered": 1, "requeued": 1, "cancelled": 0, "noop": 1}
    np.testing.assert_array_equal(b.finished[3], toks[:2])


# ------------------------------------------------- restore validation

def test_restore_rejects_geometry_mismatch(tmp_path):
    eng = _engine("gqa", "bf16")
    snapshot(Scheduler(eng), str(tmp_path))
    fake = types.SimpleNamespace(
        ecfg=types.SimpleNamespace(batch=2, max_len=32, kv_dtype="bf16"),
        page_size=PS, n_pages=eng.n_pages + 8,
        cfg=types.SimpleNamespace(family="dense"))
    with pytest.raises(ValueError, match="geometry"):
        restore(str(tmp_path), fake)
    with pytest.raises(ValueError, match="geometry"):
        restore(str(tmp_path), _engine("gqa", "int8"))


def test_restore_rejects_non_snapshot_checkpoint(tmp_path):
    """A training checkpoint (no 'host' leaf) is not an engine snapshot."""
    store = CheckpointStore(str(tmp_path))
    store.save(0, {"w": torch.zeros((3,))})
    with pytest.raises(ValueError, match="not an engine snapshot"):
        restore(store, _engine("gqa", "bf16"), step=0)


def test_restore_without_snapshot_is_fresh(tmp_path):
    eng = _engine("gqa", "bf16")
    sched = restore(str(tmp_path / "empty"), eng)
    assert sched.stats["steps"] == 0 and not sched.finished
    assert sched.allocator.free_pages == eng.n_pages


def test_async_snapshot_failure_surfaces(tmp_path, monkeypatch):
    """A dying disk under the background snapshot writer surfaces in the
    serving loop, and teardown after it does not raise again."""
    eng = _engine("gqa", "bf16")
    snap = EngineSnapshotter(str(tmp_path), every=1)

    def boom(step, host):
        raise OSError("disk died")

    monkeypatch.setattr(snap.store, "_write", boom)
    sched = Scheduler(eng, snapshotter=snap)
    for r in _requests(eng.cfg.vocab):
        sched.submit(r)
    with pytest.raises(OSError, match="disk died"):
        sched.run()
    snap.close()


# ------------------------------------------------- what is new in the port

def test_async_snapshot_keeps_the_cut(tmp_path, monkeypatch):
    """The port's steps write the pools in place: an async snapshot whose
    disk write is held until two more steps have run still restores the
    pools and host state of the cut."""
    eng = _engine("gqa", "int8")
    a = Scheduler(eng, **BOTH)
    for r in _requests(eng.cfg.vocab):
        a.submit(r)
    a.admit()
    for _ in range(3):
        a.step()
    cut = _pools(a)
    go = threading.Event()
    store = CheckpointStore(str(tmp_path))
    real_write = store._write

    def held(step, host):
        go.wait(10)
        real_write(step, host)

    monkeypatch.setattr(store, "_write", held)
    step = snapshot(a, store, async_=True)
    for _ in range(2):
        a.admit()
        a.step()
    assert any(not torch.equal(t, cut[k]) for k, t in _pools(a).items())
    go.set()
    store.wait()
    b = restore(store, eng)
    assert b.stats["steps"] == step
    for k, t in _pools(b).items():
        assert torch.equal(t, cut[k]), k


def test_restored_scales_keep_the_layer_stride(tmp_path):
    """The int8 scale sidecars are allocated with each layer on a
    16-byte boundary (23 pages x 2 KV heads = 46 fp32 a layer, padded to
    48): restore copies into those tensors, so the stride stays."""
    eng = DecodeEngine(_cfg("gqa"), EngineConfig(**_ekw("int8", 23)),
                       params=_engine("gqa", "int8").params, device="cpu")
    a = Scheduler(eng)
    for r in _requests(eng.cfg.vocab):
        a.submit(r)
    a.admit()
    a.step()
    snapshot(a, str(tmp_path))
    fresh = Scheduler(eng)
    want = {k: (t.data_ptr(), t.stride()) for k, t in fresh.cache.items()}
    assert want["k_scale"][1][0] == 48
    b = restore(str(tmp_path), eng)
    for k, t in b.cache.items():
        assert t.stride() == want[k][1], k
        assert (t.stride()[0] * t.element_size()) % 16 == 0, k
        assert torch.equal(t, a.cache[k]), k


def _edit_host(directory, step, edit):
    """Rewrite the host JSON leaf of the snapshot at ``step``."""
    d = os.path.join(directory, f"step_{step}")
    path = os.path.join(d, "host.s0.npy")
    state = json.loads(bytes(np.load(path)))
    edit(state)
    blob = json.dumps(state).encode("utf-8")
    np.save(path, np.frombuffer(blob, np.uint8))
    index_path = os.path.join(d, "index.json")
    with open(index_path) as f:
        index = json.load(f)
    index["host"]["shape"] = [len(blob)]
    with open(index_path, "w") as f:
        json.dump(index, f)


@pytest.mark.parametrize("field,value", [
    ("guard_nonfinite", False), ("chunk_tokens", 2 * CT),
    ("token_budget", 5), ("enc_len", 16)])
def test_restore_refuses_a_sched_block_the_port_does_not_derive(
        tmp_path, field, value):
    eng = _engine("gqa", "bf16")
    a = Scheduler(eng, chunked_prefill=True)
    step = snapshot(a, str(tmp_path))
    assert restore(str(tmp_path), eng).token_budget == 2 + CT

    def edit(state):
        state["sched"][field] = value
    _edit_host(str(tmp_path), step, edit)
    with pytest.raises(ValueError, match=field):
        restore(str(tmp_path), eng)


# ------------------------------------------------- the frontend families

# 2-layer vlm (4 frontend tokens) and audio (2 encoder layers) configs of
# the widths above, frontends of dim 24; audio streams run under a cross
# budget of ENC_LEN frames
_FRONT = {"vlm": dict(family="vlm", frontend="vision", frontend_tokens=4,
                      frontend_dim=24),
          "audio": dict(family="audio", enc_layers=2, frontend="audio",
                        frontend_dim=24)}
ENC_LEN = 20
_FRONT_EKW = dict(batch=2, max_len=24, paged=True, page_size=PS,
                  n_pages=10)


def _front_engines(family):
    """(JAX engine, the port's engine with its parameters) of a frontend
    family, once each."""
    global _MESH
    key = ("front", family)
    if key not in _ENGINES:
        if _MESH is None:
            _MESH = jax.make_mesh((1, 1), ("data", "model"),
                                  axis_types=(AxisType.Auto, AxisType.Auto))
        kw = {**_BASE, **_FRONT[family]}
        jeng = JEngine(jconfig.ModelConfig(**kw),
                       JEngineConfig(**_FRONT_EKW), mesh=_MESH)
        params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params),
                                 "cpu")
        _ENGINES[key] = (jeng, DecodeEngine(
            tconfig.ModelConfig(**kw),
            EngineConfig(**_FRONT_EKW, kernel_impl="cuda"), params=params,
            device="cpu"))
    return _ENGINES[key]


def _front_requests(cfg, req_cls=Request):
    """Four requests with their frontends (audio: 9-18 frames), more than
    the 2 slots, so a cut holds live slots and queued requests."""
    rng = np.random.default_rng(5)
    out = []
    for i, (p, g, f) in enumerate(((3, 6, 18), (5, 5, 9), (2, 6, 13),
                                   (4, 4, 11))):
        n = cfg.frontend_tokens if cfg.family == "vlm" else f
        out.append(req_cls(
            rid=i, tokens=rng.integers(2, cfg.vocab, p).astype(np.int32),
            gen=g, frontend_emb=rng.standard_normal(
                (n, cfg.frontend_dim)).astype(np.float32)))
    return out


def _front_kw(family):
    return {"enc_len": ENC_LEN} if family == "audio" else {}


@pytest.mark.parametrize("family", ["vlm", "audio"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_frontend_snapshot_and_journal_restore_across_packages(
        family, direction, tmp_path):
    """A journaled stream of requests with frontends, cut by a snapshot
    after step 3 (live slots, their encoder lengths, queued requests'
    embeddings): the snapshot restored in the other package, with the
    journal replayed over it, continues to the crash-free streams of the
    JAX Scheduler, which the port's crash-free streams equal."""
    from repro.engine import RequestJournal as JJournal
    from repro.engine import read_events as jread
    from repro.engine import replay as jreplay
    jeng, eng = _front_engines(family)
    kw = _front_kw(family)
    jsched = JScheduler(jeng, **kw)
    for r in _front_requests(jeng.cfg, JRequest):
        jsched.submit(r)
    want = jsched.run()
    assert all(res.ok for res in want.values())
    _assert_same_results(_run(eng, _front_requests(eng.cfg), **kw)[1],
                         want)

    d, path = str(tmp_path / "snap"), str(tmp_path / "journal.jsonl")
    if direction == "jax-to-port":
        src_eng, src_sched, src_req, src_journal = (jeng, JScheduler,
                                                    JRequest, JJournal)
        cut_fn, dst, dst_restore = jsnapshot, eng, restore
        dst_replay, dst_read = replay, read_events
    else:
        src_eng, src_sched, src_req, src_journal = (eng, Scheduler, Request,
                                                    RequestJournal)
        cut_fn, dst, dst_restore = snapshot, jeng, jrestore
        dst_replay, dst_read = jreplay, jread
    cut = _CutAt(cut_fn, d, 3)
    journal = src_journal(path)
    sched = src_sched(src_eng, journal=journal, snapshotter=cut, **kw)
    for r in _front_requests(src_eng.cfg, src_req):
        sched.submit(r)
    _assert_same_results(sched.run(), want)
    journal.close()
    state = _read_host(d, 3)
    assert sum(s is not None for s in state["slots"]) == 2
    assert all(q.get("frontend_emb") is not None for q in state["pending"])
    assert (any(state["enc_lens"]) if family == "audio"
            else not any(state["enc_lens"]))
    got = dst_restore(d, dst)
    assert got.stats["steps"] == 3
    if family == "audio":
        assert got.enc_budget == ENC_LEN
        np.testing.assert_array_equal(got.enc_lens, state["enc_lens"])
    queued = [q for q in got.pending]
    assert queued and all(q.frontend_emb.dtype == np.float32
                          for q in queued)
    dst_replay(got, dst_read(path))
    _assert_same_results(got.run(), want)
    got.allocator.check()
    assert got.allocator.free_pages == dst.n_pages


def _read_host(directory, step):
    with open(os.path.join(directory, f"step_{step}", "host.s0.npy"),
              "rb") as f:
        return json.loads(bytes(np.load(f)))


def test_frontend_embeddings_round_trip(tmp_path):
    """A request's ``frontend_emb`` rides the journal and a snapshot in
    the JAX package's encoding (``{"data": list, "dtype": str}``), the
    same line as the JAX journal writes, and comes back with its values
    and dtype; a request without one carries no field."""
    from repro.engine import RequestJournal as JJournal
    _, eng = _front_engines("audio")
    emb = np.random.default_rng(1).standard_normal((3, 4)).astype(
        np.float32)
    for cls, req_cls, name in ((RequestJournal, Request, "t"),
                               (JJournal, JRequest, "j")):
        j = cls(str(tmp_path / f"{name}.jsonl"))
        j.submit(req_cls(rid=0, tokens=np.arange(3, dtype=np.int32),
                         gen=2, frontend_emb=emb))
        j.submit(req_cls(rid=1, tokens=np.arange(2, dtype=np.int32),
                         gen=2))
        j.close()
    line = (tmp_path / "t.jsonl").read_text()
    assert line == (tmp_path / "j.jsonl").read_text()
    ev = read_events(str(tmp_path / "t.jsonl"))
    assert ev[0]["frontend_emb"]["dtype"] == "float32"
    assert "frontend_emb" not in ev[1]
    b = Scheduler(eng, enc_len=ENC_LEN)
    replay(b, ev)
    got = list(b.pending)
    np.testing.assert_array_equal(got[0].frontend_emb, emb)
    assert got[0].frontend_emb.dtype == np.float32
    assert got[1].frontend_emb is None

    a = Scheduler(eng, enc_len=ENC_LEN)
    for r in got:
        a.submit(r)
    step = snapshot(a, str(tmp_path / "snap"))
    c = restore(str(tmp_path / "snap"), eng)
    np.testing.assert_array_equal(c.pending[0].frontend_emb, emb)
    assert c.pending[1].frontend_emb is None and c.enc_budget == ENC_LEN
    assert _read_host(str(tmp_path / "snap"), step)["sched"]["enc_len"] \
        == ENC_LEN


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_frontend_crash_recover_bit_identical(family, tmp_path):
    """A frontend stream crashed at step 5 (snapshots every 2 steps) and
    recovered by ``serve_with_recovery`` ends with the crash-free run's
    streams and page accounting; the audio Scheduler's ``enc_len`` rides
    ``sched_kwargs`` into the restored one."""
    _, eng = _front_engines(family)
    kw = _front_kw(family)
    _, want = _run(eng, _front_requests(eng.cfg), **kw)
    starts = []

    def on_start(sched, fresh):
        starts.append(fresh)
        if fresh:
            faults.inject(sched, decode_faults=[faults.CrashFault(step=5)])

    def submit(sched):
        for r in _front_requests(eng.cfg):
            sched.submit(r)

    sched = serve_with_recovery(
        eng, str(tmp_path), submit, snapshot_every=2,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.0),
        on_start=on_start, sched_kwargs=kw)
    assert starts[0] is True and False in starts[1:]
    assert sched.snapshotter.saved >= 1
    _assert_same_results(sched.finished, want)
    sched.allocator.check()
    assert sched.allocator.free_pages == eng.n_pages
    assert not sched.enc_lens.any()


@pytest.mark.parametrize("kind", KINDS)
def test_sampled_streams_recover_identical(kind, tmp_path):
    """Sampled streams (temperature 0.8): the restored slots' ``steps``
    counters resume the Gumbel noise of (seed, step), so the recovered
    streams are the crash-free run's."""
    eng = _engine(kind, "bf16")
    reqs = _requests(eng.cfg.vocab, temperature=0.8)
    _, want = _run(eng, reqs, **BOTH)
    greedy = _run(eng, _requests(eng.cfg.vocab), **BOTH)[1]
    assert any(not np.array_equal(want[r], greedy[r]) for r in want)

    def on_start(sched, fresh):
        if fresh:
            faults.inject(sched, decode_faults=[faults.CrashFault(step=5)])

    def submit(sched):
        for r in _requests(eng.cfg.vocab, temperature=0.8):
            sched.submit(r)

    sched = serve_with_recovery(
        eng, str(tmp_path), submit, snapshot_every=2,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.0),
        on_start=on_start, sched_kwargs=BOTH)
    assert sched.snapshotter.saved >= 1
    _assert_same_results(sched.finished, want)
