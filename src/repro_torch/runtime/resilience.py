"""Fault-tolerance runtime for serving: straggler monitor, heartbeat,
bounded retries, latency percentiles and restart-from-snapshot.

The port's own copy of ``repro.runtime.resilience`` (the port imports
nothing of the JAX package).  The scheduler (``engine.scheduler``) runs
a StragglerMonitor and a Heartbeat in its step loop, bounds transient
step and prefill faults with ``RetryPolicy``/``call_with_retries``, and
summarizes per-request latency with ``percentiles``.
``run_with_restarts`` is the generic restart loop, and
``serve_with_recovery`` wraps it around a journaled, snapshot-cadenced
Scheduler drain: durable serving (``engine.snapshot``,
``engine.journal``).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence


class StragglerMonitor:
    """Flags a step slower than ``threshold`` x the trailing median of
    the last ``window`` steps (after ``warmup`` steps)."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 warmup: int = 5):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self.flagged: List[dict] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> Optional[dict]:
        if self._t0 is None:
            raise RuntimeError("end_step() without start_step()")
        dt = time.monotonic() - self._t0
        self._step += 1
        flag = None
        if len(self.window) >= self.warmup:
            med = sorted(self.window)[len(self.window) // 2]
            if dt > self.threshold * med:
                flag = {"step": self._step, "dt": dt, "median": med}
                self.flagged.append(flag)
        self.window.append(dt)
        return flag

    @property
    def median(self) -> float:
        if not self.window:
            return 0.0
        return sorted(self.window)[len(self.window) // 2]


class Heartbeat:
    """Rewrites a JSON file at most every ``interval_s``; an external
    supervisor treats a stale heartbeat as a hang."""

    def __init__(self, path: str, interval_s: float = 15.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int, extra: Optional[dict] = None):
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now, **(extra or {})}, f)
        os.replace(tmp, self.path)


@dataclass
class RetryPolicy:
    """Bounded retry with linear backoff for one call (a decode or
    prefill step).  ``max_retries=0`` disables retrying.  ``fatal``
    exception types re-raise at once without spending the budget (a
    simulated process death, ``engine.faults.CrashError``, is not a
    blip a retry heals)."""
    max_retries: int = 2
    backoff_s: float = 0.05
    fatal: tuple = ()


def call_with_retries(fn: Callable, *args,
                      policy: Optional[RetryPolicy] = None,
                      on_retry: Optional[Callable[[int, Exception],
                                                  None]] = None):
    """Call ``fn(*args)``; on an exception retry up to
    ``policy.max_retries`` times, sleeping ``backoff_s * attempt``
    between attempts (``on_retry(attempt, exc)`` fires before each
    retry).  Re-raises the last exception once the budget is spent, and
    one matching ``policy.fatal`` at once."""
    policy = policy or RetryPolicy()
    last: Optional[Exception] = None
    for attempt in range(policy.max_retries + 1):
        if attempt:
            if on_retry is not None:
                on_retry(attempt, last)
            time.sleep(policy.backoff_s * attempt)
        try:
            return fn(*args)
        except Exception as e:                      # noqa: BLE001
            if policy.fatal and isinstance(e, policy.fatal):
                raise
            last = e
    raise last


def percentiles(samples: Sequence[float],
                qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
    """{'p50': ..., 'p90': ..., 'p99': ...} by linear interpolation
    over sorted ``samples`` (empty input -> {})."""
    xs = sorted(samples)
    if not xs:
        return {}
    out = {}
    for q in qs:
        pos = (len(xs) - 1) * (q / 100.0)
        lo, hi = int(pos), min(int(pos) + 1, len(xs) - 1)
        out[f"p{q:g}"] = xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return out


@dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_s: float = 1.0


def run_with_restarts(make_state: Callable[[Optional[int]], object],
                      run: Callable[[object], None],
                      store,
                      policy: RestartPolicy = RestartPolicy()):
    """make_state(resume_step|None) -> state;  run(state) raises on
    failure.  Resumes from store.latest_step() after each failure."""
    attempts = 0
    while True:
        resume = store.latest_step()
        state = make_state(resume)
        try:
            run(state)
            return
        except KeyboardInterrupt:
            raise
        except Exception:                           # noqa: BLE001
            attempts += 1
            if attempts > policy.max_restarts:
                raise
            time.sleep(policy.backoff_s * attempts)


def serve_with_recovery(engine, snapshot_dir: str, submit: Callable,
                        *, snapshot_every: int = 0, keep: int = 3,
                        policy: RestartPolicy = RestartPolicy(),
                        on_start: Optional[Callable] = None,
                        sched_kwargs: Optional[dict] = None):
    """Durable serving supervisor: ``run_with_restarts`` wrapped around
    a snapshot-cadenced, journaled scheduler drain.

    The first attempt builds a FRESH scheduler and calls
    ``submit(sched)`` to enqueue the workload (every submit lands in
    the write-ahead journal under ``snapshot_dir``); the scheduler then
    snapshots its full serving state every ``snapshot_every`` steps off
    the step path (0 = journal-only durability).  When the drain raises
    — e.g. an ``engine.faults.CrashFault`` simulating process death —
    the restart loop rebuilds the scheduler from the latest complete
    snapshot (or from scratch when the crash beat the first cadence)
    and replays the journal suffix: finished results are recovered
    verbatim, post-snapshot submits re-queued, in-flight slots resume
    from their snapshotted pages and sampling state.  ``submit`` is NOT
    called again on recovery attempts — the journal is the workload's
    durable record.

    ``on_start(sched, fresh)`` runs after each (re)build — the hook
    fault-injection tests use to crash only the fresh run.  Returns the
    scheduler that completed the drain; async snapshot failures surface
    here (teardown waits on the background writer).
    """
    # engine modules import this one — keep the import lazy
    from repro_torch.engine.engine import refuse_distributed
    from repro_torch.engine.journal import (RequestJournal, read_events,
                                            replay)
    from repro_torch.engine.scheduler import Scheduler
    from repro_torch.engine.snapshot import EngineSnapshotter, restore

    # before the snapshotter makes its directory
    refuse_distributed(engine, "durable serving")

    snapshotter = EngineSnapshotter(snapshot_dir, every=snapshot_every,
                                    keep=keep)
    journal = RequestJournal(os.path.join(snapshot_dir, "journal.jsonl"))
    kw = dict(sched_kwargs or {})
    done: dict = {}

    def make_state(resume):
        events = read_events(journal.path)
        if resume is None and not events:
            sched = Scheduler(engine, journal=journal,
                              snapshotter=snapshotter, **kw)
            submit(sched)
            fresh = True
        else:
            sched = restore(snapshotter, engine, step=resume,
                            journal=journal, snapshotter=snapshotter,
                            **kw)
            replay(sched, events)
            fresh = False
        if on_start is not None:
            on_start(sched, fresh)
        done["sched"] = sched
        return sched

    try:
        run_with_restarts(make_state, lambda s: s.run(), snapshotter,
                          policy)
    finally:
        journal.close()
        snapshotter.close()     # re-raises a failed async snapshot
    return done["sched"]
