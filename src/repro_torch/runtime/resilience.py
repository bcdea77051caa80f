"""Fault-tolerance runtime for serving: straggler monitor, heartbeat,
bounded retries and latency percentiles.

The port's own copy of the serving half of ``repro.runtime.resilience``
(the port imports nothing of the JAX package).  The scheduler
(``engine.scheduler``) runs a StragglerMonitor and a Heartbeat in its
step loop, bounds transient step and prefill faults with
``RetryPolicy``/``call_with_retries``, and summarizes per-request
latency with ``percentiles``.  ``RestartPolicy``, ``run_with_restarts``
and ``serve_with_recovery`` belong to durable serving (snapshots and
the request journal), which is not ported yet (ROADMAP queue 1 item 9).
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
