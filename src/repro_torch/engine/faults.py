"""Deterministic fault injection for the paged serving path.

Counterpart of ``repro.engine.faults``.  Faults are keyed by the call
index of the wrapped step function, so a test reproduces them exactly:

  * ``NonFiniteLogits(step, slot)``  — call ``step`` returns logits with
    ``slot``'s row set to NaN/inf (the scheduler's isfinite guard must
    quarantine exactly that slot);
  * ``TransientError(step, count)``  — calls [step, step+count) raise
    ``InjectedFault`` before the step runs (a retry advances the call
    index, so a short fault heals and a long one exhausts the budget);
  * ``SlowStep(step, delay_s)``      — call ``step`` sleeps first (the
    StragglerMonitor must flag it);
  * ``CrashFault(step)``             — every call from ``step`` on raises
    ``CrashError`` (simulated process death, which the step retry does
    not heal);
  * ``hold_pages(sched, n)``         — n pages vanish from the pool until
    the returned ``release()`` is called.

``inject(sched, decode_faults=..., prefill_faults=...)`` points the
scheduler at a delegating proxy of its engine, so the engine object
(possibly shared) is never changed.  ``random_plan(seed, ...)`` draws a
reproducible chaos schedule.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.engine.engine import NonFiniteLogitsError  # noqa: F401


class InjectedFault(RuntimeError):
    """The exception ``TransientError`` injections raise."""


class CrashError(RuntimeError):
    """Simulated process death: raised on every wrapped call from the
    crash step on, so it always escapes the scheduler's step retry
    (``RetryPolicy(fatal=(CrashError,))``)."""


@dataclasses.dataclass
class NonFiniteLogits:
    """Corrupt one slot's logits at wrapped-call index ``step``."""
    step: int
    slot: int = 0
    value: float = float("nan")


@dataclasses.dataclass
class TransientError:
    """Raise ``InjectedFault`` on wrapped-call indices
    [step, step + count): count=1 is a blip one retry heals, a large
    count a persistent fault."""
    step: int
    count: int = 1
    message: str = "injected transient fault"


@dataclasses.dataclass
class SlowStep:
    """Sleep ``delay_s`` before wrapped-call index ``step``."""
    step: int
    delay_s: float = 0.25


@dataclasses.dataclass
class CrashFault:
    """Raise ``CrashError`` on every wrapped-call index >= ``step``,
    before the step function runs."""
    step: int
    message: str = "injected crash (simulated process death)"


Fault = object   # NonFiniteLogits | TransientError | SlowStep | CrashFault


class FaultyStepFn:
    """A step function with a deterministic fault schedule keyed by call
    index (``.calls``; a retry is a new call).  The wrapped function
    returns a tuple whose first element is the logits — NonFiniteLogits
    corrupts that."""

    def __init__(self, fn: Callable, faults: Sequence[Fault] = ()):
        self.fn = fn
        self.faults = list(faults)
        self.calls = 0
        self.injected = 0

    def __call__(self, params, batch):
        k = self.calls
        self.calls += 1
        for f in self.faults:
            if isinstance(f, SlowStep) and f.step == k:
                self.injected += 1
                time.sleep(f.delay_s)
            elif isinstance(f, TransientError) \
                    and f.step <= k < f.step + f.count:
                self.injected += 1
                raise InjectedFault(f"{f.message} (call {k})")
            elif isinstance(f, CrashFault) and k >= f.step:
                self.injected += 1
                raise CrashError(f"{f.message} (call {k})")
        out = list(self.fn(params, batch))
        for f in self.faults:
            if isinstance(f, NonFiniteLogits) and f.step == k:
                self.injected += 1
                out[0] = out[0].clone()
                out[0][f.slot] = f.value
        return tuple(out)


class FaultyEngine:
    """Delegating engine proxy with fault-wrapped decode and prefill
    step functions; the underlying engine is never changed."""

    def __init__(self, eng, decode_faults: Sequence[Fault] = (),
                 prefill_faults: Sequence[Fault] = ()):
        self._eng = eng
        self.decode_fn = FaultyStepFn(eng.decode_fn, decode_faults)
        self.prefill_fn = FaultyStepFn(eng.prefill_fn, prefill_faults)

    def __getattr__(self, name):
        return getattr(self._eng, name)


def inject(sched, decode_faults: Sequence[Fault] = (),
           prefill_faults: Sequence[Fault] = ()) -> FaultyEngine:
    """Point ``sched`` at a fault-wrapped proxy of its engine and return
    the proxy (``proxy.decode_fn.injected`` counts fired faults)."""
    sched.eng = FaultyEngine(sched.eng, decode_faults, prefill_faults)
    return sched.eng


def hold_pages(sched_or_allocator, n: int) -> Callable[[], None]:
    """Pool pressure: allocate ``n`` pages out of the scheduler's pool.
    Returns an idempotent ``release()`` that gives them back."""
    alloc = getattr(sched_or_allocator, "allocator", sched_or_allocator)
    pages = alloc.alloc(n)
    released = [False]

    def release() -> None:
        if not released[0]:
            released[0] = True
            alloc.free(pages)
    return release


def random_plan(seed: int, n_steps: int, slots: int = 1,
                p_nonfinite: float = 0.02, p_transient: float = 0.02,
                p_slow: float = 0.0, slow_delay_s: float = 0.25,
                ) -> List[Fault]:
    """A reproducible chaos schedule: per step, independently draw each
    fault kind with the given probabilities (same seed -> same plan)."""
    rng = np.random.default_rng(seed)
    plan: List[Fault] = []
    for k in range(n_steps):
        if rng.random() < p_nonfinite:
            plan.append(NonFiniteLogits(
                step=k, slot=int(rng.integers(slots)),
                value=float(rng.choice([np.nan, np.inf, -np.inf]))))
        if rng.random() < p_transient:
            plan.append(TransientError(step=k))
        if p_slow and rng.random() < p_slow:
            plan.append(SlowStep(step=k, delay_s=slow_delay_s))
    return plan
