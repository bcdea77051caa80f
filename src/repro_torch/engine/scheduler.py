"""Continuous batching: request-level serving on the paged DecodeEngine.

Counterpart of ``repro.engine.scheduler`` without the prefix cache,
chunked prefill and durable serving (ROADMAP queue 1 items 7 and 9).
The engine's paged decode step runs as a slot machine:

  admit    a pending request takes a free slot: its prompt is prefilled
           alone (batch 1) and written into freshly allocated pages;
           the other slots are untouched;
  step     one decode step advances every active slot (per-slot lengths
           and block tables); inactive slots ride along masked;
  grow     a slot crossing a page boundary gets one more page, so a
           request holds ceil(len / page_size) pages, never max_len;
  preempt  when growth finds the pool dry, the latest-admitted slot goes
           back to the pending queue (pages freed now, prompt and
           generated prefix prefilled again at re-admission);
  retire   a finished request frees its pages and its slot at once.

Every request walks a status machine::

    PENDING -> RUNNING -> FINISHED
       |          |-> PREEMPTED -> (again)
       |          |-> FAILED / TIMED_OUT / CANCELLED
       |-> REJECTED               (over budget, the pool can never fit it)
       |-> CANCELLED / TIMED_OUT  (while still queued)

and every terminal state lands in ``finished`` as a ``RequestResult``
(an int32 token array carrying ``status`` / ``error`` / ``latency_s``).
A malformed request is REJECTED instead of raising away the stream, a
slot whose logits go NaN/inf is quarantined (FAILED) while the other
streams stay bit-identical, a transient step exception is retried with
bounded backoff (``runtime.resilience``), and a slot preempted more
than ``max_preemptions`` times is parked until the pool quiets.
Injectors for all of this are in ``engine.faults``.

All bookkeeping (free slots, pages, per-slot lengths, block tables) is
host-side numpy.  A step sends the device one buffer (token, lengths,
table, write ids and counts; ``models.lm.paged_step_meta``) and reads
back one (3, B) int32 array: the greedy pick, the sampled pick and the
finite flag of every slot.

Sampling cannot reproduce the JAX package's ``fold_in`` keys: a sampled
step is Gumbel-max with noise from a counter-based hash of (seed, step,
vocabulary index), deterministic per (seed, step) and decorrelated
between adjacent seeds.  Greedy streams are the JAX scheduler's.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.faults import CrashError
from repro_torch.engine.paged_cache import (PageAllocator,
                                            bucket_table_width,
                                            write_prefill)
from repro_torch.runtime.resilience import (Heartbeat, RetryPolicy,
                                            StragglerMonitor,
                                            call_with_retries, percentiles)


class RequestStatus(str, enum.Enum):
    """Request lifecycle states (terminal: FINISHED / REJECTED /
    FAILED / CANCELLED / TIMED_OUT)."""
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PREEMPTED = "PREEMPTED"
    FINISHED = "FINISHED"
    REJECTED = "REJECTED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    TIMED_OUT = "TIMED_OUT"


class RequestResult(np.ndarray):
    """The tokens of a terminal request, plus how it ended.

    An int32 ndarray view (``len(result)``, ``result[:k]``,
    ``assert_array_equal`` work as on the tokens), with ``status``,
    ``error`` (reason for a non-FINISHED terminal), ``latency_s``
    (submit -> terminal wall time) and ``token_times`` (monotonic wall
    time of each emitted token; ITL = np.diff of it)."""

    def __new__(cls, tokens, status: RequestStatus,
                error: Optional[str] = None,
                latency_s: Optional[float] = None,
                token_times: Optional[List[float]] = None):
        obj = np.asarray(tokens, np.int32).view(cls)
        obj.status = status
        obj.error = error
        obj.latency_s = latency_s
        obj.token_times = token_times
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.status = getattr(obj, "status", None)
        self.error = getattr(obj, "error", None)
        self.latency_s = getattr(obj, "latency_s", None)
        self.token_times = getattr(obj, "token_times", None)

    @property
    def tokens(self) -> np.ndarray:
        return np.asarray(self)

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED

    def __repr__(self):
        st = getattr(self, "status", None)
        err = getattr(self, "error", None)
        return (f"RequestResult({np.asarray(self).tolist()}, "
                f"status={getattr(st, 'value', st)}"
                + (f", error={err!r}" if err else "") + ")")


@dataclasses.dataclass
class Request:
    """One generation request.  ``tokens`` is the (P,) int32 prompt;
    ``gen`` counts generated tokens (the prefill's argmax included).

    ``deadline_s`` (wall seconds from ``submit()``) and ``max_steps``
    (decode steps) bound the request; crossing either ends it TIMED_OUT
    with the tokens so far.  ``status`` / ``error`` are the
    scheduler's."""
    rid: Any
    tokens: np.ndarray
    gen: int
    temperature: float = 0.0
    seed: int = 0
    deadline_s: Optional[float] = None
    max_steps: Optional[int] = None
    status: RequestStatus = RequestStatus.PENDING
    error: Optional[str] = None
    submit_t: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    req: Request
    length: int                     # valid cache positions
    pages: List[int]                # physical pages owned
    out: List[int]                  # generated tokens so far
    steps: int = 0                  # decode steps taken (sampling step)
    order: int = 0                  # admission sequence (LIFO preempt)
    preempts: int = 0               # times evicted (livelock watchdog)
    token_times: List[float] = dataclasses.field(default_factory=list)


# ---------------- the batched pick ----------------

_M32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift / multiply rounds) on int64
    values in [0, 2^32); the multipliers stay below 2^31, so no product
    overflows int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def gumbel_noise(seeds, steps, vocab: int, device) -> torch.Tensor:
    """(B, vocab) fp32 Gumbel(0, 1) noise, a pure function of each slot's
    (seed, step) and the vocabulary index: the same pair gives the same
    row on any device, adjacent seeds or steps give unrelated rows."""
    s = torch.as_tensor(seeds, dtype=torch.int64, device=device) & _M32
    t = torch.as_tensor(steps, dtype=torch.int64, device=device) & _M32
    key = _mix32(_mix32(s) ^ ((t * 0x61C88647) & _M32))
    idx = torch.arange(vocab, dtype=torch.int64, device=device)
    h = _mix32(_mix32(key[:, None] ^ idx[None, :]) ^ key[:, None])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))        # (0, 1)
    return -torch.log(-torch.log(u))


def pick_tokens(logits, seeds, steps, temps) -> np.ndarray:
    """Greedy argmax, the sampled pick (Gumbel-max at each slot's
    temperature; the greedy pick where no slot samples) and the isfinite
    flag of every row, stacked (3, B) int32 and read back in one
    device-to-host copy.  seeds/steps/temps: (B,) host arrays."""
    greedy = logits.argmax(-1)
    finite = torch.isfinite(logits).all(-1)
    sampled = greedy
    temps = np.asarray(temps, np.float32)
    if (temps > 0).any():
        safe_t = torch.as_tensor(np.where(temps > 0, temps, 1.0),
                                 device=logits.device)
        noise = gumbel_noise(seeds, steps, logits.shape[-1], logits.device)
        sampled = (logits / safe_t[:, None] + noise).argmax(-1)
    picked = torch.stack([greedy, sampled, finite.long()]).to(torch.int32)
    return picked.cpu().numpy()


class Scheduler:
    """Admit / step / retire requests over a paged ``DecodeEngine``.

    ``bucket_tables`` (default on) cuts the block table each step to the
    power-of-two width covering the longest active slot's pages
    (``paged_cache.bucket_table_width``), so the kernels walk only live
    pages; streams are identical either way, and ``stats
    ["table_widths"]`` counts the steps at each width.

    ``retry``            RetryPolicy for transient prefill/decode step
                         exceptions (bounded, linear backoff; the last
                         exception re-raises once spent).
    ``max_preemptions``  a slot evicted more than this many times is
                         parked until nothing else is runnable.
    ``straggler`` / ``heartbeat``  ``runtime.resilience`` monitors run
                         in every ``step()``.

    ``prefix_cache``, ``chunked_prefill``, ``journal`` and
    ``snapshotter`` are not ported yet and raise ``NotImplementedError``
    when set.
    """

    def __init__(self, engine, bucket_tables: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 max_preemptions: int = 3,
                 straggler: Optional[StragglerMonitor] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 prefix_cache: Optional[bool] = None,
                 chunked_prefill: Optional[bool] = None,
                 journal=None, snapshotter=None):
        if not engine.ecfg.paged:
            raise ValueError(
                "Scheduler needs a paged engine: EngineConfig("
                "paged=True, page_size=..., n_pages=...)")
        for name, value, item in (
                ("prefix_cache", prefix_cache, "item 7"),
                ("chunked_prefill", chunked_prefill, "item 7"),
                ("journal", journal, "item 9"),
                ("snapshotter", snapshotter, "item 9")):
            if value:
                raise NotImplementedError(
                    f"Scheduler({name}=...) is not ported to repro_torch "
                    f"yet: ROADMAP queue 1 {item}")
        self.eng = engine
        self.cfg = engine.cfg
        B, J = engine.ecfg.batch, engine.max_pages
        self.page_size = engine.page_size
        self.allocator = PageAllocator(engine.n_pages)
        self.slots: List[Optional[_Slot]] = [None] * B
        self.table = np.zeros((B, J), np.int32)
        self.lens = np.zeros((B,), np.int32)
        self.tokens = np.zeros((B,), np.int32)
        self.cache = engine.init_paged_cache()
        self.bucket_tables = bucket_tables
        # transient step faults retry; a simulated process death
        # (CrashError) surfaces at once
        self.retry = retry if retry is not None else RetryPolicy(
            fatal=(CrashError,))
        self.max_preemptions = max_preemptions
        self.straggler = straggler
        self.heartbeat = heartbeat
        self.pending: deque = deque()   # Request | preempted _Slot
        self.parked: deque = deque()    # watchdog-parked _Slots
        self.finished: Dict[Any, RequestResult] = {}
        self.stats = {"prefills": 0, "admitted": 0, "retired": 0,
                      "steps": 0, "peak_pages": 0, "preempted": 0,
                      "table_widths": {},   # width -> steps at it
                      "rejected": 0, "failed": 0, "cancelled": 0,
                      "timed_out": 0, "step_retries": 0,
                      "prefill_retries": 0, "parked": 0,
                      "straggler_flags": 0}
        self._latencies: List[float] = []
        self._itl: List[float] = []     # inter-token latency samples
        self._order = 0

    # ------------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def submit(self, req: Request) -> None:
        req.status = RequestStatus.PENDING
        req.submit_t = time.monotonic()
        self.pending.append(req)

    def results(self) -> Dict[Any, RequestResult]:
        return dict(self.finished)

    def latency_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Submit -> terminal wall-latency percentiles over every
        terminal request so far."""
        return percentiles(self._latencies, qs)

    def itl_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Inter-token-latency percentiles (seconds between consecutive
        tokens of a request) over every terminal request so far."""
        return percentiles(self._itl, qs)

    # ------------------------------------------------------------------
    # terminal transitions
    # ------------------------------------------------------------------

    def _terminal(self, req: Request, tokens, status: RequestStatus,
                  error: Optional[str] = None, *,
                  token_times: Optional[List[float]] = None
                  ) -> RequestResult:
        lat = (time.monotonic() - req.submit_t
               if req.submit_t is not None else None)
        req.status = status
        req.error = error
        res = RequestResult(np.asarray(list(tokens), np.int32), status,
                            error=error, latency_s=lat,
                            token_times=(list(token_times)
                                         if token_times else None))
        self.finished[req.rid] = res
        if lat is not None:
            self._latencies.append(lat)
        if token_times and len(token_times) > 1:
            self._itl.extend(
                np.diff(np.asarray(token_times, np.float64)).tolist())
        key = {RequestStatus.FINISHED: "retired",
               RequestStatus.REJECTED: "rejected",
               RequestStatus.FAILED: "failed",
               RequestStatus.CANCELLED: "cancelled",
               RequestStatus.TIMED_OUT: "timed_out"}[status]
        self.stats[key] += 1
        return res

    def _evict(self, slot_id: int) -> _Slot:
        """Release a slot's pages and batch row (no terminal record)."""
        slot = self.slots[slot_id]
        if slot.pages:
            self.allocator.decref(slot.pages)
            slot.pages = []
        self.slots[slot_id] = None
        self.lens[slot_id] = 0
        self.tokens[slot_id] = 0
        return slot

    def _retire(self, slot_id: int) -> None:
        slot = self._evict(slot_id)
        self._terminal(slot.req, slot.out, RequestStatus.FINISHED,
                       token_times=slot.token_times)

    def _fail_slot(self, slot_id: int, reason: str) -> None:
        slot = self._evict(slot_id)
        self._terminal(slot.req, slot.out, RequestStatus.FAILED, reason,
                       token_times=slot.token_times)

    def _preempt(self, slot_id: int) -> None:
        """Evict an active slot to the FRONT of the pending queue
        (recompute preemption): its pages free now and its prompt plus
        generated prefix is prefilled again at re-admission, so no token
        is lost.  A slot past ``max_preemptions`` is parked instead."""
        slot = self._evict(slot_id)
        slot.preempts += 1
        slot.req.status = RequestStatus.PREEMPTED
        if slot.preempts > self.max_preemptions:
            self.parked.append(slot)
            self.stats["parked"] += 1
        else:
            self.pending.appendleft(slot)
        self.stats["preempted"] += 1

    def cancel(self, rid: Any) -> bool:
        """Cancel a request wherever it is: mid-flight (slot and pages
        freed at once, partial tokens attached), pending, or parked.
        Returns False if ``rid`` is unknown or already terminal."""
        for slot_id, slot in enumerate(self.slots):
            if slot is not None and slot.req.rid == rid:
                slot = self._evict(slot_id)
                self._terminal(slot.req, slot.out,
                               RequestStatus.CANCELLED,
                               "cancelled mid-flight",
                               token_times=slot.token_times)
                return True
        for q, where in ((self.pending, "pending"),
                         (self.parked, "parked")):
            for item in list(q):
                req = item.req if isinstance(item, _Slot) else item
                if req.rid == rid:
                    q.remove(item)
                    toks = item.out if isinstance(item, _Slot) else []
                    self._terminal(req, toks, RequestStatus.CANCELLED,
                                   f"cancelled while {where}",
                                   token_times=getattr(
                                       item, "token_times", None))
                    return True
        return False

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    @staticmethod
    def _teacher_tokens(item) -> np.ndarray:
        """Every position the admission prefill occupies: the prompt,
        plus — for a preempted slot coming back — the generated prefix
        but its last token (the slot's pending input)."""
        req = item.req if isinstance(item, _Slot) else item
        tokens = np.asarray(req.tokens, np.int32)
        if isinstance(item, _Slot):
            tokens = np.concatenate(
                [tokens, np.asarray(item.out[:-1], np.int32)])
        return tokens

    def _pages_needed(self, positions: int, more_writes: bool) -> int:
        """Pages covering ``positions`` occupied slots — plus the page
        the next decode token writes to, when one is coming."""
        last = positions + 1 if more_writes else positions
        return -(-last // self.page_size)

    def _deadline_expired(self, req: Request) -> bool:
        return (req.deadline_s is not None
                and req.submit_t is not None
                and time.monotonic() - req.submit_t > req.deadline_s)

    def _validate(self, req: Request) -> Optional[str]:
        """Admission-blocking fault in ``req``, or None if admissible."""
        P = len(req.tokens)
        if P + req.gen - 1 > self.eng.ecfg.max_len:
            return (f"prompt {P} + gen {req.gen} exceeds engine "
                    f"max_len {self.eng.ecfg.max_len}")
        return None

    def admit(self) -> int:
        """Admit pending requests (or preempted slots) into free slots
        while pages allow.  Returns the number admitted (0 = no free
        slot, nothing pending, or the pool momentarily too full).

        A malformed request (over-budget prompt, larger than the whole
        pool) is REJECTED alone, and one whose deadline lapsed while
        queued ends TIMED_OUT here without a prefill."""
        if self.n_active == 0 and not self.pending and self.parked:
            # nothing else runnable: the parked slots get their turn
            while self.parked:
                self.pending.append(self.parked.popleft())
        admitted = 0
        while self.pending:
            try:
                slot_id = self.slots.index(None)
            except ValueError:
                break
            item = self.pending[0]
            resumed = isinstance(item, _Slot)
            req = item.req if resumed else item
            partial = item.out if resumed else []
            if self._deadline_expired(req):
                self.pending.popleft()
                self._terminal(req, partial, RequestStatus.TIMED_OUT,
                               f"deadline_s={req.deadline_s} lapsed "
                               "while queued",
                               token_times=getattr(
                                   item, "token_times", None))
                continue
            fault = self._validate(req)
            if fault is not None:
                self.pending.popleft()
                self._terminal(req, partial, RequestStatus.REJECTED,
                               fault)
                continue
            positions = len(self._teacher_tokens(item))
            need = self._pages_needed(positions,
                                      max(len(partial), 1) < req.gen)
            if need > self.allocator.n_pages:
                self.pending.popleft()
                self._terminal(
                    req, partial, RequestStatus.REJECTED,
                    f"needs {need} pages but the pool only has "
                    f"{self.allocator.n_pages} in total — raise "
                    "EngineConfig.n_pages or page_size")
                continue
            if need > self.allocator.free_pages:
                break               # wait for a retirement
            self.pending.popleft()
            if self._admit_into(slot_id, item,
                                self.allocator.alloc(need)):
                admitted += 1
        return admitted

    def _admit_into(self, slot_id: int, item, pages: List[int]) -> bool:
        """Prefill ``item`` (a fresh Request, or a preempted _Slot whose
        prompt and generated prefix go in again) into ``pages`` of
        ``slot_id``.  A prefill that keeps failing past the retry budget
        FAILs the request (pages released), not the stream.  Returns
        True if the slot went active."""
        resumed = isinstance(item, _Slot)
        req = item.req if resumed else item
        tokens = self._teacher_tokens(item)
        batch = {"tokens": torch.from_numpy(tokens)[None].to(
            self.eng.device)}

        def _count_retry(attempt, exc):
            self.stats["prefill_retries"] += 1

        try:
            logits, caches = call_with_retries(
                self.eng.prefill_fn, self.eng.params, batch,
                policy=self.retry, on_retry=_count_retry)
        except Exception as e:                      # noqa: BLE001
            self.allocator.decref(pages)
            self._terminal(req, item.out if resumed else [],
                           RequestStatus.FAILED,
                           f"prefill failed after "
                           f"{self.retry.max_retries} retries: {e}")
            return False
        self.stats["prefills"] += 1
        row = np.zeros((self.table.shape[1],), np.int32)
        row[:len(pages)] = pages
        write_prefill(self.cfg, self.cache, caches, row[None])
        if resumed:
            slot = _Slot(req=req, length=len(tokens), pages=list(pages),
                         out=list(item.out), steps=item.steps,
                         order=self._order, preempts=item.preempts,
                         token_times=list(item.token_times))
            tok = item.out[-1]
        else:
            # engine convention: the first generated token is the argmax
            # of the prefill logits
            tok = int(logits[0].argmax())
            slot = _Slot(req=req, length=len(tokens), pages=list(pages),
                         out=[tok], order=self._order,
                         token_times=[time.monotonic()])
        self._order += 1
        req.status = RequestStatus.RUNNING
        self.slots[slot_id] = slot
        self.table[slot_id] = row
        self.lens[slot_id] = slot.length
        self.tokens[slot_id] = tok
        self.stats["admitted"] += 1
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.allocator.used_pages)
        if len(slot.out) >= req.gen:
            self._retire(slot_id)   # gen=1: the prefill already ends it
        return True

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _grow_pages(self) -> None:
        """A slot whose next write opens a new page gets one more from
        the pool.  When the pool is dry, the LATEST-admitted active slot
        is preempted until the page fits (the needy slot itself, if it
        is the latest)."""
        for slot_id, slot in enumerate(self.slots):
            if slot is None:
                continue
            page_idx = slot.length // self.page_size
            if page_idx < len(slot.pages):
                continue
            while self.allocator.free_pages < 1:
                victim = max(
                    (s for s, sl in enumerate(self.slots)
                     if sl is not None),
                    key=lambda s: self.slots[s].order)
                self._preempt(victim)
                if victim == slot_id:
                    break           # the needy slot itself backed off
            if self.slots[slot_id] is None:
                continue
            (page,) = self.allocator.alloc(1)
            slot.pages.append(page)
            self.table[slot_id, page_idx] = page
            self.stats["peak_pages"] = max(
                self.stats["peak_pages"], self.allocator.used_pages)

    def _expire_deadlines(self) -> None:
        for slot_id, slot in enumerate(self.slots):
            if slot is None:
                continue
            req = slot.req
            if (req.max_steps is not None
                    and slot.steps >= req.max_steps):
                reason = f"max_steps={req.max_steps} reached"
            elif self._deadline_expired(req):
                reason = f"deadline_s={req.deadline_s} lapsed"
            else:
                continue
            slot = self._evict(slot_id)
            self._terminal(slot.req, slot.out, RequestStatus.TIMED_OUT,
                           reason, token_times=slot.token_times)

    def _run_decode(self, dbatch):
        def _count_retry(attempt, exc):
            self.stats["step_retries"] += 1
        # the step writes each active slot's new K/V in place; a retry
        # after a fault writes the same values at the same positions
        # again (on int8 pools the page scale is already max(s_old,
        # s_tok), so the requantization is the identity), so re-running
        # is safe
        return call_with_retries(self.eng.decode_fn, self.eng.params,
                                 dbatch, policy=self.retry,
                                 on_retry=_count_retry)

    def step(self) -> None:
        """One decode step for every RUNNING slot, then retirement.

        Deadlines expire first (TIMED_OUT with partial tokens), a
        transient step exception is retried up to ``retry.max_retries``
        times, and a slot whose logits hold NaN/inf is quarantined
        (FAILED) alone while the other slots go on."""
        if self.n_active == 0:
            return
        self._expire_deadlines()
        if self.n_active == 0:
            return
        self._grow_pages()
        if self.n_active == 0:      # growth preempted everything
            return
        running = [sid for sid, s in enumerate(self.slots) if s is not None]
        if self.straggler is not None:
            self.straggler.start_step()
        # table-width bucketing: after _grow_pages every active slot owns
        # the page its next write lands in, so the longest slot's page
        # count bounds every logical page the step reads
        W = self.table.shape[1]
        if self.bucket_tables:
            live = max(len(self.slots[s].pages) for s in running)
            W = bucket_table_width(live, W)
        self.stats["table_widths"][W] = \
            self.stats["table_widths"].get(W, 0) + 1
        dbatch = {"token": self.tokens, "cur_len": self.lens,
                  "block_table": self.table[:, :W], "cache": self.cache}
        logits, self.cache = self._run_decode(dbatch)
        self.stats["steps"] += 1
        B = len(self.slots)
        seeds = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        for sid in running:
            slot = self.slots[sid]
            seeds[sid] = slot.req.seed
            steps[sid] = slot.steps
            temps[sid] = slot.req.temperature
        greedy, sampled, finite = pick_tokens(logits, seeds, steps, temps)
        now = time.monotonic()
        for slot_id in running:
            slot = self.slots[slot_id]
            if not finite[slot_id]:
                self._fail_slot(
                    slot_id,
                    f"non-finite logits at decode step {slot.steps}")
                continue
            tok = int(sampled[slot_id] if slot.req.temperature > 0
                      else greedy[slot_id])
            slot.steps += 1
            slot.length += 1
            slot.out.append(tok)
            slot.token_times.append(now)
            self.lens[slot_id] = slot.length
            self.tokens[slot_id] = tok
            if len(slot.out) >= slot.req.gen:
                self._retire(slot_id)
        if self.straggler is not None:
            if self.straggler.end_step() is not None:
                self.stats["straggler_flags"] += 1
        if self.heartbeat is not None:
            self.heartbeat.beat(self.stats["steps"], extra={
                "active": self.n_active,
                "pending": len(self.pending),
                "finished": len(self.finished),
                "failed": self.stats["failed"],
                "retries": self.stats["step_retries"]})

    def run(self) -> Dict[Any, RequestResult]:
        """Drain the queue: admit / step until every request is
        terminal.  A deadlock (pending work, no active slot, still not
        enough pages) REJECTS the blocking request and goes on; results
        already finished are never lost."""
        while self.pending or self.parked or self.n_active:
            self.admit()
            if self.n_active == 0:
                if not (self.pending or self.parked):
                    break
                if not self.pending:
                    continue        # admit() unparks next time round
                item = self.pending.popleft()
                req = item.req if isinstance(item, _Slot) else item
                toks = item.out if isinstance(item, _Slot) else []
                self._terminal(
                    req, toks, RequestStatus.REJECTED,
                    f"page pool exhausted: cannot admit with "
                    f"{self.allocator.free_pages} free page(s) of "
                    f"{self.allocator.n_pages} and no active request "
                    "left to retire — raise EngineConfig.n_pages")
                continue
            self.step()
        return dict(self.finished)
