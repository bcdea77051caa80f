"""Continuous batching: request-level serving on the paged DecodeEngine.

Counterpart of ``repro.engine.scheduler``.  The engine's paged decode
step runs as a slot machine:

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

With ``prefix_cache`` admission first matches the longest cached
whole-page prefix of the prompt (``engine.prefix_cache``), aliases those
pages into the slot's table and prefills only the suffix
(``engine.suffix_prefill_fn``); pages are decref'd, never freed, and
under pool pressure cold trie leaves are evicted before any slot is
preempted.  With ``chunked_prefill`` admission grants a prompt all its
pages and a slot at once, and the prompt prefills ``chunk_tokens`` at a
time INSIDE the shared step (``engine.mixed_fn``: one chunk plus the
whole decode batch), packed under a token budget (``pack_chunk``) that
always runs every decoding slot, so a long prompt no longer stalls
decode between steps.

On an engine whose pools are sequence-sharded over a mesh
(``decode_shard='seq'``), every rank runs its own Scheduler over the
global allocator and tables, and writes only the pages its slab holds;
on a tensor-parallel engine, every rank's pools hold its kv heads of
every page.  Either way the collectives give every rank the same
logits, so the ranks admit, preempt and retire alike.  The prefix
cache, chunked prefill and the durability hooks are refused under a
mesh (ROADMAP queue 1 item 14).

Every request walks a status machine (PREFILLING only with chunked
prefill)::

    PENDING -> [PREFILLING ->] RUNNING -> FINISHED
       |          |               |-> PREEMPTED -> (again)
       |          |               |     (chunked: the in-flight chunk is
       |          |               |      dropped, completed pages kept)
       |          |               |-> FAILED / TIMED_OUT / CANCELLED
       |          `-> FAILED / TIMED_OUT / CANCELLED
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

Durable serving rides on top: with a ``journal`` (``engine.journal``)
every submit, cancel and terminal result is write-ahead logged, and a
``snapshotter`` (``engine.snapshot``) cuts the whole serving state every
N steps, so ``runtime.resilience.serve_with_recovery`` survives process
death with the crash-free run's streams.

All bookkeeping (free slots, pages, per-slot lengths, block tables, the
prefix trie) is host-side numpy.  A step sends the device one buffer
(token, lengths, table, write ids and counts, and a mixed step's chunk
tokens and pages; ``models.lm.paged_step_meta``) and reads back one
(3, B) int32 array — (3, B + 1) when a final chunk's logits seed its
request's first token: the greedy pick, the sampled pick and the finite
flag of every row.

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

from repro_torch.engine.engine import refuse_distributed
from repro_torch.engine.faults import CrashError
from repro_torch.engine.paged_cache import (PageAllocator,
                                            bucket_table_width, fork_page,
                                            write_prefill)
from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.runtime.resilience import (Heartbeat, RetryPolicy,
                                            StragglerMonitor,
                                            call_with_retries, percentiles)


class RequestStatus(str, enum.Enum):
    """Request lifecycle states (terminal: FINISHED / REJECTED /
    FAILED / CANCELLED / TIMED_OUT)."""
    PENDING = "PENDING"
    PREFILLING = "PREFILLING"   # chunked prefill in flight
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
    ``gen`` counts generated tokens (the prefill's argmax included);
    ``frontend_emb`` feeds the vlm / audio frontends: (frontend_tokens,
    frontend_dim) patch embeddings that open a vlm prompt, or (frames,
    frontend_dim) encoder input for audio.

    ``deadline_s`` (wall seconds from ``submit()``) and ``max_steps``
    (decode steps) bound the request; crossing either ends it TIMED_OUT
    with the tokens so far.  ``status`` / ``error`` are the
    scheduler's."""
    rid: Any
    tokens: np.ndarray
    gen: int
    temperature: float = 0.0
    seed: int = 0
    frontend_emb: Optional[np.ndarray] = None
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
    prefilled: int = 0              # chunked: prompt positions resident
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


def pick_tokens(logits, seeds, steps, temps, extra=None) -> np.ndarray:
    """Greedy argmax, the sampled pick (Gumbel-max at each slot's
    temperature; the greedy pick where no slot samples) and the isfinite
    flag of every row, stacked (3, B) int32 and read back in one
    device-to-host copy.  seeds/steps/temps: (B,) host arrays.  ``extra``
    (R, V) logits rows (a final chunk's) are picked greedily after the
    B slots, in the same copy: (3, B + R)."""
    if extra is not None:
        logits = torch.cat([logits, extra.to(logits.dtype)])
        seeds, steps, temps = (
            np.concatenate([a, np.zeros(extra.shape[0], a.dtype)])
            for a in map(np.asarray, (seeds, steps, temps)))
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


def pack_chunk(remaining: int, n_decode: int, budget: int,
               chunk_tokens: int, page_size: int) -> int:
    """Token-budget packing rule of one mixed step: how many prompt
    tokens of the head in-flight prefill ride along with ``n_decode``
    decoding slots under a ``budget``-token step.

    Decode is never starved: every decoding slot runs (the chunk takes
    only ``budget - n_decode`` tokens, down to zero), and the chunk never
    exceeds ``chunk_tokens``.  A non-final chunk is floored to a whole
    number of pages, so the NEXT chunk's resident prefix is whole pages
    (the suffix-prefill contract); the final chunk takes ``remaining``
    exactly, page-aligned or not.  Returns 0 when no chunk fits."""
    room = min(budget - n_decode, chunk_tokens)
    if room <= 0:
        return 0
    if room >= remaining:
        return remaining            # final chunk (may be unaligned)
    return (room // page_size) * page_size


class Scheduler:
    """Admit / step / retire requests over a paged ``DecodeEngine``.

    ``enc_len`` budgets the audio cross cache (encoder frames a slot,
    padded up to whole pages; default the engine's decoder ``max_len``,
    which is usually too short for speech: size it to the longest
    expected ``frontend_emb``).  A request with more frames is REJECTED.
    A vlm request's frontend positions count against its pages and the
    engine's ``max_len``, and a preempted one prefills its frontend again
    at re-admission.

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

    ``prefix_cache`` (None = the EngineConfig's) turns on prompt-prefix
    sharing: admission matches the longest cached whole-page prefix,
    increfs and aliases those pages into the slot's table and prefills
    only the suffix; retire and preempt decref, and when an allocation
    would exhaust the pool, refcount-1 LRU trie leaves are evicted
    before any slot is preempted.  Greedy streams equal the cache-off
    scheduler's for model-dtype pools (the suffix prefill reads exactly
    the K/V a cold prefill computes).  On int8 pools a hit's suffix
    prefill reads the prefix through the quantized pages where a cold
    prefill saw full precision, so a near-tie argmax can flip.

    ``chunked_prefill`` (None = the EngineConfig's) turns on chunked
    admission, packed by ``pack_chunk`` with the EngineConfig's
    ``chunk_tokens`` under a budget of ``batch + chunk_tokens`` tokens a
    step.  Greedy streams equal the unchunked scheduler's for
    model-dtype pools (each chunk is suffix-prefill math over the same
    kv block boundaries as the whole prefill); int8 pools carry the same
    near-tie caveat as a prefix hit.

    Counters (zero when the mode is off): ``prefix_hits``,
    ``prefix_misses``, ``prefix_hit_tokens``, ``prefix_evictions``,
    ``shared_pages`` (peak pages held twice or more), ``cow_forks``,
    ``mixed_steps``, ``chunks`` and ``chunked_tokens``.

    ``journal`` (an ``engine.journal.RequestJournal``) write-ahead logs
    every submit, cancel intent and terminal result; ``snapshotter`` (an
    ``engine.snapshot.EngineSnapshotter``) is called after every step and
    joined when ``run`` drains.  The JAX Scheduler's ``guard_nonfinite``,
    ``chunk_tokens`` and ``token_budget`` options are not taken: the port
    always guards and chunks ``EngineConfig.chunk_tokens`` under a budget
    of ``batch + chunk_tokens``.
    """

    def __init__(self, engine, enc_len: Optional[int] = None,
                 bucket_tables: bool = True,
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
        # a seq-sharded engine serves plain streams: every rank runs this
        # Scheduler alike over its slab of the pool
        if prefix_cache or (prefix_cache is None
                            and engine.ecfg.prefix_cache):
            refuse_distributed(engine, "the prefix cache")
        if chunked_prefill or (chunked_prefill is None
                               and engine.ecfg.chunked_prefill):
            refuse_distributed(engine, "chunked prefill")
        if journal is not None or snapshotter is not None:
            refuse_distributed(engine, "durable serving")
        self.eng = engine
        self.cfg = engine.cfg
        B, J = engine.ecfg.batch, engine.max_pages
        self.page_size = engine.page_size
        self.allocator = PageAllocator(engine.n_pages)
        # durability hooks (engine.journal / engine.snapshot): every
        # submit/cancel/terminal is write-ahead logged, and the
        # snapshotter cuts the full serving state every N steps
        self.journal = journal
        self.snapshotter = snapshotter
        self.slots: List[Optional[_Slot]] = [None] * B
        self.table = np.zeros((B, J), np.int32)
        self.lens = np.zeros((B,), np.int32)
        self.tokens = np.zeros((B,), np.int32)
        self.enc_lens = np.zeros((B,), np.int32)
        self.cache = engine.init_paged_cache(enc_len=enc_len)
        self.enc_budget = (self.cache["cross_k"].shape[2]
                           if self.cfg.family == "audio" else 0)
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
        if prefix_cache is None:
            prefix_cache = engine.ecfg.prefix_cache
        self.prefix: Optional[PrefixCache] = None
        if chunked_prefill is None:
            chunked_prefill = engine.ecfg.chunked_prefill
        if prefix_cache:
            if self.cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"prefix_cache supports the token-only families "
                    f"('dense', 'moe'); family {self.cfg.family!r} "
                    "prepends frontend positions a token-keyed prefix "
                    "index cannot match")
            if engine.suffix_prefill_fn is None:
                raise ValueError("engine has no suffix_prefill_fn — "
                                 "construct a paged dense or moe engine")
            self.prefix = PrefixCache(self.page_size, self.allocator)
        self.chunked = bool(chunked_prefill)
        self.chunk_tokens = 0
        self.token_budget = 0
        if self.chunked:
            if self.cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"chunked_prefill supports the token-only families "
                    f"('dense', 'moe'); got family {self.cfg.family!r}")
            if getattr(engine, "mixed_fn", None) is None:
                raise ValueError("engine has no mixed_fn — construct a "
                                 "paged dense or moe engine")
            ct = engine.ecfg.chunk_tokens
            if ct < 1 or ct % self.page_size:
                raise ValueError(
                    f"chunk_tokens must be a positive multiple of "
                    f"page_size {self.page_size}; got {ct} (a non-final "
                    "chunk must end page-aligned so the next chunk's "
                    "prefix is whole pages)")
            self.chunk_tokens = ct
            # the budget: every slot decodes AND a full chunk fits
            self.token_budget = B + ct
        self._prefilling: deque = deque()   # slot ids, chunking order
        self.stats = {"prefills": 0, "admitted": 0, "retired": 0,
                      "steps": 0, "peak_pages": 0, "preempted": 0,
                      "table_widths": {},   # width -> steps at it
                      "rejected": 0, "failed": 0, "cancelled": 0,
                      "timed_out": 0, "step_retries": 0,
                      "prefill_retries": 0, "parked": 0,
                      "straggler_flags": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefix_evictions": 0,
                      "shared_pages": 0, "cow_forks": 0,
                      "mixed_steps": 0, "chunks": 0, "chunked_tokens": 0}
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
        if self.journal is not None:
            # write-ahead: the submit is on disk (fsynced) before the
            # scheduler can act on it — an acknowledged request
            # survives a crash even if no snapshot ever sees it
            self.journal.submit(req)
        self.pending.append(req)

    def results(self) -> Dict[Any, RequestResult]:
        return dict(self.finished)

    def latency_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Submit -> terminal wall-latency percentiles over every
        terminal request so far."""
        return percentiles(self._latencies, qs)

    def itl_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Inter-token-latency percentiles (seconds between consecutive
        tokens of a request) over every terminal request so far: the
        tail is what a long prompt's prefill between steps inflates, and
        what chunked prefill cuts."""
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
        if self.journal is not None:
            self.journal.terminal(req.rid, res)
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

    def _clear_row(self, slot_id: int) -> None:
        if slot_id in self._prefilling:
            self._prefilling.remove(slot_id)
        self.slots[slot_id] = None
        self.lens[slot_id] = 0
        self.tokens[slot_id] = 0
        self.enc_lens[slot_id] = 0

    def _evict(self, slot_id: int) -> _Slot:
        """Release a slot's pages and batch row (no terminal record).
        Pages are decref'd, not freed: with the prefix cache on, a row
        may alias pages the trie or another slot still holds."""
        slot = self.slots[slot_id]
        if slot.pages:
            self.allocator.decref(slot.pages)
            slot.pages = []
        slot.prefilled = 0
        self._clear_row(slot_id)
        return slot

    def _retire(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        if self.prefix is not None:
            # index the retiring request's whole pages, prompt AND
            # generated tokens (a follow-up prompt that extends the
            # conversation hits the whole history); the cache holds
            # positions [0, length) = prompt + out[:-1]
            self.prefix.insert(self._teacher_tokens(slot), slot.pages)
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
        is lost.  A slot past ``max_preemptions`` is parked instead.

        A PREFILLING slot drops only its in-flight chunk: the whole pages
        its completed chunks wrote stay with the slot across the queue
        (``prefilled`` is page-aligned while PREFILLING), so re-admission
        grants the missing tail and resumes chunking where it left off;
        at least one tail page frees, so pool pressure still makes
        progress."""
        slot = self.slots[slot_id]
        if slot.req.status is RequestStatus.PREFILLING:
            keep = slot.prefilled // self.page_size
            tail = slot.pages[keep:]
            if tail:
                self.allocator.decref(tail)
            slot.pages = slot.pages[:keep]
            self._clear_row(slot_id)
        else:
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
        if self.journal is not None:
            # intent record — the terminal event that follows is what
            # replay treats as authoritative
            self.journal.cancel(rid)
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
                    self._release_queued(item)
                    toks = item.out if isinstance(item, _Slot) else []
                    self._terminal(req, toks, RequestStatus.CANCELLED,
                                   f"cancelled while {where}",
                                   token_times=getattr(
                                       item, "token_times", None))
                    return True
        return False

    def _release_queued(self, item) -> None:
        """Drop the pages a queued item still holds: a chunk-preempted
        slot keeps its completed prefix pages across the queue, and if it
        ends while queued they must be released here."""
        if isinstance(item, _Slot) and item.pages:
            self.allocator.decref(item.pages)
            item.pages = []
            item.prefilled = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _positions(self, item) -> int:
        """Every position the admission prefill of ``item`` occupies:
        ``_teacher_tokens``' and a vlm prompt's frontend."""
        return self.eng.prefill_positions(len(self._teacher_tokens(item)))

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
        P = self.eng.prefill_positions(len(req.tokens))
        if P + req.gen - 1 > self.eng.ecfg.max_len:
            return (f"prompt {P} + gen {req.gen} exceeds engine "
                    f"max_len {self.eng.ecfg.max_len}")
        if (self.cfg.family == "audio"
                and req.frontend_emb is not None
                and req.frontend_emb.shape[0] > self.enc_budget):
            return (f"{req.frontend_emb.shape[0]} encoder frames "
                    f"exceed the cross-cache budget {self.enc_budget} "
                    "— construct the Scheduler with enc_len >= the "
                    "longest expected frontend_emb")
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
                self._release_queued(item)
                self._terminal(req, partial, RequestStatus.TIMED_OUT,
                               f"deadline_s={req.deadline_s} lapsed "
                               "while queued",
                               token_times=getattr(
                                   item, "token_times", None))
                continue
            fault = self._validate(req)
            if fault is not None:
                self.pending.popleft()
                self._release_queued(item)
                self._terminal(req, partial, RequestStatus.REJECTED,
                               fault)
                continue
            # a chunk-preempted slot may come back with out == [] (it
            # never finished prefilling): the prefill emits its first
            # token, as for a fresh request
            positions = self._positions(item)
            need = self._pages_needed(positions,
                                      max(len(partial), 1) < req.gen)
            if need > self.allocator.n_pages:
                self.pending.popleft()
                self._release_queued(item)
                self._terminal(
                    req, partial, RequestStatus.REJECTED,
                    f"needs {need} pages but the pool only has "
                    f"{self.allocator.n_pages} in total — raise "
                    "EngineConfig.n_pages or page_size")
                continue
            # the pages a chunk-preempted slot kept across the queue hold
            # its completed prefix: no prefix match (the slot holds its
            # own refs), only the missing tail is allocated
            held = list(item.pages) if resumed else []
            # prefix match, incref'd NOW so the eviction below cannot
            # reclaim it; private pages cover the suffix and growth
            matched: List[int] = []
            if self.prefix is not None and not held:
                matched = self.prefix.match(self._teacher_tokens(item))
                if matched:
                    self.allocator.incref(matched)
            resident = held or matched
            private = need - len(resident)
            if private > self.allocator.free_pages \
                    and self.prefix is not None:
                # refcount-1 LRU trie leaves go before any preemption
                self.stats["prefix_evictions"] += self.prefix.evict(
                    private - self.allocator.free_pages)
            if private > self.allocator.free_pages:
                if matched:
                    self.allocator.decref(matched)
                break               # wait for a retirement
            self.pending.popleft()
            if self.prefix is not None and not held:
                if matched:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += \
                        len(matched) * self.page_size
                else:
                    self.stats["prefix_misses"] += 1
                self.stats["shared_pages"] = max(
                    self.stats["shared_pages"],
                    self.allocator.shared_pages)
            pages = resident + self.allocator.alloc(private)
            if self.chunked:
                ok = self._admit_chunked(slot_id, item, pages,
                                         n_resident=len(resident))
            else:
                ok = self._admit_into(slot_id, item, pages,
                                      n_shared=len(matched))
            if ok:
                admitted += 1
        return admitted

    def _admit_into(self, slot_id: int, item, pages: List[int],
                    n_shared: int = 0) -> bool:
        """Prefill ``item`` (a fresh Request, or a preempted _Slot whose
        prompt and generated prefix go in again) into ``pages`` of
        ``slot_id``.  The first ``n_shared`` pages are prefix-cache
        aliases already in the pool: the prefill runs over the suffix
        only (``engine.suffix_prefill_fn``, reading the shared pages)
        and the scatter writes only the private suffix pages.  A prefill
        that keeps failing past the retry budget FAILs the request
        (pages released), not the stream.  Returns True if the slot went
        active."""
        resumed = isinstance(item, _Slot)
        req = item.req if resumed else item
        tokens = self._teacher_tokens(item)
        M = n_shared * self.page_size       # cached positions (whole pages)
        batch = {"tokens": torch.from_numpy(tokens[M:])[None].to(
            self.eng.device)}
        if req.frontend_emb is not None:
            batch["frontend_emb"] = torch.as_tensor(
                req.frontend_emb, device=self.eng.device)[None]
        prefill_fn = self.eng.prefill_fn
        if n_shared:
            batch["pages"] = np.asarray(pages[:n_shared], np.int32)
            batch["cache"] = self.cache
            prefill_fn = self.eng.suffix_prefill_fn

        def _count_retry(attempt, exc):
            self.stats["prefill_retries"] += 1

        try:
            logits, caches = call_with_retries(
                prefill_fn, self.eng.params, batch,
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
        # only the suffix pages are written: the shared prefix pages hold
        # their K/V already and must never be written through
        write_prefill(self.cfg, self.cache, caches,
                      row[None, n_shared:len(pages)], enc_slots=[slot_id],
                      slab=self.eng.page_slab)
        if resumed:
            slot = _Slot(req=req, length=self._positions(item),
                         pages=list(pages),
                         out=list(item.out), steps=item.steps,
                         order=self._order, preempts=item.preempts,
                         token_times=list(item.token_times))
            tok = item.out[-1]
        else:
            # engine convention: the first generated token is the argmax
            # of the prefill logits
            tok = int(logits[0].argmax())
            slot = _Slot(req=req, length=self._positions(item),
                         pages=list(pages),
                         out=[tok], order=self._order,
                         token_times=[time.monotonic()])
        self._order += 1
        req.status = RequestStatus.RUNNING
        self.slots[slot_id] = slot
        self.table[slot_id] = row
        self.lens[slot_id] = slot.length
        self.tokens[slot_id] = tok
        self.enc_lens[slot_id] = (req.frontend_emb.shape[0]
                                  if self.cfg.family == "audio"
                                  and req.frontend_emb is not None else 0)
        self.stats["admitted"] += 1
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.allocator.used_pages)
        if self.prefix is not None:
            # index the prefilled whole pages now, so concurrent
            # requests that share this prompt hit while it is in flight
            # (re-inserting a matched prefix creates no node)
            self.prefix.insert(tokens, slot.pages)
        if len(slot.out) >= req.gen:
            self._retire(slot_id)   # gen=1: the prefill already ends it
        return True

    def _admit_chunked(self, slot_id: int, item, pages: List[int],
                       n_resident: int = 0) -> bool:
        """Grant pages and enqueue chunks: no model call here.  The slot
        goes PREFILLING with all its pages granted, and later mixed
        steps prefill ``chunk_tokens`` at a time.  The first
        ``n_resident`` pages already hold K/V (a prefix-cache match, or
        the completed pages a chunk-preempted slot kept), so chunking
        starts at position ``n_resident * page_size``.  Meanwhile the
        slot rides the decode batch with length 0 (no write, masked,
        its logits discarded)."""
        resumed = isinstance(item, _Slot)
        req = item.req if resumed else item
        slot = item if resumed else _Slot(req=req, length=0, pages=[],
                                          out=[])
        slot.pages = list(pages)
        slot.prefilled = n_resident * self.page_size
        slot.length = 0
        slot.order = self._order
        self._order += 1
        req.status = RequestStatus.PREFILLING
        self.slots[slot_id] = slot
        row = np.zeros((self.table.shape[1],), np.int32)
        row[:len(pages)] = pages
        self.table[slot_id] = row
        self.lens[slot_id] = 0
        self.tokens[slot_id] = 0
        self._prefilling.append(slot_id)
        self.stats["admitted"] += 1
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.allocator.used_pages)
        return True

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _grow_pages(self) -> None:
        """A slot whose next write opens a new page gets one more from
        the pool.  When the pool is dry, refcount-1 LRU trie leaves are
        evicted first; only then is the LATEST-admitted active slot
        preempted until the page fits (the needy slot itself, if it is
        the latest).  A preempted slot's trie-held prefix pages stay
        resident and become evictable next round, so the loop ends."""
        for slot_id, slot in enumerate(self.slots):
            if slot is None:
                continue
            page_idx = slot.length // self.page_size
            if page_idx < len(slot.pages):
                continue
            while self.allocator.free_pages < 1:
                if self.prefix is not None:
                    self.stats["prefix_evictions"] += self.prefix.evict(1)
                    if self.allocator.free_pages >= 1:
                        break
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

    def _cow_guard(self) -> None:
        """Copy-on-write: fork any slot's WRITE page (where its next
        decode token lands) that is shared (refcount > 1), so the write
        cannot corrupt another reader's prefix.  The scheduler's own
        path never needs it (matched prefixes are whole pages, tail and
        growth pages private), but an outside incref (a snapshot, a
        test) makes a write page shared, and this keeps aliasing safe."""
        for slot_id, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.req.status is RequestStatus.PREFILLING:
                # no decode write while chunking, and chunks write only
                # private suffix pages
                continue
            wp = slot.length // self.page_size
            page = slot.pages[wp]
            if self.allocator.refcount(page) <= 1:
                continue
            if self.allocator.free_pages < 1:
                self.stats["prefix_evictions"] += self.prefix.evict(1)
            if self.allocator.free_pages < 1:
                # no page to fork into: back this slot off rather than
                # write through a shared page
                self._preempt(slot_id)
                continue
            (new,) = self.allocator.alloc(1)
            fork_page(self.cfg, self.cache, page, new)
            slot.pages[wp] = new
            self.table[slot_id, wp] = new
            self.allocator.decref([page])
            self.stats["cow_forks"] += 1
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

    def _run_step(self, fn, batch):
        def _count_retry(attempt, exc):
            self.stats["step_retries"] += 1
        # a step writes each active slot's new K/V (and a mixed step its
        # chunk's pages) in place; a retry after a fault writes the same
        # values at the same positions again (on int8 pools the page
        # scale is already max(s_old, s_tok), so the requantization is
        # the identity, and a chunk's pages are quantized whole), so
        # re-running is safe and redoes only the in-flight chunk
        return call_with_retries(fn, self.eng.params, batch,
                                 policy=self.retry, on_retry=_count_retry)

    def _pack_chunk_for_step(self, n_decode: int):
        """(slot_id, C) of the head in-flight prefill's next chunk under
        the token budget, or (None, 0) when nothing chunks this step."""
        if not (self.chunked and self._prefilling):
            return None, 0
        sid = self._prefilling[0]
        slot = self.slots[sid]
        remaining = len(self._teacher_tokens(slot)) - slot.prefilled
        C = pack_chunk(remaining, n_decode, self.token_budget,
                       self.chunk_tokens, self.page_size)
        return (sid, C) if C > 0 else (None, 0)

    def _promote(self, slot_id: int, tok: int, finite: bool) -> None:
        """Final chunk done: the slot leaves PREFILLING and joins the
        decode batch next step, as at the end of ``_admit_into``: the
        first token is the greedy pick ``tok`` of the final chunk's
        logits for a fresh request, the pending generated token for a
        resumed one; the prefilled prefix is indexed into the trie.
        Non-finite chunk logits (``finite`` False) FAIL the request
        alone."""
        slot = self.slots[slot_id]
        req = slot.req
        if not finite:
            self._fail_slot(slot_id, "non-finite logits in chunked "
                            "prefill (final chunk)")
            return
        self.stats["prefills"] += 1
        if slot.out:
            tok = slot.out[-1]
            slot.length = self._positions(slot)
        else:
            slot.out = [tok]
            slot.length = self.eng.prefill_positions(len(req.tokens))
            slot.token_times.append(time.monotonic())
        req.status = RequestStatus.RUNNING
        self.lens[slot_id] = slot.length
        self.tokens[slot_id] = tok
        if self.prefix is not None:
            self.prefix.insert(self._teacher_tokens(slot), slot.pages)
        if len(slot.out) >= req.gen:
            self._retire(slot_id)   # gen=1: the prefill already ends it

    def step(self) -> None:
        """One decode step for every RUNNING slot — in chunked mode with
        up to ``chunk_tokens`` of the head in-flight prompt packed into
        the same call (``engine.mixed_fn``) under the token budget —
        then retirement.

        Deadlines expire first (TIMED_OUT with partial tokens), a
        transient step exception is retried up to ``retry.max_retries``
        times (a mixed-step retry redoes only the current chunk), and a
        slot whose logits hold NaN/inf is quarantined (FAILED) alone
        while the other slots go on (a PREFILLING slot at its final
        chunk, where its logits first matter)."""
        if self.n_active == 0:
            return
        self._expire_deadlines()
        if self.n_active == 0:
            return
        self._grow_pages()
        if self.n_active == 0:      # growth preempted everything
            return
        if self.prefix is not None:
            self._cow_guard()
            if self.n_active == 0:
                return
        # who decodes THIS step: PREFILLING slots ride the batch masked,
        # and a slot promoted after the mixed call must not take this
        # step's (garbage) logits row
        running = [sid for sid, s in enumerate(self.slots)
                   if s is not None
                   and s.req.status is not RequestStatus.PREFILLING]
        c_slot, C = self._pack_chunk_for_step(len(running))
        if c_slot is None and not running:
            return                  # nothing decodes, nothing chunks
        if self.straggler is not None:
            self.straggler.start_step()
        # table-width bucketing: after _grow_pages every active slot owns
        # the page its next write lands in, so the longest slot's page
        # count bounds every logical page the step reads
        W = self.table.shape[1]
        if self.bucket_tables:
            live = max(len(s.pages) for s in self.slots if s is not None)
            W = bucket_table_width(live, W)
        self.stats["table_widths"][W] = \
            self.stats["table_widths"].get(W, 0) + 1
        dbatch = {"token": self.tokens, "cur_len": self.lens,
                  "block_table": self.table[:, :W], "cache": self.cache}
        if self.cfg.family == "audio":
            dbatch["enc_lens"] = self.enc_lens
        final = None                # the final chunk's logits row
        if c_slot is not None:
            slot = self.slots[c_slot]
            toks = self._teacher_tokens(slot)
            p0 = slot.prefilled
            jp = p0 // self.page_size               # whole prefix pages
            jw = -(-(p0 + C) // self.page_size)     # end page (excl.)
            dbatch["chunk_tokens"] = toks[p0:p0 + C]
            dbatch["chunk_pages"] = np.asarray(slot.pages[:jp], np.int32)
            dbatch["chunk_write_pages"] = np.asarray(slot.pages[jp:jw],
                                                     np.int32)
            logits, chunk_logits, self.cache = self._run_step(
                self.eng.mixed_fn, dbatch)
            self.stats["mixed_steps"] += 1
            self.stats["chunks"] += 1
            self.stats["chunked_tokens"] += C
            slot.prefilled = p0 + C
            if slot.prefilled >= len(toks):
                self._prefilling.popleft()
                final = chunk_logits
        else:
            logits, self.cache = self._run_step(self.eng.decode_fn, dbatch)
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
        greedy, sampled, finite = pick_tokens(logits, seeds, steps, temps,
                                              extra=final)
        if final is not None:
            self._promote(c_slot, int(greedy[B]), bool(finite[B]))
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
        if self.snapshotter is not None:
            # the cadence: the host copy happens here, the disk writes
            # on the store's background worker
            self.snapshotter.on_step(self)

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
                self._release_queued(item)
                self._terminal(
                    req, toks, RequestStatus.REJECTED,
                    f"page pool exhausted: cannot admit with "
                    f"{self.allocator.free_pages} free page(s) of "
                    f"{self.allocator.n_pages} and no active request "
                    "left to retire — raise EngineConfig.n_pages")
                continue
            self.step()
        if self.snapshotter is not None:
            # surface a failed background snapshot at run end instead
            # of silently dropping it with the drained queue
            self.snapshotter.wait()
        return dict(self.finished)
