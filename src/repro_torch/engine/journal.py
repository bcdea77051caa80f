"""Write-ahead request journal: the durability half the snapshot alone
cannot provide.

The port's own copy of ``repro.engine.journal`` (pure Python: the port
imports nothing of the JAX package); the events and their JSON are the
same, so a journal written by either package replays in the other: a
request's ``frontend_emb`` rides in the JAX encoding, ``{"data": nested
list, "dtype": numpy dtype name}``.

A snapshot (``engine.snapshot``) captures the serving state every N
steps; everything that happened SINCE the last snapshot — requests
submitted, requests cancelled, requests that went terminal — would be
lost on a crash without a finer-grained record.  This module keeps
that record as an append-only JSONL log, one fsynced line per event:

  ``submit``    the full request (rid, prompt tokens, gen budget,
                temperature, seed, frontend embeddings, deadline,
                max_steps) — enough to re-queue it verbatim;
  ``cancel``    the cancellation intent (rid);
  ``terminal``  the finished ``RequestResult`` (tokens, status, error,
                latency, token timestamps) — recovered VERBATIM on
                replay, so a result the pre-crash process already
                produced is never lost and never recomputed.

Recovery = load the latest snapshot (or a fresh scheduler when the
crash beat the first cadence) + ``replay`` the journal.  Replay is
idempotent, so no snapshot/journal offset bookkeeping is needed: an
event whose effect is already inside the restored snapshot (a submit
whose request is live, a terminal already in ``finished``) is a no-op,
and only the journal *suffix* — events after the snapshot was cut —
changes the restored state:

  * ``terminal`` is authoritative: the result is recorded verbatim and
    the rid's live residue (slot, queue entry) is released — its decode
    already happened in the pre-crash process;
  * ``submit`` of an unknown rid re-queues the request in original
    arrival order (the journal is the arrival order);
  * ``cancel`` of a still-live rid re-applies — unless a ``terminal``
    for the same rid appears later in the log (cancel is journaled as
    *intent* before its effect), in which case the cancel is a no-op
    and the terminal alone is recovered, verbatim.

The log survives its own crash: a torn final line (the process died
mid-append) is skipped by ``read_events`` and truncated by
``RequestJournal`` on reopen, so the recovered process's appends start
on a clean line boundary.  Rids must be JSON-representable and unique
across the log's lifetime.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np


def _req_event(req) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ev": "submit",
        "rid": req.rid,
        "tokens": np.asarray(req.tokens, np.int32).tolist(),
        "gen": int(req.gen),
        "temperature": float(req.temperature),
        "seed": int(req.seed),
        "deadline_s": req.deadline_s,
        "max_steps": req.max_steps,
    }
    if req.frontend_emb is not None:
        ev["frontend_emb"] = encode_emb(req.frontend_emb)
    return ev


def encode_emb(emb) -> Dict[str, Any]:
    """Frontend embeddings as the JAX package's journal and snapshots
    write them."""
    emb = np.asarray(emb)
    return {"data": emb.tolist(), "dtype": str(emb.dtype)}


def decode_emb(rec):
    """``encode_emb``'s record back to an array (None stays None)."""
    if rec is None:
        return None
    return np.asarray(rec["data"], np.dtype(rec["dtype"]))


def request_from_event(ev: Dict[str, Any]):
    """Rebuild a fresh ``Request`` from a ``submit`` journal event."""
    from repro_torch.engine.scheduler import Request
    return Request(rid=ev["rid"],
                   tokens=np.asarray(ev["tokens"], np.int32),
                   gen=int(ev["gen"]),
                   temperature=float(ev.get("temperature", 0.0)),
                   seed=int(ev.get("seed", 0)),
                   frontend_emb=decode_emb(ev.get("frontend_emb")),
                   deadline_s=ev.get("deadline_s"),
                   max_steps=ev.get("max_steps"))


class RequestJournal:
    """Append-only fsynced JSONL write-ahead log of request events.

    Each append is flushed AND fsynced before returning — a submit
    acknowledged to the client is on disk before the scheduler touches
    it, which is what makes "no acknowledged request is ever lost" a
    guarantee rather than a race."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _repair_tail(path)
        self._f = open(path, "a", encoding="utf-8")
        # make the directory entry itself durable: without this, a
        # crash shortly after creation can lose the whole file — and
        # every "durably acknowledged" event in it — on filesystems
        # that don't persist the parent dir as a side effect
        _fsync_dir(d or ".")
        self.appended = 0

    def _append(self, ev: Dict[str, Any]) -> None:
        self._f.write(json.dumps(ev) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self.appended += 1

    # scheduler-facing hooks -------------------------------------------

    def submit(self, req) -> None:
        self._append(_req_event(req))

    def cancel(self, rid: Any) -> None:
        self._append({"ev": "cancel", "rid": rid})

    def terminal(self, rid: Any, res) -> None:
        self._append({
            "ev": "terminal",
            "rid": rid,
            "tokens": np.asarray(res, np.int32).tolist(),
            "status": res.status.value,
            "error": res.error,
            "latency_s": res.latency_s,
            "token_times": res.token_times,
        })

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _repair_tail(path: str) -> None:
    """Truncate a torn final line (the previous writer died
    mid-append) before reopening for append.  Anything after the last
    complete ``\\n``-terminated line was never acknowledged — the
    append only returns after write+fsync of the full line — so
    dropping it loses nothing, and NOT dropping it would glue the
    next append onto the torn fragment, corrupting an event that IS
    acknowledged and failing recovery on a second crash."""
    try:
        if os.path.getsize(path) == 0:
            return
    except OSError:
        return                      # no file yet: nothing to repair
    with open(path, "rb") as f:
        data = f.read()
    if data.endswith(b"\n"):
        return
    with open(path, "r+b") as f:
        f.truncate(data.rfind(b"\n") + 1)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return                      # platform can't open dirs: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse the journal, tolerating a torn final line (the writer
    died mid-append; everything before it is intact because each
    append was fsynced).  A torn line ANYWHERE else is corruption and
    raises."""
    if not os.path.exists(path):
        return []
    events: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break               # torn tail: the crash mid-append
            raise ValueError(
                f"corrupt journal line {i + 1} of {len(lines)} in "
                f"{path!r} (not the tail — this is not a torn append)")
    return events


def replay(sched, events: List[Dict[str, Any]]) -> Dict[str, int]:
    """Apply the journal to a restored (or fresh) scheduler,
    idempotently.  Returns counters: ``recovered`` terminal results
    recorded verbatim, ``requeued`` submits re-queued, ``cancelled``
    live cancels re-applied, ``noop`` events whose effect was already
    in the snapshot.  Journaling is suppressed during replay — the
    events being applied are already on disk."""
    from repro_torch.engine.scheduler import RequestResult, RequestStatus

    stats = {"recovered": 0, "requeued": 0, "cancelled": 0, "noop": 0}
    # rids whose terminal is somewhere in the log: their cancel lines
    # (journaled as intent BEFORE the terminal) must not re-run
    # sched.cancel(), which would synthesize a fresh CANCELLED result
    # from snapshot-time partial state and shadow the verbatim one
    terminal_rids = {ev["rid"] for ev in events if ev["ev"] == "terminal"}
    saved_journal, sched.journal = sched.journal, None
    try:
        for ev in events:
            rid = ev["rid"]
            kind = ev["ev"]
            if kind == "terminal":
                if rid in sched.finished:
                    stats["noop"] += 1
                    continue
                _drop_live(sched, rid,
                           RequestStatus(ev["status"]))
                sched.finished[rid] = RequestResult(
                    np.asarray(ev["tokens"], np.int32),
                    RequestStatus(ev["status"]),
                    error=ev.get("error"),
                    latency_s=ev.get("latency_s"),
                    token_times=ev.get("token_times"))
                stats["recovered"] += 1
            elif kind == "submit":
                if rid in sched.finished or _find_live(sched, rid):
                    stats["noop"] += 1
                    continue
                sched.submit(request_from_event(ev))
                stats["requeued"] += 1
            elif kind == "cancel":
                if (rid in terminal_rids or rid in sched.finished
                        or not _find_live(sched, rid)):
                    stats["noop"] += 1
                    continue
                sched.cancel(rid)
                stats["cancelled"] += 1
            else:
                raise ValueError(f"unknown journal event {kind!r}")
    finally:
        sched.journal = saved_journal
    return stats


def _find_live(sched, rid: Any) -> bool:
    from repro_torch.engine.scheduler import _Slot
    for slot in sched.slots:
        if slot is not None and slot.req.rid == rid:
            return True
    for q in (sched.pending, sched.parked):
        for item in q:
            req = item.req if isinstance(item, _Slot) else item
            if req.rid == rid:
                return True
    return False


def _drop_live(sched, rid: Any, status) -> None:
    """Release the live residue of a rid whose terminal result is
    being recovered verbatim: its decode already happened in the
    pre-crash process, so the restored slot/queue entry must not run
    again (or the result would be produced twice).  A FINISHED slot's
    resident prefix is indexed into the prefix trie first, mirroring
    what ``_retire`` did pre-crash, so post-recovery admissions keep
    hitting the shared prompt."""
    from repro_torch.engine.scheduler import RequestStatus, _Slot
    for slot_id, slot in enumerate(sched.slots):
        if slot is not None and slot.req.rid == rid:
            if (status is RequestStatus.FINISHED
                    and sched.prefix is not None and slot.pages
                    and slot.req.status is not RequestStatus.PREFILLING):
                toks = np.concatenate([
                    np.asarray(slot.req.tokens, np.int32),
                    np.asarray(slot.out[:-1], np.int32)])
                sched.prefix.insert(toks, slot.pages)
            sched._evict(slot_id)
            return
    for q in (sched.pending, sched.parked):
        for item in list(q):
            req = item.req if isinstance(item, _Slot) else item
            if req.rid == rid:
                q.remove(item)
                sched._release_queued(item)
                return
