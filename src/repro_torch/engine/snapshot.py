"""Engine snapshots: the full serving state, crash-consistently on disk.

Counterpart of ``repro.engine.snapshot``.  The scheduler's state is the
paged KV pool (int8 scale sidecars included) plus the host bookkeeping
that makes those pages mean something: the ``PageAllocator``
free/owned/refcount partition, per-slot block tables, request lifecycle
(PENDING/PREFILLING/RUNNING, chunked-prefill progress, generated
prefixes, per-request sampling seed and step), the pending queue and
parked set, the ``PrefixCache`` radix trie, finished results and
counters.  ``snapshot`` serializes ALL of it through
``checkpoint.CheckpointStore``'s shard format — the device pools as
``.npy`` shards, the host state as one JSON blob riding as a uint8 leaf
— so a snapshot inherits the store's crash-consistency discipline:
written into ``step_N.tmp``, committed with a fsynced ``_COMPLETE``
marker, atomically renamed.  A crash mid-snapshot leaves the previous
snapshot intact; keep-k GC bounds disk.  The JSON has the JAX
package's field names and the pools its leaf keys and layouts, so a
snapshot written by either package restores in the other.

``restore`` rebuilds a ``Scheduler`` over a live engine (the engine —
params, step functions — is NOT part of the snapshot) and resumes
decode bit-exactly:

  * the pool bytes round-trip exactly (bf16 by its 16-bit words, int8
    and the fp32 scales as they are), copied into the pools the fresh
    Scheduler allocated (``copy_``), so every layer keeps the 16-byte
    aligned stride the kernels take it at
    (``paged_cache._layer_aligned_zeros``);
  * the allocator free list is restored IN ORDER (``alloc`` pops from
    the end — order is what makes post-restore page assignment, and
    thus block tables, replay deterministically);
  * each slot's ``steps`` counter is its sampling state (the Gumbel
    noise of a sampled step is a hash of (seed, step)), so sampling
    resumes on the same noise;
  * monotonic timestamps (submit times, token times) are rebased by
    the snapshot->restore clock delta, so deadlines and ITL stats stay
    meaningful across a process restart.

Where the port departs from JAX:

  * the cut is a true copy, made before ``snapshot`` returns: the
    port's steps write the pools in place (JAX's functional step never
    mutates a published cache), so the store copies every pool to host
    memory synchronously and only the ``.npy`` writes go to its
    background worker;
  * the ``"sched"`` block's ``guard_nonfinite``, ``chunk_tokens`` and
    ``token_budget`` are what the port's Scheduler derives (it always
    guards; chunks and budget come from the EngineConfig), and
    ``restore`` refuses a snapshot whose values differ (``ValueError``
    naming the field); ``enc_len`` (the audio cross cache's positions a
    slot) is restored like the options, and refused where the engine
    has no cross cache to give it.

``EngineSnapshotter`` adds the cadence: every ``every`` steps the
scheduler's step path cuts the state and hands the disk writes to the
store's background worker.  ``wait()``/``close()`` join the writer and
re-raise its failure, so a dying disk is never silently dropped.

Greedy token streams are pinned bit-identical crash+recover vs
crash-free (gqa/mla x bf16/int8 x prefix-cache x chunked-prefill in
``tests/test_torch_snapshot.py``).  One caveat rides along from the
prefix cache: recovery re-indexes a FINISHED slot's prefix only up to
its snapshot-time length, and a terminal recovered from the journal
frees its slot at the snapshot's step rather than at its own, so a
post-recovery admission may match a shorter cached prefix and run
beside other slot mates than it would have pre-crash; on int8 pools a
near-tie argmax in such a stream can flip (the same caveat a cache hit
already carries vs a cold prefill).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.engine.engine import refuse_distributed
from repro_torch.engine.journal import decode_emb, encode_emb

SNAPSHOT_VERSION = 1


# ----------------------------------------------------------------------
# host-state (de)serialization
# ----------------------------------------------------------------------

def _req_state(req) -> Dict[str, Any]:
    d = {"rid": req.rid,
         "tokens": np.asarray(req.tokens, np.int32).tolist(),
         "gen": int(req.gen),
         "temperature": float(req.temperature),
         "seed": int(req.seed),
         "deadline_s": req.deadline_s,
         "max_steps": req.max_steps,
         "status": req.status.value,
         "error": req.error,
         "submit_t": req.submit_t}
    if req.frontend_emb is not None:
        d["frontend_emb"] = encode_emb(req.frontend_emb)
    return d


def _req_from_state(d: Dict[str, Any], delta: float):
    from repro_torch.engine.scheduler import Request, RequestStatus
    return Request(rid=d["rid"],
                   tokens=np.asarray(d["tokens"], np.int32),
                   gen=int(d["gen"]),
                   temperature=float(d["temperature"]),
                   seed=int(d["seed"]),
                   frontend_emb=decode_emb(d.get("frontend_emb")),
                   deadline_s=d.get("deadline_s"),
                   max_steps=d.get("max_steps"),
                   status=RequestStatus(d["status"]),
                   error=d.get("error"),
                   submit_t=(d["submit_t"] + delta
                             if d.get("submit_t") is not None else None))


def _slot_state(slot) -> Dict[str, Any]:
    return {"req": _req_state(slot.req),
            "length": int(slot.length),
            "pages": [int(p) for p in slot.pages],
            "out": [int(t) for t in slot.out],
            "steps": int(slot.steps),
            "order": int(slot.order),
            "preempts": int(slot.preempts),
            "prefilled": int(slot.prefilled),
            "token_times": list(slot.token_times)}


def _slot_from_state(d: Dict[str, Any], delta: float):
    from repro_torch.engine.scheduler import _Slot
    return _Slot(req=_req_from_state(d["req"], delta),
                 length=int(d["length"]),
                 pages=[int(p) for p in d["pages"]],
                 out=[int(t) for t in d["out"]],
                 steps=int(d["steps"]),
                 order=int(d["order"]),
                 preempts=int(d["preempts"]),
                 prefilled=int(d["prefilled"]),
                 token_times=[t + delta for t in d["token_times"]])


def _queue_state(q) -> List[Dict[str, Any]]:
    from repro_torch.engine.scheduler import _Slot
    out = []
    for item in q:
        if isinstance(item, _Slot):
            out.append({"kind": "slot", **_slot_state(item)})
        else:
            out.append({"kind": "req", **_req_state(item)})
    return out


def _queue_from_state(items, delta: float) -> deque:
    q: deque = deque()
    for d in items:
        if d["kind"] == "slot":
            q.append(_slot_from_state(d, delta))
        else:
            q.append(_req_from_state(d, delta))
    return q


def _result_state(res) -> Dict[str, Any]:
    return {"tokens": np.asarray(res, np.int32).tolist(),
            "status": res.status.value,
            "error": res.error,
            "latency_s": res.latency_s,
            "token_times": res.token_times}


def _result_from_state(d: Dict[str, Any]):
    from repro_torch.engine.scheduler import RequestResult, RequestStatus
    return RequestResult(np.asarray(d["tokens"], np.int32),
                         RequestStatus(d["status"]),
                         error=d.get("error"),
                         latency_s=d.get("latency_s"),
                         token_times=d.get("token_times"))


def derived_knobs(sched) -> Dict[str, Any]:
    """The ``"sched"`` fields as the JAX snapshot spells them from what
    its Scheduler runs with: the port's Scheduler takes no option for
    the first three, and its ``enc_len`` option becomes the cross
    cache's padded positions a slot (None without a cross cache)."""
    return {"guard_nonfinite": True,
            "chunk_tokens": int(sched.chunk_tokens) or None,
            "token_budget": int(sched.token_budget) or None,
            "enc_len": int(sched.enc_budget) or None}


def _geometry(engine) -> Dict[str, Any]:
    ecfg = engine.ecfg
    return {"page_size": int(engine.page_size),
            "n_pages": int(engine.n_pages),
            "batch": int(ecfg.batch),
            "max_len": int(ecfg.max_len),
            "family": engine.cfg.family,
            "kv_dtype": getattr(ecfg, "kv_dtype", None)}


def scheduler_state(sched) -> Dict[str, Any]:
    """The scheduler's complete host-side state as one JSON-able dict
    (the device pools ride separately as npy shards)."""
    return {
        "version": SNAPSHOT_VERSION,
        "step": int(sched.stats["steps"]),
        "mono": time.monotonic(),
        "engine": _geometry(sched.eng),
        "sched": {"bucket_tables": bool(sched.bucket_tables),
                  "max_preemptions": int(sched.max_preemptions),
                  "prefix_cache": sched.prefix is not None,
                  "chunked_prefill": bool(sched.chunked),
                  **derived_knobs(sched)},
        "allocator": sched.allocator.to_state(),
        "table": sched.table.tolist(),
        "lens": sched.lens.tolist(),
        "tokens": sched.tokens.tolist(),
        "enc_lens": sched.enc_lens.tolist(),
        "slots": [None if s is None else _slot_state(s)
                  for s in sched.slots],
        "pending": _queue_state(sched.pending),
        "parked": _queue_state(sched.parked),
        "prefilling": [int(s) for s in sched._prefilling],
        "finished": [[rid, _result_state(res)]
                     for rid, res in sched.finished.items()],
        "prefix": (sched.prefix.to_state()
                   if sched.prefix is not None else None),
        "stats": {**sched.stats,
                  "table_widths": [[int(w), int(n)] for w, n in
                                   sched.stats["table_widths"].items()]},
        "latencies": list(sched._latencies),
        "itl": list(sched._itl),
        "order": int(sched._order),
    }


def snapshot_tree(sched) -> Dict[str, Any]:
    """The tree one snapshot save writes: the device cache plus the host
    state as a uint8 JSON leaf (so the whole snapshot commits — or
    doesn't — as ONE atomic store step)."""
    blob = json.dumps(scheduler_state(sched)).encode("utf-8")
    return {"cache": sched.cache,
            "host": np.frombuffer(blob, np.uint8)}


# ----------------------------------------------------------------------
# snapshot / restore
# ----------------------------------------------------------------------

def _as_store(directory_or_store, keep: int = 3) -> CheckpointStore:
    if isinstance(directory_or_store, CheckpointStore):
        return directory_or_store
    if isinstance(directory_or_store, EngineSnapshotter):
        return directory_or_store.store
    return CheckpointStore(str(directory_or_store), keep=keep)


def snapshot(sched, directory_or_store, step: Optional[int] = None,
             *, async_: bool = False, keep: int = 3) -> int:
    """Write one snapshot of ``sched`` (device pools + host state)
    into the store at ``step`` (default: the scheduler's current step
    count).  Returns the step id.  The pools are copied to host memory
    here, synchronously, whatever ``async_`` says, so the cut is
    consistent however the scheduler writes its pools on; ``async_``
    hands only the disk writes to the store's background worker."""
    refuse_distributed(sched.eng, "durable serving")
    store = _as_store(directory_or_store, keep=keep)
    if step is None:
        step = int(sched.stats["steps"])
    store.save(step, snapshot_tree(sched), async_=async_)
    return step


def _read_host_state(store: CheckpointStore, step: int) -> Dict[str, Any]:
    d = os.path.join(store.dir, f"step_{step}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    if "host" not in index:
        raise ValueError(
            f"{d} is not an engine snapshot (no 'host' leaf — a "
            "training checkpoint?)")
    shard = index["host"]["shards"][0]
    blob = np.load(os.path.join(d, shard["file"]))
    return json.loads(bytes(bytearray(np.asarray(blob, np.uint8))))


# the Scheduler options a snapshot restores (the rest are derived)
_KNOBS = ("bucket_tables", "max_preemptions", "prefix_cache",
          "chunked_prefill", "enc_len")


def restore(directory_or_store, engine, step: Optional[int] = None,
            *, journal=None, snapshotter=None, **sched_overrides):
    """Rebuild a ``Scheduler`` over ``engine`` from the snapshot at
    ``step`` (default: the latest complete one).  With no snapshot on
    disk a FRESH scheduler is returned — recovery before the first
    cadence is just "replay the whole journal into an empty engine".

    The engine must match the snapshot's geometry (page_size, n_pages,
    batch, max_len, family, kv_dtype); scheduler knobs (bucketing,
    preemption limit, prefix cache, chunking) are restored from the
    snapshot and can be overridden via ``sched_overrides``."""
    refuse_distributed(engine, "durable serving")
    from repro_torch.engine.scheduler import Scheduler

    store = _as_store(directory_or_store)
    if step is None:
        step = store.latest_step()
    kw = dict(sched_overrides)
    if step is None:
        return Scheduler(engine, journal=journal,
                         snapshotter=snapshotter, **kw)

    state = _read_host_state(store, step)
    if state.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {state.get('version')} != "
                         f"supported {SNAPSHOT_VERSION}")
    geo, mine = state["engine"], _geometry(engine)
    if geo != mine:
        raise ValueError(
            f"snapshot geometry {geo} does not match the engine "
            f"{mine} — restore needs the same engine config the "
            "snapshot was taken under")

    sk = state["sched"]
    for key in _KNOBS:
        kw.setdefault(key, sk[key])
    sched = Scheduler(engine, journal=journal, snapshotter=snapshotter,
                      **kw)
    for key, value in derived_knobs(sched).items():
        if sk.get(key) != value:
            raise ValueError(
                f"snapshot Scheduler {key}={sk.get(key)!r}, but the port's "
                f"Scheduler runs with {key}={value!r} under this engine "
                "config")

    # device pools: copied into the fresh Scheduler's own pools, in place
    store.restore(step, {"cache": sched.cache})

    # host bookkeeping
    delta = time.monotonic() - state["mono"]
    sched.allocator.load_state(state["allocator"])
    sched.table = np.asarray(state["table"], np.int32)
    sched.lens = np.asarray(state["lens"], np.int32)
    sched.tokens = np.asarray(state["tokens"], np.int32)
    sched.enc_lens = np.asarray(state["enc_lens"], np.int32)
    sched.slots = [None if s is None else _slot_from_state(s, delta)
                   for s in state["slots"]]
    sched.pending = _queue_from_state(state["pending"], delta)
    sched.parked = _queue_from_state(state["parked"], delta)
    sched._prefilling = deque(int(s) for s in state["prefilling"])
    sched.finished = {rid: _result_from_state(res)
                      for rid, res in state["finished"]}
    if state["prefix"] is not None:
        if sched.prefix is None:
            raise ValueError("snapshot carries a prefix-cache trie but "
                             "the restored scheduler has prefix_cache "
                             "disabled")
        sched.prefix.load_state(state["prefix"])
    stats = dict(state["stats"])
    stats["table_widths"] = {int(w): int(n)
                             for w, n in stats["table_widths"]}
    sched.stats.update(stats)
    sched._latencies = list(state["latencies"])
    sched._itl = list(state["itl"])
    sched._order = int(state["order"])
    sched.allocator.check()
    if sched.prefix is not None:
        sched.prefix.check()
    return sched


class EngineSnapshotter:
    """Snapshot cadence riding the scheduler's step path.

    Construct with ``every=N`` and hand to the ``Scheduler``
    (``snapshotter=``): after every N-th step the scheduler calls
    ``on_step``, which cuts the state synchronously (host copy) and
    writes it on the store's background worker — decode is never
    blocked on disk.  Exposes ``latest_step()`` so it plugs directly into
    ``runtime.resilience.run_with_restarts`` as the resume store.
    ``wait()``/``close()`` join the background writer and re-raise its
    failure; the scheduler also calls ``wait()`` when its drain loop
    ends."""

    def __init__(self, directory: str, *, every: int = 0, keep: int = 3):
        self.store = CheckpointStore(directory, keep=keep)
        self.every = int(every)
        self.saved = 0
        self._last: Optional[int] = None

    def latest_step(self) -> Optional[int]:
        return self.store.latest_step()

    def save(self, sched, *, async_: bool = True) -> int:
        step = snapshot(sched, self.store, async_=async_)
        self._last = step
        self.saved += 1
        return step

    def on_step(self, sched) -> None:
        step = int(sched.stats["steps"])
        if self.every and step != self._last and step % self.every == 0:
            self.save(sched, async_=True)

    def wait(self) -> None:
        self.store.wait()

    def close(self) -> None:
        self.store.wait()
