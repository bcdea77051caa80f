"""Plan autotuner for the Hopper kernels, and the cache 'auto' dispatch
shares with it.

Counterpart of ``repro.kernels.autotune``.  The JAX package tunes its
Pallas kernels' static block sizes; the knob the Hopper kernels have is
the plan of a variant: ``vwr_matmul``'s wgmma ``(bm, nsplit, kt_split)``
(``tile_plan``; its split-K variant keeps ``splitk_plan``'s),
``vwr_swiglu``'s wgmma ``(bm, bn, nsplit, kt_split)``
(``swiglu_tile_plan``) and ``vwr_conv2d``'s wgmma ``(bm, bn, nsplit,
kt_split)`` (``vwr_conv2d.plan``).  A launch given no plan asks
``matmul_plan`` / ``swiglu_plan`` / ``conv_plan`` here, and they only
look up: a plan persisted for the call's key, else the rule's, memoized
in the process (a hit costs its key and one dict lookup).  Serving
never measures.  Plans are measured in a tuning pass, a warm-up run
inside ``with tuning():``, where a hook that finds no plan:

  1. *candidates*: takes the plans of the variant the rule already
     picked (the tuner never changes the variant) that keep the rule's
     K split and so its sums (``retiled``: a tuned launch is bitwise the
     rule's), the rule's plan first, at most 4 of them;
  2. *measure*: launches every one on the call's own tensors, timed on
     the device (CUDA events around each launch, after a write that
     evicts the L2, as the main path finds its weights cold;
     ``device_clock``), the candidates' reps interleaved;
  3. *persist*: writes the fastest to a JSON cache keyed by (op, shape,
     dtype, backend), which every later lookup reads; a process restart
     re-reads the file instead of re-measuring.

The winner can be no slower than the rule on the run that measured it,
and with ``REPRO_AUTOTUNE=0`` every launch takes the rule's plan, as
before the tuner.  A plan passed to a launch explicitly is used as is.
``matmul_candidates`` / ``swiglu_candidates`` / ``conv_candidates`` list
every legal plan of a variant, other K splits included, for
chip_smoke.py's plan tables.  The tuner's own launches are not counted
in ``build.LAUNCHES`` / ``VARIANTS``: those count the work a path did.

Measurement hygiene: the first call of every candidate is discarded, the
candidates' timed reps take turns, and the reported number is each one's
median.  'auto' dispatch (``kernels.dispatch``) measures on a miss
wherever it is (the JAX package's semantics: 'auto' is asked for by
name); it times a whole op on the host clock with the device
synchronized around each call, its host work included; plans differ by
microseconds of device time, which the host clock's launch overhead
would bury.

Environment knobs (the JAX package's), read once a process (``reset``
reads them again):
  REPRO_AUTOTUNE=0        disable: the rule's plan, no cache I/O
  REPRO_AUTOTUNE_CACHE    cache file (default
                          ~/.cache/repro_torch/autotune.json, apart from
                          the JAX package's, whose entries never replay
                          here)
  REPRO_AUTOTUNE_TOPK     candidates measured per miss (default 4: every
                          retiled plan)
  REPRO_AUTOTUNE_REPS     timed reps per candidate, median-reported
                          (default 5; the discarded rep is extra)
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

# in-memory mirror of the JSON file: {path: {key: entry}}
_MEM: Dict[str, Dict[str, dict]] = {}
# answers already looked up in this process: {(op, shape, dtype,
# backend): blocks, or None where the cache has none}, so a lookup costs
# one dict lookup
_HOT: Dict[tuple, Optional[tuple]] = {}
# backend tags by device
_TAGS: Dict[object, str] = {}
# L2-evicting buffers of ``device_clock`` by CUDA device index
_FLUSH: Dict[int, torch.Tensor] = {}
L2_FLUSH_BYTES = 64 << 20        # past the H100's 50 MB L2
# a device sleep queued ahead of each timed launch (~0.1 ms at the
# H100's 1.98 GHz), so the events time queued device work, not the
# host's launch latency
SLEEP_CYCLES = 200_000
# (enabled, cache path, topk, reps): the environment knobs as read
_KNOBS: Optional[tuple] = None
# the plan hooks' answers in this process: {(kernel, shape..., torch
# dtype, device index): (plan, final)}, final unless it is a rule's that
# a tuning pass may still measure; a hit costs the key and one lookup
_PLANS: Dict[tuple, tuple] = {}
# open ``tuning()`` blocks
_TUNING = 0
_UNSEEN = object()

stats = {"hits": 0, "misses": 0, "measured": 0}
# every candidate measured in this process, in order: {"key", "cand",
# "us"} (the JSON keeps the winner's time only)
measurements: list = []


def _knobs() -> tuple:
    global _KNOBS
    if _KNOBS is None:
        path = os.environ.get("REPRO_AUTOTUNE_CACHE")
        if path is None:
            path = os.path.join(os.path.expanduser("~"), ".cache",
                                "repro_torch", "autotune.json")
        _KNOBS = (os.environ.get("REPRO_AUTOTUNE", "1") != "0", path,
                  max(1, int(os.environ.get("REPRO_AUTOTUNE_TOPK", "4"))),
                  max(1, int(os.environ.get("REPRO_AUTOTUNE_REPS", "5"))))
    return _KNOBS


def enabled() -> bool:
    return _knobs()[0]


def cache_path() -> str:
    return _knobs()[1]


def cache_key(op: str, shape: Sequence[int], dtype: str,
              backend: str) -> str:
    return f"{op}|{'x'.join(str(int(s)) for s in shape)}|{dtype}|{backend}"


def backend_tag(device) -> str:
    """Cache key component: ``cuda:<device name, _ for spaces>`` on a
    card (winners are per hardware), ``cpu`` on the CPU."""
    tag = _TAGS.get(device)
    if tag is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            tag = "cpu"
        else:
            idx = (dev.index if dev.index is not None
                   else torch.cuda.current_device())
            tag = "cuda:" + torch.cuda.get_device_name(idx).replace(" ",
                                                                   "_")
        if dev.type != "cuda" or dev.index is not None:
            _TAGS[device] = tag      # an unindexed "cuda" follows the
    return tag                       # current device


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def dtype_name(dtype) -> str:
    """A dtype as the JAX package spells it: 'bfloat16', 'int32'."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


def reset() -> None:
    """Drop the in-memory cache mirror and memo, zero the stats and read
    the environment knobs again."""
    global _KNOBS
    _KNOBS = None
    _MEM.clear()
    _HOT.clear()
    _PLANS.clear()
    measurements.clear()
    for k in stats:
        stats[k] = 0


@contextlib.contextmanager
def tuning():
    """A tuning pass: inside, a plan hook that finds no persisted plan
    measures its candidates and persists the winner; outside, the hooks
    only look up (a persisted plan, else the rule's)."""
    global _TUNING
    _TUNING += 1
    try:
        yield
    finally:
        _TUNING -= 1


def _load(path: str) -> Dict[str, dict]:
    if path not in _MEM:
        try:
            with open(path) as f:
                _MEM[path] = json.load(f)
        except (OSError, ValueError):
            _MEM[path] = {}
    return _MEM[path]


def _persist(path: str, table: Dict[str, dict]) -> None:
    _MEM[path] = table
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # merge-with-disk then atomic replace: concurrent processes
        # tuning different shapes don't clobber each other's wins
        on_disk: Dict[str, dict] = {}
        try:
            with open(path) as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            pass
        on_disk.update(table)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(on_disk, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _MEM[path] = on_disk
    except OSError:
        pass                     # read-only FS: in-memory cache still works


def lookup(op: str, shape: Sequence[int], dtype: str,
           backend: str) -> Optional[tuple]:
    """The persisted answer for a key, or None (the tuner off, or no
    entry); never measures or writes.  Memoized, hits and misses alike,
    until ``reset`` or a measurement of the key."""
    if not enabled():
        return None
    memo = (op, tuple(shape), dtype, backend)
    best = _HOT.get(memo, _UNSEEN)
    if best is _UNSEEN:
        hit = _load(cache_path()).get(cache_key(op, shape, dtype, backend))
        best = _HOT[memo] = None if hit is None else tuple(hit["blocks"])
    if best is not None:
        stats["hits"] += 1
    return best


def device_sync(device) -> Optional[Callable[[], None]]:
    """What ``_measure`` waits on for work queued on ``device``: the
    card's ``synchronize``, nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return lambda: torch.cuda.synchronize(device)


def device_clock(device) -> Optional[Callable[[Callable], float]]:
    """``_measure``'s clock for kernel launches on ``device``: the device
    seconds of one call between two CUDA events, recorded behind a short
    device sleep and a write that evicts the L2; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())

    def clock(run):
        flush = _FLUSH.get(idx)
        if flush is None:
            flush = _FLUSH[idx] = torch.empty(L2_FLUSH_BYTES,
                                              dtype=torch.uint8,
                                              device=device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        a.record()
        run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3

    return clock


# ======================================================================
# candidate plans
# ======================================================================

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_candidates(kind: str, M: int, N: int, K: int
                      ) -> Tuple[tuple, ...]:
    """The plans of ``vwr_matmul``'s variant ``kind`` at x (M, K) @ w
    (K, N): the rule's, then others of the same form.  wgmma: 64- or
    128-row tiles with K in 1, 2, 4 or 8 slices of at least 4 steps;
    split-K: K in slices sized for ~1, 2 or 4 blocks an SM."""
    from repro_torch.kernels import vwr_matmul as KM

    if kind == "wgmma":
        own, kt = KM.tile_plan(M, N, K), _cdiv(K, KM.TILE_BK)
        alts = [(bm, _cdiv(kt, _cdiv(kt, ns)), _cdiv(kt, ns))
                for bm in (64, 128) for ns in (1, 2, 4, 8) if kt // ns >= 4]
    else:
        own = KM.splitk_plan(M, N, K)
        mt, strips = own[0], _cdiv(M, own[0]) * _cdiv(N, KM.SPLITK_BN)
        alts = []
        for per_sm in (1, 2, 4):
            ks = _cdiv(_cdiv(K, max(1, _cdiv(per_sm * KM.SMS, strips))),
                       16) * 16
            ks = min(max(ks, 64), KM.SPLITK_X_FLOATS // mt)
            alts.append((mt, _cdiv(K, ks), ks))
    return tuple([own] + [p for p in dict.fromkeys(alts) if p != own])


def swiglu_candidates(M: int, N: int, K: int) -> Tuple[tuple, ...]:
    """The plans of ``vwr_swiglu``'s wgmma variant at x (M, K), wg / wi
    (K, N): the rule's, then 64- or 128-row tiles on 64- or 128-column
    strips, K in 1, 2 or 4 slices of at least 4 steps up to 128 rows
    (whole above, as ``swiglu_tile_plan``)."""
    from repro_torch.kernels import vwr_matmul as KM

    own, kt = KM.swiglu_tile_plan(M, N, K), _cdiv(K, KM.TILE_BK)
    alts = [(bm, bn, _cdiv(kt, _cdiv(kt, ns)), _cdiv(kt, ns))
            for bn in KM.SWIGLU_TILE_BNS for bm in (64, 128)
            for ns in ((1, 2, 4) if M <= 128 else (1,)) if kt // ns >= 4]
    return tuple([own] + [p for p in dict.fromkeys(alts) if p != own])


def conv_candidates(N: int, H: int, W: int, C: int, KH: int, KW: int,
                    F: int) -> Tuple[tuple, ...]:
    """The plans of ``vwr_conv2d``'s wgmma variant: the rule's, then 64-
    or 128-row and -filter tiles with the K steps in 1, 2, 4, 9 or 18
    balanced slices (at least 2 steps a slice)."""
    from repro_torch.kernels import vwr_conv2d as K16

    own = K16.plan(N, H, W, C, KH, KW, F)
    kt = KH * KW * _cdiv(C, K16.SLICE)
    alts = [(bm, bn, _cdiv(kt, _cdiv(kt, ns)), _cdiv(kt, ns))
            for bm in (64, 128) for bn in (64, 128)
            for ns in (1, 2, 4, 9, 18) if kt // ns >= 2]
    return tuple([own] + [p for p in dict.fromkeys(alts) if p != own])


# ======================================================================
# the launches' hooks: the plan of a launch given none
# ======================================================================

# The tuner weighs only the plans that keep the rule's K split: the
# rule's tile shape and its others (``retiled``).  A plan that splits K
# otherwise sums every output in another order, so a row's result would
# depend on the shape of the call it came in; the rules keep a row's
# sums across the shapes that share a split (``tile_plan`` splits K by N
# and K alone up to 128 rows: a decode step's row at M 8 and the same
# row in a mixed step at M 72), and replays and cache hits would part
# from the served streams at near-ties.  A retiled plan sums every
# output alike, so a tuned launch is bitwise the rule's.  The split-K
# variant's plan is its K split: it keeps the rule's.

# the tiles the tuner weighs: vwr_matmul's wgmma rows; vwr_swiglu's rows
# by output columns a strip (``vwr_matmul.SWIGLU_TILE_BNS``) and
# vwr_conv2d's pixels by filters
ROW_TILES = ((64,), (128,))
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))


def retiled(rule: tuple, tiles) -> Tuple[tuple, ...]:
    """``rule``, then ``rule`` with its leading tile entries replaced by
    each other one of ``tiles`` (tuples of the same length)."""
    n = len(tiles[0])
    return (rule,) + tuple(t + rule[n:] for t in tiles if t != rule[:n])


def _bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The call's roofline time on the card: its operations over the
    peak of their type, or its bytes (each operand once) over HBM."""
    return max(flops / PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"]),
               nbytes / HBM_BW)


def _plan(key, op, shape, x, rule, tiles, runner, flops, nbytes) -> tuple:
    """A plan hook's answer past its memo, remembered under ``key``:
    ``rule`` with the tuner off, a persisted plan, else the rule's
    outside a tuning pass and ``get_blocks``'s inside one (every plan of
    ``retiled(rule, tiles)``, timed on the device; the entry's prior is
    the call's roofline time)."""
    best, final = rule, True
    if _knobs()[0]:
        dtype, tag = dtype_name(x.dtype), backend_tag(x.device)
        best = lookup(op, shape, dtype, tag)
        if best is None and _TUNING:
            t = _bound_s(flops, nbytes, dtype)
            best = get_blocks(op, shape, dtype, tag,
                              candidates=lambda: retiled(rule, tiles),
                              prior=lambda p: (t, None), runner=runner,
                              first=rule, clock=device_clock(x.device))
        elif best is None:
            best, final = rule, False    # a tuning pass may measure it
    _PLANS[key] = (best, final)
    return best


def matmul_plan(kind, x, w, bias, residual, activation) -> tuple:
    """The plan of a ``vwr_matmul`` launch of variant ``kind`` ("splitk"
    or "wgmma") on CUDA operands: wgmma's row tile (64 or 128) on the
    rule's K split; split-K's rule."""
    M, K = x.shape
    N = w.shape[1]
    key = (kind, M, K, N, x.dtype, x.get_device())
    hot = _PLANS.get(key)
    if hot is not None and (hot[1] or not _TUNING):
        return hot[0]
    from repro_torch.kernels import vwr_matmul as KM

    if kind == "splitk":
        plan = _PLANS[key] = (KM.splitk_plan(M, N, K), True)
        return plan[0]
    n_mn = 1 + (bias is not None) + (residual is not None)
    return _plan(
        key, "matmul.wgmma", (M, K, N), x, KM.tile_plan(M, N, K),
        ROW_TILES,
        lambda p: lambda: KM.launch(x, w, bias, residual, activation,
                                    "wgmma", p),
        2.0 * M * N * K, x.element_size() * (M * K + K * N + n_mn * M * N))


def swiglu_plan(x, wg, wi) -> tuple:
    """The plan of a ``vwr_swiglu`` launch of its wgmma variant: its tile
    (64 or 128 rows, 64- or 128-column strips) on the rule's K split."""
    M, K = x.shape
    N = wg.shape[1]
    key = ("swiglu", M, K, N, x.dtype, x.get_device())
    hot = _PLANS.get(key)
    if hot is not None and (hot[1] or not _TUNING):
        return hot[0]
    from repro_torch.kernels import vwr_matmul as KM

    return _plan(
        key, "swiglu.wgmma", (M, K, N), x, KM.swiglu_tile_plan(M, N, K),
        TILES, lambda p: lambda: KM.swiglu_launch(x, wg, wi, "wgmma", p),
        4.0 * M * N * K, x.element_size() * (M * K + 2 * K * N + M * N))


def conv_plan(x, w, bias, activation) -> tuple:
    """The plan of a ``vwr_conv2d`` launch of its wgmma variant: its tile
    (64 or 128 pixels by 64 or 128 filters) on the rule's K split."""
    N, H, W, C = x.shape
    KH, KW, _, F = w.shape
    key = ("conv", N, H, W, C, KH, KW, F, x.dtype, x.get_device())
    hot = _PLANS.get(key)
    if hot is not None and (hot[1] or not _TUNING):
        return hot[0]
    from repro_torch.kernels import vwr_conv2d as K16

    P = N * (H - KH + 1) * (W - KW + 1)
    return _plan(
        key, "conv.wgmma", (N, H, W, C, KH, KW, F), x,
        K16.plan(N, H, W, C, KH, KW, F), TILES,
        lambda p: lambda: K16.launch(x, w, bias, activation, "wgmma", p),
        2.0 * P * F * KH * KW * C,
        x.element_size() * (x.numel() + w.numel() + P * F))


# ======================================================================
# tune-or-lookup driver
# ======================================================================

def _measure_all(runs: Sequence[Callable[[], None]],
                 reps: Optional[int] = None,
                 sync: Optional[Callable[[], None]] = None,
                 clock: Optional[Callable[[Callable], float]] = None
                 ) -> list:
    """Median microseconds of each of ``runs`` over ``reps`` calls after
    one discarded call each, the calls of the runs taking turns.  On the
    host clock, ``sync`` (the device's synchronize) is waited on before
    each timed call starts and before it is read; ``clock(run)``
    (``device_clock``) times a call in its place."""
    reps = reps if reps is not None else _knobs()[3]
    for run in runs:
        run()           # first call discarded: times loading, not the kernel
    ts = [[] for _ in runs]
    for _ in range(reps):
        for run, t in zip(runs, ts):
            if clock is not None:
                t.append(clock(run))
                continue
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            run()
            if sync is not None:
                sync()
            t.append(time.perf_counter() - t0)
    return [sorted(t)[len(t) // 2] * 1e6 for t in ts]   # medians, us


def _measure(run: Callable[[], None], reps: Optional[int] = None,
             sync: Optional[Callable[[], None]] = None,
             clock: Optional[Callable[[Callable], float]] = None) -> float:
    """Median microseconds of ``reps`` calls of ``run`` after one
    discarded call (``_measure_all`` of one run)."""
    return _measure_all([run], reps, sync, clock)[0]


def get_blocks(op: str, shape: Sequence[int], dtype: str, backend: str,
               candidates, prior: Callable[[tuple], tuple],
               runner: Optional[Callable[[tuple], Callable]],
               first: Optional[tuple] = None,
               sync: Optional[Callable[[], None]] = None,
               clock: Optional[Callable[[Callable], float]] = None,
               margin: float = 0.0) -> tuple:
    """Cache lookup -> (on miss) measurement -> persist.

    ``candidates`` is a sequence of legal candidates or a zero-arg
    callable giving one (built only on a miss); ``prior(cand)`` gives
    (time estimate, energy per bit or None): the time ranks them (ties
    keep their order) and both are written beside the winner.
    ``first`` (the rule's candidate) ranks ahead of the prior's order
    and is always measured; with measurement off (``REPRO_AUTOTUNE=0``
    or ``runner`` None) it is the answer, else the prior's best.  The
    top ``REPRO_AUTOTUNE_TOPK`` are measured (``_measure_all``); the
    first ranked wins unless another is faster by more than ``margin``
    of its time.  ``runner(cand)`` returns a zero-arg callable executing
    the kernel at that candidate, its launches not counted in
    ``build.LAUNCHES``; whatever it raises propagates; ``sync`` /
    ``clock`` go to ``_measure_all``."""
    def rank(cand):
        return prior(cand)[0]

    def legal():
        cands = list(candidates() if callable(candidates) else candidates)
        if not cands and first is None:
            raise ValueError(f"no legal block candidates for {op} {shape}")
        return cands

    if not enabled() or runner is None:
        return first if first is not None else min(legal(), key=rank)
    best = lookup(op, shape, dtype, backend)
    if best is not None:
        return best

    stats["misses"] += 1
    ranked = sorted(legal(), key=rank)
    if first is not None:
        ranked = [first] + [c for c in ranked if c != first]
    ranked = ranked[:_knobs()[2]]
    runs = [runner(c) for c in ranked]
    with build.uncounted():
        us = _measure_all(runs, sync=sync, clock=clock)
    key = cache_key(op, shape, dtype, backend)
    stats["measured"] += len(ranked)
    measurements.extend({"key": key, "cand": c, "us": u}
                        for c, u in zip(ranked, us))
    i = min(range(len(us)), key=us.__getitem__)
    if us[i] >= (1.0 - margin) * us[0]:
        i = 0
    t_prior, e_bit = prior(ranked[i])
    path = cache_path()
    table = _load(path)
    table[key] = {
        "blocks": list(ranked[i]), "us": us[i],
        "prior_t_s": t_prior, "prior_e_fj_per_bit": e_bit,
        "measured": len(ranked),
    }
    _persist(path, table)
    best = _HOT[(op, tuple(shape), dtype, backend)] = tuple(ranked[i])
    return best
