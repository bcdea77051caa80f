"""Kernel-dispatch registry: one seam between model code and kernels.

The counterpart of ``repro.kernels.dispatch``.  Model code never
compares implementation strings; every op with more than one
realization is registered here per backend, and callers say
``dispatch(op, cfg, *args)``.  The op names are the JAX package's
(``qkv_proj``, ``o_proj``, ``attention``, ``mlp``, ``swiglu``,
``decode_partial``).

Backends:
  'torch'  plain PyTorch formulations — the counterpart of 'xla'.
  'cuda'   the hand-written Hopper kernels (``repro_torch/csrc``) —
           the counterpart of 'pallas'.  Given CUDA tensors a kernel
           wrapper launches its kernel or raises; given CPU tensors it
           runs the kernel's plain version.
  'auto'   per-op, per-shape choice through the autotuner's cache
           (``kernels.autotune``): on a miss both backends are
           *measured* on the call's own tensors, their reps taking
           turns, and the winner is persisted by name under
           ``dispatch:<op>``: the first of ``AUTO_ORDER`` ('cuda')
           unless another is faster by more than ``AUTO_MARGIN``; with
           measurement off (``REPRO_AUTOTUNE=0``) 'cuda'.  A rank of a
           ``torch.distributed`` world of more than one rank only looks
           the winner up (``cached_backend``), so every rank runs the
           same backend and none writes the cache file.  A backend that
           raises while measured raises: 'auto' never picks 'torch'
           because a kernel failed.  Its choices are memoized in the
           process: a hit costs the call's key and one dict lookup.

The JAX package times 'auto' on zero-filled stand-ins because its
arguments may be traced; the port's are concrete, and zero block tables
or counts would time an empty paged kernel, so it times the call's own
tensors (no registered op writes into an argument).  Host ints that are
lengths or positions (``cur_len``, ``pos0``: traced 0-d int32 arrays in
the JAX package) are keyed as 0-d int32 operands, so a decode step's
key does not change with the step and reads as the JAX package's does.

Training differentiates through 'torch' only (``training_backend``), as
the JAX package trains on 'xla': no hand-written kernel defines a
backward, and none is routed around silently; 'auto' narrows to 'torch'.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import autotune

# the values kernel_impl takes
BACKENDS: Tuple[str, ...] = ("torch", "cuda", "auto")

# preferred backend order for 'auto' (first = the prior's pick); the
# backends an op can be registered under
AUTO_ORDER: Tuple[str, ...] = ("cuda", "torch")

# 'auto' keeps AUTO_ORDER[0] unless another backend's median time is
# lower by more than this share of it: the host-clock times of an op
# vary by tens of percent between runs
AUTO_MARGIN = 0.10

# backends autograd can differentiate through (the JAX package's
# DIFFERENTIABLE_BACKENDS = ("xla",))
DIFFERENTIABLE_BACKENDS: Tuple[str, ...] = ("torch",)

# op -> backend -> implementation
_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# host-int arguments that are lengths or positions, by position: keyed
# as the 0-d int32 arrays the JAX package traces them as (any other int
# stays a static value of the key)
LENGTH_ARGS: Dict[str, Tuple[int, ...]] = {
    "decode_partial": (3, 4),             # cur_len, pos0
    "decode_partial_q8": (5, 6),
    "decode_partial_mla": (4, 5),
    "decode_partial_mla_q8": (6, 7),
}
LENGTH_KWARGS: Tuple[str, ...] = ("cur_len", "pos0")


def training_backend(cfg_or_backend: Any) -> str:
    """The backend training may use: 'auto' narrows to the
    differentiable set; a forward-only pin ('cuda') raises."""
    backend = backend_for(cfg_or_backend)
    if backend == "auto":
        return DIFFERENTIABLE_BACKENDS[0]
    if backend not in DIFFERENTIABLE_BACKENDS:
        raise ValueError(
            f"kernel_impl={backend!r} is forward-only (prefill/decode/"
            "eval): the hand-written CUDA kernels define no backward.  "
            f"Train with kernel_impl in {DIFFERENTIABLE_BACKENDS} "
            "(kernel_impl='torch').")
    return backend


def register(op: str, backend: str) -> Callable[[Callable], Callable]:
    """Decorator: ``@register("mlp", "cuda")`` adds an implementation.
    Re-registration overwrites."""
    if backend not in AUTO_ORDER:
        raise ValueError(f"unknown backend {backend!r}; have {AUTO_ORDER}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op, {})[backend] = fn
        return fn

    return deco


def ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def backends(op: str) -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY.get(op, ())))


def backend_for(cfg_or_backend: Any) -> str:
    """A ModelConfig (uses ``cfg.kernel_impl``) or a backend string."""
    if isinstance(cfg_or_backend, str):
        return cfg_or_backend
    return cfg_or_backend.kernel_impl


def resolve(op: str, cfg_or_backend: Any, args=(), kwargs=None) -> Callable:
    """The implementation ``dispatch`` would call (without calling it);
    'auto' resolves for the call ``args`` / ``kwargs``."""
    table = _REGISTRY.get(op)
    if not table:
        raise KeyError(f"no implementations registered for op {op!r}; "
                       f"registered ops: {ops()}")
    backend = backend_for(cfg_or_backend)
    if backend == "auto":
        backend = _resolve_auto(op, table, args, kwargs or {})
    impl = table.get(backend)
    if impl is None:
        raise KeyError(f"op {op!r} has no {backend!r} backend; "
                       f"registered: {backends(op)}")
    return impl


def dispatch(op: str, cfg_or_backend: Any, *args, **kwargs):
    """Call the registered implementation of ``op`` for the backend
    selected by ``cfg_or_backend`` (a ModelConfig or backend string)."""
    return resolve(op, cfg_or_backend, args, kwargs)(*args, **kwargs)


def _candidates(table) -> list:
    cands = [b for b in AUTO_ORDER if b in table]
    return cands + [b for b in sorted(table) if b not in cands]


def cached_backend(op: str, cfg_or_backend: Any, args=(),
                   kwargs=None) -> str:
    """Resolve 'auto' by cache LOOKUP alone: replay a measured
    ``dispatch:<op>`` winner if one exists for these arguments, else the
    first of the preference order.  Never measures and never writes."""
    backend = backend_for(cfg_or_backend)
    if backend != "auto":
        return backend
    cands = _candidates(_REGISTRY.get(op, {}))
    if not cands:
        return "torch"
    shape, dtype, device = _signature(op, args, kwargs or {})
    hit = shape and autotune.lookup(f"dispatch:{op}", shape, dtype,
                                    autotune.backend_tag(device))
    return hit[0] if hit and hit[0] in cands else cands[0]


def _in_world() -> bool:
    """Whether this process is one rank of a ``torch.distributed`` world
    of more than one rank."""
    return dist.is_initialized() and dist.get_world_size() > 1


# ======================================================================
# 'auto': measured cuda-vs-torch choice through the autotuner cache
# ======================================================================

class _Length:
    """A host int keyed as a 0-d int32 operand."""


_LENGTH = _Length()


def _leaves(tree, out):
    """``jax.tree.leaves`` order with None kept as a leaf: dicts by
    sorted key, tuples and lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    else:
        out.append(tree)
    return out


def _signature(op, args, kwargs):
    """(shape, dtype, device): the JAX package's ``_arg_signature`` of the
    call (flattened shapes of every array argument, each followed by -1;
    the deduplicated dtypes, JAX's spelling, with the static args folded
    in after ';'), and the device of its first tensor."""
    lengths = LENGTH_ARGS.get(op, ())
    if lengths or any(k in kwargs for k in LENGTH_KWARGS):
        args = tuple(_LENGTH if i in lengths and _is_int(a) else a
                     for i, a in enumerate(args))
        kwargs = {k: (_LENGTH if k in LENGTH_KWARGS and _is_int(v) else v)
                  for k, v in kwargs.items()}
    shape: list = []
    static: list = []
    dtypes: dict = {}                       # ordered de-dup
    device = None
    for leaf in _leaves((args, kwargs), []):
        if isinstance(leaf, torch.Tensor):
            shape += leaf.shape
            shape.append(-1)                    # arg separator
            dtypes[autotune.dtype_name(leaf.dtype)] = None
            if device is None:
                device = leaf.device
        elif leaf is _LENGTH:
            shape.append(-1)
            dtypes["int32"] = None
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            shape.extend(int(s) for s in leaf.shape)
            shape.append(-1)
            dtypes[str(leaf.dtype)] = None
        elif isinstance(leaf, (str, bool, int, float)) or leaf is None:
            static.append(str(leaf))
    dtype = ",".join(dtypes) or "float32"
    if static:
        dtype = dtype + ";" + ",".join(static)
    return tuple(shape), dtype, device or _CPU


_CPU = torch.device("cpu")


def _is_int(a) -> bool:
    return isinstance(a, int) and not isinstance(a, bool)


def _arg_signature(args, kwargs, op=None):
    """(shape, dtype) of a call, the cache key's parts (``_signature``)."""
    return _signature(op, args, kwargs)[:2]


def _resolve_auto(op: str, table: Dict[str, Callable], args, kwargs) -> str:
    cands = _candidates(table)
    if len(cands) == 1:
        return cands[0]
    if _in_world():
        # ranks that measured apart could pick different backends, and
        # their writes would race on one cache file: look up only (a
        # tuning pass runs on one process before the world starts)
        return cached_backend(op, "auto", args, kwargs)
    shape, dtype, device = _signature(op, args, kwargs)
    if not shape or not autotune.enabled():
        return cands[0]                 # nothing to key on, or no tuning
    name, tag = f"dispatch:{op}", autotune.backend_tag(device)
    hit = autotune.lookup(name, shape, dtype, tag)
    if hit is None:
        def runner(cand):
            impl = table[cand[0]]
            return lambda: impl(*args, **kwargs)

        hit = autotune.get_blocks(
            name, shape, dtype, tag,
            # candidates are the backend NAMES: the persisted entry
            # replays by name, so later registrations can't shift it
            candidates=tuple((b,) for b in cands),
            # prior: registration-preference order (cuda first); the
            # measured pass overrides it per shape past AUTO_MARGIN
            prior=lambda c: (float(cands.index(c[0])), 0.0),
            runner=runner, sync=autotune.device_sync(device),
            margin=AUTO_MARGIN)
    return hit[0] if hit[0] in table else cands[0]   # stale name
