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

The measured per-shape choice ('auto' in the JAX package) is not
ported yet.

Training differentiates through 'torch' only (``training_backend``), as
the JAX package trains on 'xla': no hand-written kernel defines a
backward, and none is routed around silently.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

BACKENDS: Tuple[str, ...] = ("torch", "cuda")

# backends autograd can differentiate through (the JAX package's
# DIFFERENTIABLE_BACKENDS = ("xla",))
DIFFERENTIABLE_BACKENDS: Tuple[str, ...] = ("torch",)

# op -> backend -> implementation
_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def training_backend(cfg_or_backend: Any) -> str:
    """The backend training may use: a differentiable one is returned as
    is; a forward-only pin ('cuda') raises."""
    backend = backend_for(cfg_or_backend)
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
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")

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


def resolve(op: str, cfg_or_backend: Any) -> Callable:
    """The implementation ``dispatch`` would call (without calling it)."""
    table = _REGISTRY.get(op)
    if not table:
        raise KeyError(f"no implementations registered for op {op!r}; "
                       f"registered ops: {ops()}")
    backend = backend_for(cfg_or_backend)
    impl = table.get(backend)
    if impl is None:
        raise KeyError(f"op {op!r} has no {backend!r} backend; "
                       f"registered: {backends(op)}")
    return impl


def dispatch(op: str, cfg_or_backend: Any, *args, **kwargs):
    """Call the registered implementation of ``op`` for the backend
    selected by ``cfg_or_backend`` (a ModelConfig or backend string)."""
    return resolve(op, cfg_or_backend)(*args, **kwargs)
