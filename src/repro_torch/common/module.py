"""Parameter definitions: the PyTorch counterpart of ``repro.common.module``.

A module's ``spec(cfg) -> dict[name -> ParamDef | nested dict]`` names
every parameter with its shape, dtype, logical axes and initializer;
``init_params`` materializes the tree on one device from one
``torch.Generator``.  The layouts are the JAX package's, so a JAX
parameter tree maps onto the same nested dict (``repro_torch.bridge``).
The initializers draw the same distributions as the JAX ones (fan-in
normal, embed 0.02 normal, zeros, ones) but not the same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


class ParamDef:
    __slots__ = ("shape", "dtype", "axes", "init")

    def __init__(self, shape, dtype: torch.dtype, axes,
                 init: Optional[Callable] = None):
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.axes = tuple(axes)
        self.init = init if init is not None else fan_in_init

    def __repr__(self):
        return f"ParamDef({self.shape}, {self.dtype}, {self.axes})"


# ---------------- initializers: (generator, shape, dtype, device) ----------------

def fan_in_init(gen, shape, dtype, device):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def embed_init(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


def zeros_init(gen, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


# ---------------- tree utilities ----------------

def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted key order — the order in which
    ``jax.tree`` flattens a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def map_tree(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (map_tree(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises
    (the port never carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs an NVIDIA GPU, and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain versions on the CPU")
    return dev


def init_params(spec: Dict[str, Any], seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Materialize a spec tree on ``device`` from a ``torch.Generator``
    seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: Dict[str, Any] = {}
    for path, d in leaves(spec):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = d.init(gen, d.shape, d.dtype, dev)
    return out


def stack_specs(spec: Dict[str, Any], n: int):
    """Stack a per-layer spec n times along a leading "layers" axis."""
    return map_tree(lambda d: ParamDef((n, *d.shape), d.dtype,
                                       ("layers", *d.axes), d.init), spec)


def count_params(spec: Dict[str, Any]) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(spec))
