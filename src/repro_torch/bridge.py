"""JAX parameter tree (as numpy) -> the port's parameter tree.

Both packages keep the same nested-dict layouts (stacked ``layers``
axis, ``wq (d,H,Dh)``, ``wo (H,Dh,d)``), so the bridge is a dtype and
device copy.  It takes anything numpy can read (``np.asarray`` of a
``jax.Array`` works) and never imports JAX.

A bf16 JAX array becomes an ``ml_dtypes.bfloat16`` numpy array, which
``torch.from_numpy`` refuses; it goes through float32 and back to
``torch.bfloat16``, which is exact (bf16 -> fp32 widens the mantissa).

A JAX NamedTuple (a recurrent state, an optimizer state) becomes the
port's own class of the same name, field by field.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.ssm import Mamba2State
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.optim.adamw import OptState

# the port's NamedTuples, by the name the JAX package gives its own
NAMEDTUPLES = {c.__name__: c for c in (Mamba2State, MLSTMState, SLSTMState,
                                       OptState)}


def to_torch(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))     # a fresh copy
        return t.to(device=device, dtype=torch.bfloat16)
    # a writable copy: a jax.Array's numpy view is read-only
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(v, device):
    if v is None:
        return None
    if isinstance(v, dict):
        return from_jax(v, device)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        cls = NAMEDTUPLES.get(type(v).__name__)
        if cls is None or cls._fields != v._fields:
            raise TypeError(f"{type(v).__module__}.{type(v).__name__} "
                            "has no counterpart in the port")
        return cls(*(_convert(f, device) for f in v))
    return to_torch(v, device)


def from_jax(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested dict of arrays -> the same nested dict of tensors.  A
    NamedTuple (a JAX cache's recurrent state, an optimizer state)
    converts field by field into the port's class of the same name;
    None stays None."""
    return {k: _convert(v, device) for k, v in tree.items()}
