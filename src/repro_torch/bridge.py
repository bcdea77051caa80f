"""JAX parameter tree (as numpy) -> the port's parameter tree.

Both packages keep the same nested-dict layouts (stacked ``layers``
axis, ``wq (d,H,Dh)``, ``wo (H,Dh,d)``), so the bridge is a dtype and
device copy.  It takes anything numpy can read (``np.asarray`` of a
``jax.Array`` works) and never imports JAX.

A bf16 JAX array becomes an ``ml_dtypes.bfloat16`` numpy array, which
``torch.from_numpy`` refuses; it goes through float32 and back to
``torch.bfloat16``, which is exact (bf16 -> fp32 widens the mantissa).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_torch(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))     # a fresh copy
        return t.to(device=device, dtype=torch.bfloat16)
    # a writable copy: a jax.Array's numpy view is read-only
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested dict of arrays -> the same nested dict of tensors."""
    return {k: (from_jax(v, device) if isinstance(v, dict)
                else to_torch(v, device))
            for k, v in tree.items()}
