"""Symmetric int8 quantization (counterpart of ``repro.kernels.quant``).

One recipe: ``scale = max(amax, eps) / 127``,
``q = clip(round(x / scale), -127, 127)``.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the int8 values and fp32 scales are
bit-equal to the JAX package's on the same fp32 inputs.  The int8 page
pools (``engine.paged_cache``) quantize per (page, KV head) with fp32
scale sidecars that the q8 decode kernel applies per key.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

# amax floor: the scale stays strictly positive for all-zero groups, so
# x / scale never divides by zero and dequant(quant(0)) == 0 exactly
QEPS = 1e-12

Axis = Union[None, int, Tuple[int, ...]]


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """fp32 scale for a symmetric int8 grid covering [-amax, amax]."""
    return torch.clamp_min(amax.float(), QEPS) / 127.0


def quantize_int8(x: torch.Tensor, axis: Axis = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``axis`` groups (None = per tensor).

    Returns ``(q int8, scale fp32)``; with an axis the reduced dims are
    kept as size 1, so the scale broadcasts back against ``q``."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = int8_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``q * scale`` in fp32 (optionally cast to ``dtype``)."""
    out = q.float() * scale
    return out if dtype is None else out.to(dtype)
