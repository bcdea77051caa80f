"""Compressed collectives: int8 all-reduce with error feedback
(counterpart of ``repro.dist.compression``).

Gradient sync is the collective that keeps the interconnect busy during
data-parallel training.  Quantizing the payload to int8 cuts the wire
bytes 4x (fp32) at the cost of a per-step rounding bias; carrying that
bias forward as error feedback (the residual added to the next call's
input before quantization) makes the long-run average unbiased: the
two-step mean is closer to the true mean than either single step.

The wire format is the JAX package's: each rank's int8 payload and its
fp32 scale are all-gathered (n * (size + 4) bytes instead of the fp32
ring all-reduce's ~2 * 4 * size), and the dequantized sum is taken
locally, so every rank gets the same bits.  A primitive, as in JAX: the
trainer does not call it.
"""
from __future__ import annotations

from typing import Tuple

import torch

# one int8 idiom in the port: the wire payload here and the quantized
# KV page pools (engine.paged_cache) share kernels.quant
from repro_torch.kernels.quant import quantize_int8


def compressed_psum(x: torch.Tensor, err: torch.Tensor, mesh,
                    axis: str = "data"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``x`` over ``mesh``'s ``axis`` with int8 payloads.

    Every rank of the axis calls it with its own ``x`` and ``err``, its
    error-feedback residual from the previous call (zeros on the first).
    Returns (mean estimate in ``x``'s dtype, new residual in ``err``'s):
    the estimate equals the exact mean up to int8 rounding, and feeding
    the residual back shrinks the accumulated bias step over step."""
    n = mesh.axis_size(axis)
    corrected = x.to(torch.float32) + err.to(torch.float32)
    q, scale = quantize_int8(corrected)
    new_err = corrected - q.to(torch.float32) * scale
    # int8 + the rank's scale on the wire; dequantize and sum locally
    qs = mesh.all_gather(q[None], axis)                 # (n, *shape)
    ss = mesh.all_gather(scale.reshape(1), axis)        # (n,)
    ss = ss.reshape((n,) + (1,) * x.dim())
    out = torch.sum(qs.to(torch.float32) * ss, dim=0) / n
    return out.to(x.dtype), new_err.to(err.dtype)

