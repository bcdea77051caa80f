"""Pipeline parallelism: the GPipe microbatch schedule over a 'pipe'
mesh axis (counterpart of ``repro.dist.pipeline``).

Stage weights stay resident on their rank for the whole pass; only the
(mb, ...) activation edge crosses between ranks, one send and one
receive a tick between stages s and s + 1 (JAX's ``ppermute`` ring
hand-off).  Microbatch t enters stage 0 at tick t and leaves stage S - 1
at tick t + S - 1; the run drains after n_micro + S - 1 ticks, S - 1 of
them bubble ticks.  The last stage's outputs reach every rank at the end
(JAX's closing ``psum``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def pipeline_apply(mesh, stage_fn: Callable, stage_params: Any,
                   x: torch.Tensor, *, n_micro: int,
                   axis_name: str = "pipe") -> torch.Tensor:
    """Apply ``stage_fn`` S times in sequence, one stage a rank.

    stage_fn: (params_s, (mb, ...)) -> (mb, ...), one pipeline stage of
    the same shape in and out; stage_params: this rank's stage (JAX's
    stacked (S, ...) leaves cut by ``local_block`` over the axis, the
    leading dim of 1 kept or not, as ``stage_fn`` takes them); x: the
    (n_micro * mb, ...) global input, the same on every rank.

    Returns stage_fn(w[S-1], ... stage_fn(w[0], x)) on every rank: the
    sequential composition, computed with the GPipe schedule."""
    S = mesh.axis_size(axis_name)
    s = mesh.coord(axis_name)
    n_tokens = x.shape[0]
    if n_tokens % n_micro:
        raise ValueError(f"{n_tokens} rows do not split into {n_micro} "
                         "microbatches")
    mb = n_tokens // n_micro
    xm = x.reshape(n_micro, mb, *x.shape[1:])
    recv = None
    outs = []
    for t in range(n_micro + S - 1):
        # stage s works on microbatch t - s at tick t
        live = 0 <= t - s < n_micro
        y = None
        if live:
            y = stage_fn(stage_params, xm[t] if s == 0 else recv)
            if s == S - 1:
                outs.append(y)
        if S == 1:
            continue
        # the ring hand-off: stage s passes microbatch t - s on to s + 1
        # while it receives microbatch t + 1 - s from s - 1
        send = y if s + 1 < S else None
        takes = s > 0 and 0 <= t + 1 - s < n_micro
        recv = mesh.exchange(axis_name, send=send, to=s + 1,
                             recv=torch.empty_like(xm[0]) if takes else None,
                             frm=s - 1)
    out = (torch.stack(outs) if s == S - 1
           else torch.zeros((n_micro,) + tuple(xm.shape[1:]),
                            dtype=x.dtype, device=x.device))
    if S > 1:
        # the last stage's outputs to every rank (the closing psum)
        mesh.all_reduce(out, axis_name)
    return out.reshape(n_tokens, *out.shape[2:])
