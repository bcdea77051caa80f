"""Decode attention across cache slabs.

Counterpart of ``repro.dist.decode``; only the single-slab branch is
ported.  The decode partial comes from the dispatch registry
(``decode_partial``: 'torch' plain, 'cuda' the flash-decode kernel) and
is normalized here.  The sequence-sharded combine over
``torch.distributed`` is ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch as D


def _normalize(o_t, l, dtype):
    return (o_t / l.clamp_min(1e-30)[..., None]).to(dtype)


def local_decode_attend(q, cache_k, cache_v, cur_len, *,
                        backend="cuda") -> torch.Tensor:
    """Single-slab decode attention (normalized) through the registry."""
    o_t, m, l = D.dispatch("decode_partial", backend, q, cache_k, cache_v,
                           cur_len)
    return _normalize(o_t, l, q.dtype)


def decode_attend(q, cache_k, cache_v, cur_len, *, backend="cuda",
                  seq_shard: bool = False) -> torch.Tensor:
    """Decode attention used by ``models.lm``: the local path.
    ``seq_shard=True`` (distributed FlashDecoding) is not ported yet."""
    if seq_shard:
        raise NotImplementedError(
            "decode_shard='seq' (sequence-sharded FlashDecoding over "
            "torch.distributed) is not ported yet: ROADMAP queue 1 "
            "item 14")
    return local_decode_attend(q, cache_k, cache_v, cur_len,
                               backend=backend)
