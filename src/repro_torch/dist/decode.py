"""Decode attention across cache slabs and page pools.

Counterpart of ``repro.dist.decode``; only the single-slab / single-shard
branches are ported.  The decode partials come from the dispatch
registry (``decode_partial``, ``decode_partial_paged``,
``decode_partial_paged_q8``: 'torch' plain, 'cuda' the kernels) and are
normalized here.  The sequence-sharded combine over
``torch.distributed`` is ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch as D

_SEQ_SHARD = ("decode_shard='seq' (sequence-sharded FlashDecoding over "
              "torch.distributed) is not ported yet: ROADMAP queue 1 "
              "item 14")


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
        raise NotImplementedError(_SEQ_SHARD)
    return local_decode_attend(q, cache_k, cache_v, cur_len,
                               backend=backend)


def _page_counts(lens, J: int, page_size: int) -> np.ndarray:
    """(B,) valid-position counts -> (B, J) per-logical-page counts.

    Host-side numpy: the paged step builds its counts once per step,
    before its one host-to-device copy, not per layer on the device."""
    lens = np.asarray(lens, np.int64)
    return np.clip(lens[:, None] - np.arange(J)[None, :] * page_size,
                   0, page_size).astype(np.int32)


def local_paged_decode_attend(q, k_pool, v_pool, table, counts, *,
                              k_scale=None, v_scale=None,
                              backend="cuda") -> torch.Tensor:
    """Single-shard paged decode attention (normalized).

    q: (B, H, Dh); k_pool, v_pool: (n_pages, page_size, KV, Dh);
    table: (B, J) int32; counts: (B, J) int32 valid tokens per logical
    page (``_page_counts`` of the per-slot lengths; all 0 for an
    inactive slot -> zero output).  The JAX function takes the lengths
    and builds the counts in each layer; here the caller passes counts
    built once per step.  ``k_scale``/``v_scale`` ((n_pages, KV) fp32
    per-page per-head scales) select the q8 op over int8 pools."""
    if k_scale is not None:
        o_t, m, l = D.dispatch("decode_partial_paged_q8", backend, q,
                               k_pool, v_pool, k_scale, v_scale, table,
                               counts)
    else:
        o_t, m, l = D.dispatch("decode_partial_paged", backend, q,
                               k_pool, v_pool, table, counts)
    return _normalize(o_t, l, q.dtype)


def paged_decode_attend(q, k_pool, v_pool, table, counts, *,
                        k_scale=None, v_scale=None, backend="cuda",
                        seq_shard: bool = False) -> torch.Tensor:
    """Paged decode attention used by ``models.lm``: the local path.
    ``seq_shard=True`` (the page pool sharded across devices) is not
    ported yet."""
    if seq_shard:
        raise NotImplementedError(_SEQ_SHARD)
    return local_paged_decode_attend(q, k_pool, v_pool, table, counts,
                                     k_scale=k_scale, v_scale=v_scale,
                                     backend=backend)
