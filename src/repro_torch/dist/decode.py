"""Decode and chunk-prefix attention across cache slabs and page pools.

Counterpart of ``repro.dist.decode``; only the single-slab / single-shard
branches are ported.  The decode partials come from the dispatch
registry (``decode_partial``, ``decode_partial_q8``,
``decode_partial_paged``,
``decode_partial_paged_q8`` and the split-operand MLA ops
``decode_partial_mla``, ``decode_partial_mla_q8``,
``decode_partial_mla_paged``, ``decode_partial_mla_paged_q8``: 'torch'
plain, 'cuda' the kernels) and are normalized here; the chunk-prefix
partials (``chunk_prefix_paged``, ``chunk_prefix_paged_q8``) are
returned unnormalized, for the caller to merge with the chunk's causal
self partial.  The sequence-sharded
combine over ``torch.distributed`` is ROADMAP queue 1 item 14.
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


def local_decode_attend(q, cache_k, cache_v, cur_len, *, k_scale=None,
                        v_scale=None, backend="cuda") -> torch.Tensor:
    """Single-slab decode attention (normalized) through the registry.

    ``k_scale`` / ``v_scale`` ((B, KV) fp32, one a (batch, KV head) row)
    select the q8 op: ``cache_k`` / ``cache_v`` are then int8."""
    if k_scale is not None:
        o_t, m, l = D.dispatch("decode_partial_q8", backend, q, cache_k,
                               cache_v, k_scale, v_scale, cur_len)
    else:
        o_t, m, l = D.dispatch("decode_partial", backend, q, cache_k,
                               cache_v, cur_len)
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


# ======================================================================
# absorbed MLA: the latent and rope caches as separate operands
# ======================================================================

def local_mla_decode_attend(q_abs, q_rope, cache_ckv, cache_krope, cur_len,
                            *, scale: float, ckv_scale=None,
                            krope_scale=None, backend="cuda"
                            ) -> torch.Tensor:
    """Single-slab split-operand MLA decode attention: the normalized
    (B, H, r) latent context, fp32 as q_abs.

    q_abs (B, H, r) fp32; q_rope (B, H, rope); cache_ckv (B, T, r);
    cache_krope (B, T, rope); ``cur_len`` valid positions (a host int on
    the kernel path).  ``ckv_scale`` / ``krope_scale`` ((B,) fp32)
    select the q8 op over int8 latent caches."""
    if ckv_scale is not None:
        o_t, m, l = D.dispatch("decode_partial_mla_q8", backend, q_abs,
                               q_rope, cache_ckv, cache_krope, ckv_scale,
                               krope_scale, cur_len, scale=scale)
    else:
        o_t, m, l = D.dispatch("decode_partial_mla", backend, q_abs,
                               q_rope, cache_ckv, cache_krope, cur_len,
                               scale=scale)
    return _normalize(o_t, l, q_abs.dtype)


def mla_decode_attend(q_abs, q_rope, cache_ckv, cache_krope, cur_len, *,
                      scale: float, ckv_scale=None, krope_scale=None,
                      backend="cuda", seq_shard: bool = False
                      ) -> torch.Tensor:
    """Split-operand MLA decode attention used by ``models.lm``: the
    local path.  ``seq_shard=True`` is not ported yet."""
    if seq_shard:
        raise NotImplementedError(_SEQ_SHARD)
    return local_mla_decode_attend(q_abs, q_rope, cache_ckv, cache_krope,
                                   cur_len, scale=scale,
                                   ckv_scale=ckv_scale,
                                   krope_scale=krope_scale,
                                   backend=backend)


def local_mla_paged_decode_attend(q_abs, q_rope, ckv_pool, krope_pool,
                                  table, counts, *, scale: float,
                                  ckv_scale=None, krope_scale=None,
                                  backend="cuda") -> torch.Tensor:
    """Single-shard split-operand paged MLA decode attention (the
    normalized (B, H, r) latent context).

    ckv_pool (n_pages, page_size, r); krope_pool (n_pages, page_size,
    rope); table, counts (B, J) int32, the counts built once a step from
    the lengths (``_page_counts``), as for the GQA pools.
    ``ckv_scale`` / ``krope_scale`` ((n_pages,) fp32) select the q8 op
    over int8 pools."""
    if ckv_scale is not None:
        o_t, m, l = D.dispatch("decode_partial_mla_paged_q8", backend,
                               q_abs, q_rope, ckv_pool, krope_pool,
                               ckv_scale, krope_scale, table, counts,
                               scale=scale)
    else:
        o_t, m, l = D.dispatch("decode_partial_mla_paged", backend, q_abs,
                               q_rope, ckv_pool, krope_pool, table, counts,
                               scale=scale)
    return _normalize(o_t, l, q_abs.dtype)


def mla_paged_decode_attend(q_abs, q_rope, ckv_pool, krope_pool, table,
                            counts, *, scale: float, ckv_scale=None,
                            krope_scale=None, backend="cuda",
                            seq_shard: bool = False) -> torch.Tensor:
    """Paged split-operand MLA decode attention used by ``models.lm``:
    the local path.  ``seq_shard=True`` is not ported yet."""
    if seq_shard:
        raise NotImplementedError(_SEQ_SHARD)
    return local_mla_paged_decode_attend(
        q_abs, q_rope, ckv_pool, krope_pool, table, counts, scale=scale,
        ckv_scale=ckv_scale, krope_scale=krope_scale, backend=backend)


# ======================================================================
# chunked prefill: chunk-prefix attention
# ======================================================================

def local_chunk_prefix_attend(q, k_pool, v_pool, table, counts, *,
                              k_scale=None, v_scale=None,
                              backend="cuda"):
    """Single-shard chunk -> prior-pages attention partial through the
    dispatch registry.

    q: (C, H, Dh) one prompt chunk's queries; k_pool, v_pool: (n_pages,
    page_size, KV, Dh); table: (J,) int32 the chunk's PRIOR whole pages
    (earlier chunks and prefix-cache aliases); counts: (J,) int32 valid
    tokens per page.  Returns the UNNORMALIZED fp32 partial (o_t (C, H,
    Dh), m (C, H), l (C, H)): the caller merges it with the chunk's
    causal self partial (``models.attention.merge_partials``) and
    normalizes, as ``models.attention.chunk_prefill_attend`` does.
    ``k_scale``/``v_scale`` ((n_pages, KV) fp32) select the q8 op over
    int8 pools."""
    if k_scale is not None:
        return D.dispatch("chunk_prefix_paged_q8", backend, q, k_pool,
                          v_pool, k_scale, v_scale, table, counts)
    return D.dispatch("chunk_prefix_paged", backend, q, k_pool, v_pool,
                      table, counts)

