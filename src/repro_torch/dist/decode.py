"""Distributed FlashDecoding: decode and chunk-prefix attention over a
sequence-sharded KV cache.

Counterpart of ``repro.dist.decode``.  Decode attention reads the whole
KV cache once per generated token with no reuse, so its bytes, not its
operations, set the time.  Moving the cache across the interconnect
would put those bytes on the far tier; instead each model rank keeps a
contiguous slab of the context (a dense cache's positions [coord *
T_local, (coord + 1) * T_local), or a page pool's pages [coord * pp,
(coord + 1) * pp)), computes an UNNORMALIZED online-softmax partial over
it, and only the (B, H)-sized statistics cross ranks:

    m* = max_i m_i
    o  = sum_i o~_i * exp(m_i - m*)  /  sum_i l_i * exp(m_i - m*)

(``_combine_partials``: one MAX all-reduce of m, then one SUM all-reduce
of o~ * s and l * s side by side: two collectives a layer.)  An empty
slab's partial is (0, NEG_INF = -1e30, 0), finite, so it combines to
exp(0) * 0 and never to NaN.

The partials come from the dispatch registry (``decode_partial``,
``decode_partial_q8``, ``decode_partial_paged``,
``decode_partial_paged_q8``, the split-operand MLA ops
``decode_partial_mla[_paged][_q8]`` and the chunk-prefix ops
``chunk_prefix[_mla]_paged[_q8]``: 'torch' plain, 'cuda' the kernels).
Each sharded function resolves its backend by cache LOOKUP alone
(``dispatch.cached_backend``): no rank measures, so every rank runs the
same backend.

Multi-controller, where the JAX package is single-controller: a
``sharded_*`` function runs on every rank of the mesh and takes THIS
rank's blocks (the body of the JAX ``shard_map``): the batch rows it
holds and its slab of the cache, or its slab of the pools with a block
table already made local by ``own_pages`` (built on the host once a
step, ``models.lm.paged_step_meta``).  Its output is replicated over
'model': every rank gets the same bits.  The routers (``decode_attend``
and its siblings) take what the rank holds and route to the sharded
function when ``seq_shard`` is set and the mesh has a 'model' axis, else
to the local path (no mesh: local, as in JAX).  The JAX routers also
fall back when the model axis does not divide the cache; in the port
the cache is cut before it reaches a router, and that check is made
where it is cut (``DecodeEngine`` raises ``ValueError`` as the JAX
engine does; ``dist.sharding.local_block`` raises for a dim its axes do
not divide).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import sharding as S
from repro_torch.kernels import dispatch as D
# the modules that register the decode and chunk-prefix ops
from repro_torch.models import attention, mla  # noqa: F401


def _normalize(o_t, l, dtype):
    return (o_t / l.clamp_min(1e-30)[..., None]).to(dtype)


def _combine_partials(o_t, m, l, mesh):
    """The statistics combine over 'model': (o~, m*, l) unnormalized,
    the same bits on every rank of the axis.  o~ * s and l * s ride one
    SUM collective."""
    if mesh.axis_size("model") == 1:
        return o_t, m, l
    m_star = mesh.all_reduce(m.clone(), "model", "max")
    s = torch.exp(m - m_star)
    o = o_t * s[..., None]
    both = torch.cat([o.reshape(-1), (l * s).reshape(-1)])
    mesh.all_reduce(both, "model", "sum")
    n = o.numel()
    return both[:n].view(o.shape), m_star, both[n:].view(l.shape)


def _combined(o_t, m, l, mesh, dtype):
    o, _, l = _combine_partials(o_t, m, l, mesh)
    return _normalize(o, l, dtype)


def _routes(mesh, seq_shard: bool) -> bool:
    return seq_shard and mesh is not None and "model" in mesh.axis_names


def _page_counts(lens, J: int, page_size: int) -> np.ndarray:
    """(B,) valid-position counts -> (B, J) per-logical-page counts.

    Host-side numpy: the paged step builds its counts once per step,
    before its one host-to-device copy, not per layer on the device."""
    lens = np.asarray(lens, np.int64)
    return np.clip(lens[:, None] - np.arange(J)[None, :] * page_size,
                   0, page_size).astype(np.int32)


def own_pages(table, counts, p0: int, pp: int):
    """Host side: a replicated block table (and its per-page counts) as
    one rank sees it when it owns pages [p0, p0 + pp): the table clipped
    to the slab's local ids, the counts of foreign pages zeroed.  Any
    shape (a slot's (B, J) rows, a chunk's (J,) table)."""
    table = np.asarray(table, np.int64)
    owned = (table >= p0) & (table < p0 + pp)
    return (np.clip(table - p0, 0, pp - 1).astype(np.int32),
            np.where(owned, np.asarray(counts), 0).astype(np.int32))


# ======================================================================
# dense cache (GQA)
# ======================================================================

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


def sharded_flash_decode(mesh, q, cache_k, cache_v, cur_len, *,
                         k_scale=None, v_scale=None, backend="cuda"
                         ) -> torch.Tensor:
    """Decode attention with the cache sequence-sharded over 'model'.

    q: (B, H, Dh) this rank's rows' new token; cache_k / v: (B, T_local,
    KV, Dh) its slab, positions [coord * T_local, (coord + 1) * T_local)
    of the cache; ``cur_len`` the GLOBAL count of valid positions (a host
    int).  With ``k_scale`` / ``v_scale`` ((B, KV) fp32, one scale for
    the whole sequence, so replicated over the model axis) the slabs are
    int8.  Returns the normalized (B, H, Dh) context, equal on every
    rank of the axis."""
    q8 = k_scale is not None
    op = "decode_partial_q8" if q8 else "decode_partial"
    scales = (k_scale, v_scale) if q8 else ()
    backend = D.cached_backend(op, backend,
                               (q, cache_k, cache_v, *scales, cur_len))
    pos0 = S.block_start(mesh, "model", cache_k.shape[1])
    o_t, m, l = D.dispatch(op, backend, q, cache_k, cache_v, *scales,
                           cur_len, pos0)
    return _combined(o_t, m, l, mesh, q.dtype)


def decode_attend(q, cache_k, cache_v, cur_len, *, k_scale=None,
                  v_scale=None, backend="cuda", mesh=None,
                  seq_shard: bool = True) -> torch.Tensor:
    """Decode attention used by ``models.lm``: ``sharded_flash_decode``
    when ``seq_shard`` and the mesh has a 'model' axis (the cache is then
    this rank's slab), else the local path."""
    if _routes(mesh, seq_shard):
        return sharded_flash_decode(mesh, q, cache_k, cache_v, cur_len,
                                    k_scale=k_scale, v_scale=v_scale,
                                    backend=backend)
    return local_decode_attend(q, cache_k, cache_v, cur_len,
                               k_scale=k_scale, v_scale=v_scale,
                               backend=backend)


# ======================================================================
# page pools (GQA)
# ======================================================================

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


def sharded_paged_flash_decode(mesh, q, k_pool, v_pool, table, counts, *,
                               k_scale=None, v_scale=None,
                               backend="cuda") -> torch.Tensor:
    """Paged decode attention with the page POOL sharded over 'model':
    this rank holds pages [p0, p0 + pp) (its block of
    ``sharding.paged_cache_pspecs``' page dim) as ``k_pool`` /
    ``v_pool`` (pp, page_size, KV, Dh), and ``table`` / ``counts`` (B, J)
    are the replicated table as this rank sees it (``own_pages``:
    foreign pages at count 0, ids local).  Page placement is free: the
    allocator never needs to know the mesh.  ``k_scale`` / ``v_scale``
    ((pp, KV) fp32) are this rank's slab of the int8 pools' scales."""
    q8 = k_scale is not None
    op = "decode_partial_paged_q8" if q8 else "decode_partial_paged"
    scales = (k_scale, v_scale) if q8 else ()
    args = (q, k_pool, v_pool, *scales, table, counts)
    o_t, m, l = D.dispatch(op, D.cached_backend(op, backend, args), *args)
    return _combined(o_t, m, l, mesh, q.dtype)


def paged_decode_attend(q, k_pool, v_pool, table, counts, *,
                        k_scale=None, v_scale=None, backend="cuda",
                        mesh=None, seq_shard: bool = True) -> torch.Tensor:
    """Paged decode attention used by ``models.lm``:
    ``sharded_paged_flash_decode`` when ``seq_shard`` and the mesh has a
    'model' axis (pools, table and counts are then this rank's), else
    the local path."""
    if _routes(mesh, seq_shard):
        return sharded_paged_flash_decode(mesh, q, k_pool, v_pool, table,
                                          counts, k_scale=k_scale,
                                          v_scale=v_scale, backend=backend)
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


def sharded_mla_flash_decode(mesh, q_abs, q_rope, cache_ckv, cache_krope,
                             cur_len, *, scale: float, ckv_scale=None,
                             krope_scale=None, backend="cuda"
                             ) -> torch.Tensor:
    """Split-operand absorbed-MLA decode with both latent caches
    sequence-sharded over 'model': cache_ckv (B, T_local, r) /
    cache_krope (B, T_local, rope) this rank's slab, ``cur_len`` the
    global valid count.  ``ckv_scale`` / ``krope_scale`` ((B,) fp32,
    replicated over the model axis) select the int8 slabs.  Returns the
    normalized (B, H, r) latent context."""
    q8 = ckv_scale is not None
    op = "decode_partial_mla_q8" if q8 else "decode_partial_mla"
    scales = (ckv_scale, krope_scale) if q8 else ()
    args = (q_abs, q_rope, cache_ckv, cache_krope, *scales, cur_len)
    backend = D.cached_backend(op, backend, args, {"scale": scale})
    pos0 = S.block_start(mesh, "model", cache_ckv.shape[1])
    o_t, m, l = D.dispatch(op, backend, *args, pos0, scale=scale)
    return _combined(o_t, m, l, mesh, q_abs.dtype)


def mla_decode_attend(q_abs, q_rope, cache_ckv, cache_krope, cur_len, *,
                      scale: float, ckv_scale=None, krope_scale=None,
                      backend="cuda", mesh=None, seq_shard: bool = True
                      ) -> torch.Tensor:
    """Split-operand MLA decode attention used by ``models.lm``: the MLA
    sibling of ``decode_attend``."""
    if _routes(mesh, seq_shard):
        return sharded_mla_flash_decode(
            mesh, q_abs, q_rope, cache_ckv, cache_krope, cur_len,
            scale=scale, ckv_scale=ckv_scale, krope_scale=krope_scale,
            backend=backend)
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


def sharded_mla_paged_flash_decode(mesh, q_abs, q_rope, ckv_pool,
                                   krope_pool, table, counts, *,
                                   scale: float, ckv_scale=None,
                                   krope_scale=None, backend="cuda"
                                   ) -> torch.Tensor:
    """Split-operand paged MLA decode with both latent pools sharded over
    'model': this rank's slab of pages (pp, page_size, r / rope) and the
    replicated table as it sees it (``own_pages``).  ``ckv_scale`` /
    ``krope_scale`` ((pp,) fp32) select the int8 pools."""
    q8 = ckv_scale is not None
    op = "decode_partial_mla_paged_q8" if q8 else "decode_partial_mla_paged"
    scales = (ckv_scale, krope_scale) if q8 else ()
    args = (q_abs, q_rope, ckv_pool, krope_pool, *scales, table, counts)
    backend = D.cached_backend(op, backend, args, {"scale": scale})
    o_t, m, l = D.dispatch(op, backend, *args, scale=scale)
    return _combined(o_t, m, l, mesh, q_abs.dtype)


def mla_paged_decode_attend(q_abs, q_rope, ckv_pool, krope_pool, table,
                            counts, *, scale: float, ckv_scale=None,
                            krope_scale=None, backend="cuda", mesh=None,
                            seq_shard: bool = True) -> torch.Tensor:
    """Paged split-operand MLA decode attention used by ``models.lm``:
    the MLA sibling of ``paged_decode_attend``."""
    if _routes(mesh, seq_shard):
        return sharded_mla_paged_flash_decode(
            mesh, q_abs, q_rope, ckv_pool, krope_pool, table, counts,
            scale=scale, ckv_scale=ckv_scale, krope_scale=krope_scale,
            backend=backend)
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


def _sharded_prefix(mesh, op, backend, args, kwargs):
    """One sharded chunk-prefix partial: this rank's partial over its
    pages, combined UNNORMALIZED, so the caller can still merge the
    chunk's replicated causal self partial before normalizing.  A chunk
    with no prior pages (J = 0, the same on every rank) stays local: no
    collective.  Every count zeroed combines to the fully masked partial
    (o = 0, m = NEG_INF, l = 0), which the merge treats as identity."""
    backend = D.cached_backend(op, backend, args, kwargs)
    out = D.dispatch(op, backend, *args, **kwargs)
    if args[-1].shape[0] == 0:
        return out
    return _combine_partials(*out, mesh)


def sharded_chunk_prefix_attend(mesh, q, k_pool, v_pool, table, counts, *,
                                k_scale=None, v_scale=None,
                                backend="cuda"):
    """Chunk -> prior-pages attention with the page pool sharded over
    'model', the chunked-prefill sibling of ``sharded_paged_flash_decode``:
    this rank's slab of pages and the chunk's (J,) table as it sees it
    (``own_pages``).  Returns (o~ (C, H, Dh), m* (C, H), l (C, H)),
    unnormalized; wire bytes per chunk are O(C * H * (Dh + 2)),
    independent of the prefix length.  JAX's models never call it, and
    neither do the port's: the engines' chunk step attends through
    ``prefill_suffix``."""
    q8 = k_scale is not None
    op = "chunk_prefix_paged_q8" if q8 else "chunk_prefix_paged"
    scales = (k_scale, v_scale) if q8 else ()
    return _sharded_prefix(mesh, op, backend,
                           (q, k_pool, v_pool, *scales, table, counts), {})


def sharded_mla_chunk_prefix_attend(mesh, q_abs, q_rope, ckv_pool,
                                    krope_pool, table, counts, *,
                                    scale: float, ckv_scale=None,
                                    krope_scale=None, backend="cuda"):
    """The MLA sibling of ``sharded_chunk_prefix_attend`` (kernels 12 and
    15 on each rank's slab of the latent pools); the port's own: the JAX
    package has no sharded MLA chunk prefix.  Returns latent-space
    (o~ (C, H, r), m* (C, H), l (C, H)), unnormalized."""
    q8 = ckv_scale is not None
    op = "chunk_prefix_mla_paged_q8" if q8 else "chunk_prefix_mla_paged"
    scales = (ckv_scale, krope_scale) if q8 else ()
    return _sharded_prefix(
        mesh, op, backend,
        (q_abs, q_rope, ckv_pool, krope_pool, *scales, table, counts),
        {"scale": scale})


def chunk_prefix_attend(q, k_pool, v_pool, table, counts, *, k_scale=None,
                        v_scale=None, backend="cuda", mesh=None,
                        seq_shard: bool = True):
    """Chunk-prefix attention partial: ``sharded_chunk_prefix_attend``
    when ``seq_shard`` and the mesh has a 'model' axis, else the local
    registry op.  Either way the unnormalized (o~, m, l) partial."""
    if _routes(mesh, seq_shard):
        return sharded_chunk_prefix_attend(mesh, q, k_pool, v_pool, table,
                                           counts, k_scale=k_scale,
                                           v_scale=v_scale, backend=backend)
    return local_chunk_prefix_attend(q, k_pool, v_pool, table, counts,
                                     k_scale=k_scale, v_scale=v_scale,
                                     backend=backend)
