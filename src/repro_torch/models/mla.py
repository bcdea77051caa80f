"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro.models.mla``.  The cache holds the normalized
latent ``c_kv`` (kv_lora_rank) and one shared rope key (rope_head_dim) a
token.  Prefill uses the expanded form (keys and values rebuilt from the
latent through ``wk_b`` / ``wv_b``, the plain blockwise attention at
qk width nope + rope, V zero-padded to it, as in the JAX package).
Decode uses the absorbed form: ``q_nope`` is folded through ``wk_b``, so
scores and values are taken against the latent cache itself, which the
``decode_partial_mla*`` registry ops read as two separate operands
('torch' plain, 'cuda' the kernels of ``csrc/vwr_mla_decode.cu``).  A
suffix-only prefill (prefix cache, chunked prefill) rebuilds the keys
of the prefix latents gathered out of the pools
(``mla_attention_suffix``); the ``chunk_prefix_mla_paged*`` ops take an
absorbed query chunk against the prior latent pages.

Rotary embeddings here rotate ``rope_head_dim`` features (not
``d_head``); a caller that builds one table for a whole step passes it
as ``rope=``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.module import ParamDef
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import vwr_mla_decode as KM
from repro_torch.models.attention import blockwise_attn, full_attn_ref
from repro_torch.models.layers import (dt, rmsnorm, rmsnorm_spec,
                                       rope_tables, rotate)


def mla_spec(cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dtype = dt(cfg)
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), dtype, ("embed", "q_lora")),
        "q_norm": rmsnorm_spec(m.q_lora_rank, dtype),
        "wq_b": ParamDef((m.q_lora_rank, H, qd), dtype,
                         ("q_lora", "heads", "head_dim")),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.rope_head_dim), dtype,
                          ("embed", "kv_lora")),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank, dtype),
        "wk_b": ParamDef((m.kv_lora_rank, H, m.nope_head_dim), dtype,
                         ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamDef((m.kv_lora_rank, H, m.v_head_dim), dtype,
                         ("kv_lora", "heads", "head_dim")),
        "wo": ParamDef((H, m.v_head_dim, d), dtype,
                       ("heads", "head_dim", "embed")),
    }


def rope_table(cfg, positions):
    """The (cos, sin) tables of ``positions`` at ``rope_head_dim``."""
    return rope_tables(positions, cfg.mla.rope_head_dim, cfg.rope_theta)


def mla_latent(p, x, positions, cfg, *, rope=None):
    """x (B, S, D) -> (c_kv normalized (B, S, r), k_rope rotated (B, S,
    rope)): what the cache holds."""
    m = cfg.mla
    rope = rope if rope is not None else rope_table(cfg, positions)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = rotate(kv_a[..., m.kv_lora_rank:][:, :, None, :], *rope)
    return c_kv, k_rope[:, :, 0, :]


def mla_queries(p, x, positions, cfg, *, rope=None):
    """x (B, S, D) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope))."""
    m = cfg.mla
    rope = rope if rope is not None else rope_table(cfg, positions)
    q_a = rmsnorm(p["q_norm"], torch.einsum("bsd,dr->bsr", x, p["wq_a"]),
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_a, p["wq_b"])
    return q[..., :m.nope_head_dim], rotate(q[..., m.nope_head_dim:], *rope)


def v_pad(v, d):
    """Pad V's head dim up to the QK head dim (a uniform attention)."""
    pad = d - v.shape[-1]
    return v if pad == 0 else torch.nn.functional.pad(v, (0, pad))


def mla_attention(p, x, positions, cfg, *, causal=True, dense=False):
    """Expanded-form attention for prefill.  Returns (out (B, S, D),
    (c_kv, k_rope))."""
    m = cfg.mla
    H = cfg.n_heads
    rope = rope_table(cfg, positions)
    q_nope, q_rope = mla_queries(p, x, positions, cfg, rope=rope)
    c_kv, k_rope = mla_latent(p, x, positions, cfg, rope=rope)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H,
                                            m.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    if dense:
        o = full_attn_ref(q, k, v_pad(v, q.shape[-1]), causal=causal,
                          q_positions=positions, kv_positions=positions)
    else:
        o = blockwise_attn(q, k, v_pad(v, q.shape[-1]), causal=causal,
                           q_positions=positions, kv_positions=positions,
                           block_q=cfg.attn_block_q,
                           block_kv=cfg.attn_block_kv)
    out = torch.einsum("bshk,hkd->bsd", o[..., :m.v_head_dim], p["wo"])
    return out, (c_kv, k_rope)


def mla_attention_suffix(p, x, q_positions, kv_positions, cfg, prefix_ckv,
                         prefix_krope):
    """Expanded-form attention of a suffix-only prefill (prefix cache,
    chunked prefill).  ``x`` (B, S, D) holds the suffix tokens at global
    ``q_positions``; ``prefix_ckv`` (B, M, r) / ``prefix_krope`` (B, M,
    rope) are the prefix latents gathered back out of the pools.  Keys
    and values are rebuilt from the concatenated latents through wk_b /
    wv_b as the whole prefill does, on the same blockwise kv length and
    block boundaries, so each suffix row equals the whole prompt's row
    for model-dtype pools.  Returns (out (B, S, D), (c_kv, k_rope)) of
    the suffix only."""
    m = cfg.mla
    H = cfg.n_heads
    rope = rope_table(cfg, q_positions)
    q_nope, q_rope = mla_queries(p, x, q_positions, cfg, rope=rope)
    c_kv, k_rope = mla_latent(p, x, q_positions, cfg, rope=rope)
    ckv_all = torch.cat([prefix_ckv.to(c_kv.dtype), c_kv], 1)
    krope_all = torch.cat([prefix_krope.to(k_rope.dtype), k_rope], 1)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_all, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv_all, p["wv_b"])
    k_rope_h = krope_all[:, :, None, :].expand(*krope_all.shape[:2], H,
                                                m.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    attend = full_attn_ref if cfg.accounting else blockwise_attn
    blocks = ({} if cfg.accounting else
              dict(block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv))
    o = attend(q, k, v_pad(v, q.shape[-1]), causal=True,
               q_positions=q_positions, kv_positions=kv_positions, **blocks)
    out = torch.einsum("bshk,hkd->bsd", o[..., :m.v_head_dim], p["wo"])
    return out, (c_kv, k_rope)


# ---------------- absorbed decode ----------------

def mla_absorbed_queries(p, q_nope, q_rope, cfg
                         ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Fold q_nope (B, H, nope) through wk_b.  Returns (q_abs (B, H, r)
    fp32, q_rope fp32, scale = 1/sqrt(nope + rope)): the query triple of
    every ``decode_partial_mla*`` op."""
    m = cfg.mla
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope.float(), p["wk_b"].float())
    scale = 1.0 / ((m.nope_head_dim + m.rope_head_dim) ** 0.5)
    return q_abs, q_rope.float(), scale


def mla_flash_decode_partial(q_abs, q_rope, cache_ckv, cache_krope,
                             kv_positions, cur_len, *, scale: float):
    """Split-operand absorbed partial decode (the plain reference):
    q_abs (B, H, r) fp32; q_rope (B, H, rope); cache_ckv (B, T, r);
    cache_krope (B, T, rope); kv_positions (T,) global positions of the
    slab.  Returns fp32 (o_tilde (B, H, r), m (B, H), l (B, H))."""
    return KM.mla_partials(q_abs, q_rope, cache_ckv, cache_krope,
                           (kv_positions < cur_len)[None], scale)


def mla_paged_flash_decode_partial(q_abs, q_rope, ckv_pool, krope_pool,
                                   block_table, page_counts, *,
                                   scale: float):
    """Split-operand paged partial decode (the plain gather reference):
    pools (n_pages, ps, r / rope); block_table / page_counts (B, J)
    int, a count of 0 masking a page.  Gathers only the tables' pages."""
    return KM.vwr_mla_paged_flash_decode_ref(q_abs, q_rope, ckv_pool,
                                             krope_pool, block_table,
                                             page_counts, scale=scale)


# Registered split-operand decode contract: (q_abs (B, H, r) fp32,
# q_rope (B, H, rope), latent and rope caches, ...) -> fp32 (o_tilde,
# m, l).  The q8 ops take int8 caches and fp32 scales, (B,) for the
# dense cache and (n_pages,) for the pools, latent and rope apart.

@D.register("decode_partial_mla", "torch")
def _decode_partial_mla_torch(q_abs, q_rope, c_kv, k_rope, cur_len,
                              pos0=0, *, scale):
    T = c_kv.shape[1]
    return mla_flash_decode_partial(
        q_abs, q_rope, c_kv, k_rope,
        pos0 + torch.arange(T, device=c_kv.device), cur_len, scale=scale)


@D.register("decode_partial_mla", "cuda")
def _decode_partial_mla_cuda(q_abs, q_rope, c_kv, k_rope, cur_len, pos0=0,
                             *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_flash_decode(q_abs, q_rope, c_kv, k_rope, cur_len,
                                    pos0, scale=scale)


@D.register("decode_partial_mla_paged", "torch")
def _decode_partial_mla_paged_torch(q_abs, q_rope, ckv_pool, krope_pool,
                                    table, counts, *, scale):
    return mla_paged_flash_decode_partial(q_abs, q_rope, ckv_pool,
                                          krope_pool, table, counts,
                                          scale=scale)


@D.register("decode_partial_mla_paged", "cuda")
def _decode_partial_mla_paged_cuda(q_abs, q_rope, ckv_pool, krope_pool,
                                   table, counts, *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_paged_flash_decode(q_abs, q_rope, ckv_pool,
                                          krope_pool, table, counts,
                                          scale=scale)


@D.register("decode_partial_mla_q8", "torch")
def _decode_partial_mla_q8_torch(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                                 krope_scale, cur_len, pos0=0, *, scale):
    # dequantize, then attend
    return KM.vwr_mla_flash_decode_q8_ref(q_abs, q_rope, c_kv, k_rope,
                                          ckv_scale, krope_scale, cur_len,
                                          pos0, scale=scale)


@D.register("decode_partial_mla_q8", "cuda")
def _decode_partial_mla_q8_cuda(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                                krope_scale, cur_len, pos0=0, *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_flash_decode_q8(q_abs, q_rope, c_kv, k_rope,
                                       ckv_scale, krope_scale, cur_len,
                                       pos0, scale=scale)


@D.register("decode_partial_mla_paged_q8", "torch")
def _decode_partial_mla_paged_q8_torch(q_abs, q_rope, ckv_pool, krope_pool,
                                       ckv_scale, krope_scale, table,
                                       counts, *, scale):
    # the gathered pages are dequantized, not the whole pool
    return KM.vwr_mla_paged_flash_decode_q8_ref(
        q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale, table,
        counts, scale=scale)


@D.register("decode_partial_mla_paged_q8", "cuda")
def _decode_partial_mla_paged_q8_cuda(q_abs, q_rope, ckv_pool, krope_pool,
                                      ckv_scale, krope_scale, table, counts,
                                      *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_paged_flash_decode_q8(q_abs, q_rope, ckv_pool,
                                             krope_pool, ckv_scale,
                                             krope_scale, table, counts,
                                             scale=scale)


# ---------------- chunked prefill (absorbed chunk vs latent pools) -------
#
# The MLA sibling of ``attention.chunk_prefix_attend_partial``: an
# absorbed (C, H, r) query chunk against the latent pools over the
# chunk's PRIOR pages, table and counts (J,) shared by the C tokens.
# Returns latent-space fp32 partials (o_tilde (C, H, r), m (C, H),
# l (C, H)).  As in the JAX package no engine path dispatches these ops
# (the engine's chunk step is ``mla_attention_suffix``).

def mla_chunk_prefix_attend_partial(q_abs, q_rope, ckv_pool, krope_pool,
                                    table, counts, *, scale: float):
    """The plain gather reference of the MLA chunk-prefix contract
    (kernel 12's plain version): table / counts (J,) int, a count of 0
    masking a page, entries clamped to [0, n_pages)."""
    return KM.vwr_mla_chunk_prefix_attend_ref(q_abs, q_rope, ckv_pool,
                                              krope_pool, table, counts,
                                              scale=scale)


@D.register("chunk_prefix_mla_paged", "torch")
def _chunk_prefix_mla_paged_torch(q_abs, q_rope, ckv_pool, krope_pool,
                                  table, counts, *, scale):
    return mla_chunk_prefix_attend_partial(q_abs, q_rope, ckv_pool,
                                           krope_pool, table, counts,
                                           scale=scale)


@D.register("chunk_prefix_mla_paged", "cuda")
def _chunk_prefix_mla_paged_cuda(q_abs, q_rope, ckv_pool, krope_pool,
                                 table, counts, *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_chunk_prefix_attend(q_abs, q_rope, ckv_pool,
                                           krope_pool, table, counts,
                                           scale=scale)


@D.register("chunk_prefix_mla_paged_q8", "torch")
def _chunk_prefix_mla_paged_q8_torch(q_abs, q_rope, ckv_pool, krope_pool,
                                     ckv_scale, krope_scale, table, counts,
                                     *, scale):
    # the gathered pages are dequantized, not the whole pool
    return KM.vwr_mla_chunk_prefix_attend_q8_ref(
        q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale, table,
        counts, scale=scale)


@D.register("chunk_prefix_mla_paged_q8", "cuda")
def _chunk_prefix_mla_paged_q8_cuda(q_abs, q_rope, ckv_pool, krope_pool,
                                    ckv_scale, krope_scale, table, counts,
                                    *, scale):
    from repro_torch.kernels import ops
    return ops.vwr_mla_chunk_prefix_attend_q8(q_abs, q_rope, ckv_pool,
                                              krope_pool, ckv_scale,
                                              krope_scale, table, counts,
                                              scale=scale)


def mla_concat_view(q_abs, q_rope, c_kv, k_rope, scale: float):
    """The concatenated k_cat / v_cat view of the split decode operands,
    the equivalence reference (tests, and the library yardstick of the
    kernels).  c_kv / k_rope may be dense (B, T, .) or paged (n_pages,
    ps, .).  Returns (q_cat pre-scaled by ``scale * sqrt(r + rope)`` so a
    plain decode's 1/sqrt(r + rope) nets to ``scale``, k_cat and v_cat
    with a KV = 1 head axis, v_cat zero-padding the rope features, r)."""
    r = c_kv.shape[-1]
    Dc = r + k_rope.shape[-1]
    q_cat = torch.cat([q_abs, q_rope], -1) * (scale * Dc ** 0.5)
    k_cat = torch.cat([c_kv, k_rope], -1)[..., None, :]
    v_cat = torch.cat([c_kv, torch.zeros_like(k_rope)], -1)[..., None, :]
    return q_cat, k_cat, v_cat, r


def mla_decode_finish(p, o_latent, cfg):
    """(B, H, r) normalized latent attention output -> (B, d_model), in
    the latent's dtype (fp32 on the decode path, wv_b and wo cast to it
    as in the JAX package)."""
    o = torch.einsum("bhr,rhk->bhk", o_latent,
                     p["wv_b"].to(o_latent.dtype))
    return torch.einsum("bhk,hkd->bd", o, p["wo"].to(o_latent.dtype))
