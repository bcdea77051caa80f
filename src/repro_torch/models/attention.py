"""GQA attention: projections, blockwise (flash-style) prefill attention
and single-token decode partials.

Counterpart of ``repro.models.attention`` for the dense serving path.
The ``qkv_proj``, ``o_proj``, ``attention``, ``decode_partial``,
``decode_partial_paged`` and ``decode_partial_paged_q8`` ops are
registered here per dispatch backend: 'torch' is the plain
formulation, 'cuda' goes through the hand-written kernels
(``repro_torch.kernels.ops``).  Decode attention returns unnormalized
partials ``(o_tilde, m, l)`` so that sequence-sharded slabs can be
combined (``dist.decode``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common.module import ParamDef, zeros_init
from repro_torch.kernels import dispatch as D
from repro_torch.models.layers import apply_rope, dt

NEG_INF = -1e30


# ---------------- projections ----------------

def gqa_spec(cfg):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dtype = dt(cfg)
    spec = {
        "wq": ParamDef((d, H, Dh), dtype, ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, Dh), dtype, ("embed", "kv", "head_dim")),
        "wv": ParamDef((d, KV, Dh), dtype, ("embed", "kv", "head_dim")),
        "wo": ParamDef((H, Dh, d), dtype, ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamDef((H, Dh), dtype, ("heads", "head_dim"),
                              zeros_init)
        spec["bk"] = ParamDef((KV, Dh), dtype, ("kv", "head_dim"),
                              zeros_init)
        spec["bv"] = ParamDef((KV, Dh), dtype, ("kv", "head_dim"),
                              zeros_init)
    return spec


@D.register("qkv_proj", "torch")
def _qkv_proj_torch(p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


@D.register("qkv_proj", "cuda")
def _qkv_proj_cuda(p, x):
    from repro_torch.kernels import ops
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)

    def proj(w, b):
        nh, dh = w.shape[1], w.shape[2]
        out = ops.vwr_matmul(x2, w.reshape(d, nh * dh), b)   # bias fused
        return out.reshape(B, S, nh, dh)

    return (proj(p["wq"], p.get("bq")), proj(p["wk"], p.get("bk")),
            proj(p["wv"], p.get("bv")))


def qkv_proj(p, x, positions, rope_theta, backend="cuda"):
    """QKV projection (+rope) via the dispatch registry.  ``backend`` is
    a backend string or a ModelConfig."""
    q, k, v = D.dispatch("qkv_proj", backend, p, x)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


@D.register("o_proj", "torch")
def _o_proj_torch(p, o, residual=None):
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out if residual is None else residual + out


@D.register("o_proj", "cuda")
def _o_proj_cuda(p, o, residual=None):
    from repro_torch.kernels import ops
    B, S, H, Dh = o.shape
    d = p["wo"].shape[-1]
    r2 = None if residual is None else residual.reshape(B * S, d)
    out = ops.vwr_matmul(o.reshape(B * S, H * Dh),
                         p["wo"].reshape(H * Dh, d), residual=r2)
    return out.reshape(B, S, d)


def o_proj(p, o, backend="cuda", residual=None):
    """Output projection; with ``residual`` returns residual + o @ wo —
    fused into the kernel's epilogue on the 'cuda' path."""
    return D.dispatch("o_proj", backend, p, o, residual=residual)


# ---------------- blockwise flash attention (prefill) ----------------

def blockwise_attn(q, k, v, *, causal: bool,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   kv_valid: Optional[torch.Tensor] = None,
                   block_q: int = 512, block_kv: int = 1024):
    """Streaming softmax attention; peak memory O(block_q * block_kv).
    q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh); heads kv-major."""
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / (Dh ** 0.5)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones(Skv, dtype=torch.bool, device=dev)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Sq, block_q):
        qi = q[:, q0:q0 + block_q].float()
        bq = qi.shape[1]
        qi = qi.reshape(B, bq, KV, G, Dh) * scale
        qp = q_positions[q0:q0 + bq]
        acc = torch.zeros(B, KV, G, bq, Dh, device=dev)
        m = torch.full((B, KV, G, bq), NEG_INF, device=dev)
        l = torch.zeros(B, KV, G, bq, device=dev)
        for k0 in range(0, Skv, block_kv):
            kj, vj = kf[:, k0:k0 + block_kv], vf[:, k0:k0 + block_kv]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            mask = kv_valid[k0:k0 + block_kv][None, :]
            if causal:
                mask = mask & (kv_positions[k0:k0 + block_kv][None, :]
                               <= qp[:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vj)
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]          # (B,KV,G,bq,Dh)
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, Dh).to(q.dtype)
    return out


@D.register("attention", "torch")
def _attention_torch(q, k, v, *, causal, q_positions=None,
                     kv_positions=None, block_q=512, block_kv=1024):
    return blockwise_attn(q, k, v, causal=causal, q_positions=q_positions,
                          kv_positions=kv_positions, block_q=block_q,
                          block_kv=block_kv)


@D.register("attention", "cuda")
def _attention_cuda(q, k, v, *, causal, q_positions=None,
                    kv_positions=None, block_q=512, block_kv=1024):
    """Zero-copy GQA flash kernel.  The non-causal (encoder) path keeps
    the blockwise formulation, as in the JAX package."""
    if causal:
        from repro_torch.kernels import ops
        return ops.vwr_attention(q, k, v, causal=True)
    return _attention_torch(q, k, v, causal=causal, q_positions=q_positions,
                            kv_positions=kv_positions, block_q=block_q,
                            block_kv=block_kv)


def full_attn_ref(q, k, v, *, causal, q_positions=None, kv_positions=None,
                  kv_valid=None):
    """Dense oracle used by tests."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(k.shape[1], device=dev)
    qf = q.float().reshape(B, Sq, KV, G, Dh) / (Dh ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = torch.ones(Sq, k.shape[1], dtype=torch.bool, device=dev)
    if causal:
        mask = kv_positions[None, :] <= q_positions[:, None]
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


# ---------------- decode (single new token against a cache) ----------------

def flash_decode_partial(q, cache_k, cache_v, kv_positions, cur_len
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """q: (B, H, Dh) one new token; cache_k/v: (B, T, KV, Dh);
    kv_positions: (T,) global positions of the slab.  Returns fp32
    (o_tilde, m, l) with o_tilde = sum(exp(s - m) * v)."""
    B, H, Dh = q.shape
    KV = cache_k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Dh) / (Dh ** 0.5)
    s = torch.einsum("bhgd,bthd->bhgt", qf, cache_k.float())
    s = torch.where(kv_positions < cur_len, s, NEG_INF)
    m = s.amax(-1)                                           # (B,KV,G)
    p = torch.exp(s - m[..., None])
    # rows with no valid key (m == NEG_INF) contribute l = 0
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    l = p.sum(-1)
    o_t = torch.einsum("bhgt,bthd->bhgd", p, cache_v.float())
    return o_t.reshape(B, H, Dh), m.reshape(B, H), l.reshape(B, H)


# Registered decode-partial contract: (q (B,H,Dh), k/v (B,T,KV,Dh) slab
# starting at global position pos0, cur_len) -> fp32 (o_tilde, m, l).

@D.register("decode_partial", "torch")
def _decode_partial_torch(q, k, v, cur_len, pos0=0):
    T = k.shape[1]
    return flash_decode_partial(
        q, k, v, pos0 + torch.arange(T, device=q.device), cur_len)


@D.register("decode_partial", "cuda")
def _decode_partial_cuda(q, k, v, cur_len, pos0=0):
    from repro_torch.kernels import ops
    return ops.vwr_flash_decode(q, k, v, cur_len, pos0=pos0)


# ---------------- paged decode (block-table-indexed page pool) ----------------

def paged_flash_decode_partial(q, k_pool, v_pool, block_table, page_counts
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Gather reference for the paged decode contract.

    q: (B, H, Dh) one new token per slot; k_pool, v_pool: (n_pages,
    page_size, KV, Dh); block_table, page_counts: (B, J) int — physical
    page and valid tokens per (slot, logical page), 0 masking a page
    (past the slot's length, unallocated, or another shard's).  The
    plain version of the paged kernel
    (``kernels.vwr_decode.vwr_paged_flash_decode_ref``) over the query's
    kv-major head groups.  Returns fp32 (o_tilde (B, H, Dh), m (B, H),
    l (B, H))."""
    from repro_torch.kernels import ops, vwr_decode
    out = vwr_decode.vwr_paged_flash_decode_ref(
        ops._groups(q, k_pool.shape[2]), k_pool, v_pool, block_table,
        page_counts)
    return ops._heads(*out, q.shape[0])


# Registered paged contract: (q (B,H,Dh), pools (n_pages,ps,KV,Dh),
# table (B,J), counts (B,J)) -> fp32 (o_tilde, m, l); the q8 ops take
# int8 pools and their fp32 (n_pages, KV) scales after the pools.

@D.register("decode_partial_paged", "torch")
def _decode_partial_paged_torch(q, k_pool, v_pool, table, counts):
    return paged_flash_decode_partial(q, k_pool, v_pool, table, counts)


@D.register("decode_partial_paged", "cuda")
def _decode_partial_paged_cuda(q, k_pool, v_pool, table, counts):
    from repro_torch.kernels import ops
    return ops.vwr_paged_flash_decode(q, k_pool, v_pool, table, counts)


@D.register("decode_partial_paged_q8", "torch")
def _decode_partial_paged_q8_torch(q, k_pool, v_pool, k_scale, v_scale,
                                   table, counts):
    # the gathered pages are dequantized, not the whole pool
    from repro_torch.kernels import ops, vwr_decode
    out = vwr_decode.vwr_paged_flash_decode_q8_ref(
        ops._groups(q, k_pool.shape[2]), k_pool, v_pool, k_scale, v_scale,
        table, counts)
    return ops._heads(*out, q.shape[0])


@D.register("decode_partial_paged_q8", "cuda")
def _decode_partial_paged_q8_cuda(q, k_pool, v_pool, k_scale, v_scale,
                                  table, counts):
    from repro_torch.kernels import ops
    return ops.vwr_paged_flash_decode_q8(q, k_pool, v_pool, k_scale,
                                         v_scale, table, counts)
