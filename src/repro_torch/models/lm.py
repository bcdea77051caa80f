"""Model assembly for the dense family: spec, prefill and decode.

Counterpart of ``repro.models.lm``, dense family only (tinyllama,
granite, qwen, deepseek-coder).  Conventions kept from the JAX package:

  * pre-norm GQA attention + MLP; the attention and MLP sub-blocks take
    the residual stream as ``residual=`` on prefill (fused into the
    kernel epilogue on the 'cuda' backend), while decode adds the MLP
    output outside (``x + mlp(...)``), as the JAX decode body does;
  * parameters are stacked on a leading layer axis; the layers run as
    a Python loop over it;
  * the dense decode cache is ``{"k", "v"}`` of shape (L, B, T, KV, Dh);
    the paged one is pools of shape (L, n_pages, page_size, KV, Dh)
    (+ fp32 (L, n_pages, KV) scales for int8 pools) addressed through
    per-slot block tables (``paged_decode_step``).

``cfg.kernel_impl`` selects the dispatch backend ('torch' | 'cuda').
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.common import module as M
from repro_torch.dist import decode as DD
from repro_torch.kernels import dispatch as D
from repro_torch.models import attention as A
from repro_torch.models import layers as L

# where each unported family lives in ROADMAP.md queue 1
_UNPORTED = {
    "moe": "item 10 (MoE + MLA families)",
    "hybrid": "item 11 (remaining families)",
    "ssm": "item 11 (remaining families)",
    "vlm": "item 11 (remaining families)",
    "audio": "item 11 (remaining families)",
}


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.mla is not None:
        where = _UNPORTED.get(cfg.family, "item 10 (MLA)")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet: ROADMAP queue 1 {where}")


# ======================================================================
# norms
# ======================================================================

def _norm_spec(cfg):
    if cfg.norm == "layernorm":
        return L.layernorm_spec(cfg.d_model, L.dt(cfg))
    return L.rmsnorm_spec(cfg.d_model, L.dt(cfg))


def _norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


# ======================================================================
# spec / init
# ======================================================================

def _dense_layer_spec(cfg):
    return {
        "attn_norm": _norm_spec(cfg),
        "attn": A.gqa_spec(cfg),
        "mlp_norm": _norm_spec(cfg),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, L.dt(cfg)),
    }


def model_spec(cfg) -> Dict[str, Any]:
    _check_family(cfg)
    dtype = L.dt(cfg)
    spec: Dict[str, Any] = {
        "embed": L.embedding_spec(cfg.vocab_padded, cfg.d_model, dtype),
        "final_norm": _norm_spec(cfg),
        "layers": M.stack_specs(_dense_layer_spec(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = L.unembed_spec(cfg.vocab_padded, cfg.d_model,
                                         dtype)
    return spec


def init(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` on ``device``; raises if
    ``device`` is CUDA and there is no GPU."""
    return M.init_params(model_spec(cfg), seed=seed, device=device)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return M.map_tree(lambda a: a[i], stacked)


# ======================================================================
# prefill: tokens -> final hidden states (+ the per-layer KV)
# ======================================================================

def _attn_delta(cfg, ap, h, positions, *, residual=None):
    """h already normed.  Returns (residual + attn(h) if residual is
    given else attn(h), (k, v)) for cache building."""
    q, k, v = A.qkv_proj(ap, h, positions, cfg.rope_theta, cfg)
    o = D.dispatch("attention", cfg, q, k, v, causal=True,
                   q_positions=positions, kv_positions=positions,
                   block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    return A.o_proj(ap, o, cfg, residual=residual), (k, v)


def _dense_body(cfg, positions, x, lp):
    x, kv = _attn_delta(cfg, lp["attn"], _norm(cfg, lp["attn_norm"], x),
                        positions, residual=x)
    x = L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
              backend=cfg, residual=x)
    return x, kv


class ForwardOut(NamedTuple):
    h: torch.Tensor          # (B, S, D) final hidden (post-norm)
    caches: Any              # (k, v) stacks (L, B, S, KV, Dh) or None


def backbone(params, tokens, cfg, *, collect_cache=False) -> ForwardOut:
    """tokens: (B, S) int.  ``collect_cache=True`` (prefill) also
    returns the per-layer KV stacks."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens).to(L.dt(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _dense_body(cfg, positions, x,
                                _layer(params["layers"], i))
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, params["final_norm"], x)
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return ForwardOut(h=x, caches=caches)


def _logits(params, h, cfg):
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].T
    else:
        logits = L.unembed(params["unembed"], h)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits.float()).to(logits.dtype)
    return logits


def prefill(params, batch, cfg):
    """Full-sequence prefill: returns (last-token logits (B, V) fp32,
    (k, v) stacks); ``engine.pad_cache_from_prefill`` pads the stacks
    into a fixed-size decode cache."""
    out = backbone(params, batch["tokens"], cfg, collect_cache=True)
    logits = _logits(params, out.h[:, -1:, :], cfg)[:, 0]
    return logits.float(), out.caches


# ======================================================================
# decode
# ======================================================================

def cache_spec(cfg, batch: int, max_len: int):
    """{name: (shape, dtype)} of the dense decode cache."""
    _check_family(cfg)
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": (sh, L.dt(cfg)), "v": (sh, L.dt(cfg))}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch,
                                                   max_len).items()}


def _rope1(x, rope):
    """x: (B, H, Dh) one token; rope: its (cos, sin) tables."""
    return L.rotate(x[:, None], *rope)[:, 0]


def _decode_attend(cfg, q, ck, cv, n_valid):
    return DD.decode_attend(q, ck, cv, n_valid, backend=cfg.kernel_impl,
                            seq_shard=(cfg.decode_shard == "seq"))


def _decode_gqa(cfg, lp, h, ck, cv, cur_len, rope):
    """h: (B, D) normed; ck/cv: (B, T, KV, Dh) this layer's cache, written
    in place at ``cur_len``; rope: the (cos, sin) tables of ``cur_len``.
    Returns the attention delta (B, D)."""
    # plain products, as in the JAX decode step (its einsums stay XLA)
    q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
    k = torch.einsum("bd,dhk->bhk", h, lp["wk"])
    v = torch.einsum("bd,dhk->bhk", h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if rope is not None:
        q, k = _rope1(q, rope), _rope1(k, rope)
    # in place, where the JAX step returns a new cache through
    # dynamic_update_slice: the engine owns the buffer and never reads
    # the old version again
    ck[:, cur_len] = k
    cv[:, cur_len] = v
    o = _decode_attend(cfg, q, ck, cv, cur_len + 1)
    return torch.einsum("bhk,hkd->bd", o, lp["wo"])


def _dense_decode_body(cfg, cur_len, rope, x, lp, ck, cv):
    h = _norm(cfg, lp["attn_norm"], x)
    x = x + _decode_gqa(cfg, lp["attn"], h, ck, cv, cur_len, rope)
    return x + L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
                     backend=cfg)


def decode_step(params, batch, cfg):
    """One-token serve step.  batch: ``token`` (B,), ``cur_len`` (host
    int: every slot at the same position), ``cache`` (updated in place).
    With a ``block_table`` in the batch (and per-slot ``cur_len``) the
    step runs over a paged cache instead: ``paged_decode_step``.

    Returns (logits (B, vocab_padded) fp32, cache)."""
    if "block_table" in batch:
        return paged_decode_step(params, batch, cfg)
    _check_family(cfg)
    cur = int(batch["cur_len"])
    cache = batch["cache"]
    x = L.embed(params["embed"], batch["token"]).to(L.dt(cfg))  # (B, D)
    # one set of rotary tables for every layer; torch.full fills on the
    # device (a tensor copied from a host scalar would sync the stream)
    rope = None
    if cfg.rope_theta:
        pos = torch.full((1,), cur, dtype=torch.float32, device=x.device)
        rope = L.rope_tables(pos, cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _dense_decode_body(cfg, cur, rope, x,
                               _layer(params["layers"], i),
                               cache["k"][i], cache["v"][i])
    h = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, h[:, None, :], cfg)[:, 0].float()
    return logits, cache


# ======================================================================
# paged decode (block tables + per-slot lengths)
# ======================================================================

class PagedStep(NamedTuple):
    """One paged step's metadata on the device, built on the host from
    the per-slot lengths and the block table and copied over at once."""
    token: torch.Tensor      # (B,) input token per slot
    pos: torch.Tensor        # (B,) rotary position = valid length
    table: torch.Tensor      # (B, W) physical page per logical page
    counts: torch.Tensor     # (B, W) valid keys per logical page
    act: torch.Tensor        # (A,) active slots (length > 0)
    pages: torch.Tensor      # (A,) page each active slot writes to
    offs: torch.Tensor       # (A,) offset in that page
    all_active: bool


def _to_host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _page_write_ids(table, lens, page_size):
    """Host side: (active slots, their write page, offset, per-slot valid
    counts after the write).  The JAX function sends an inactive slot
    (lens == 0) to page ``n_pages`` and drops the write; here inactive
    slots are left out of the write (an out-of-range index is a device
    fault on CUDA)."""
    act = np.flatnonzero(lens > 0)
    la = lens[act]
    pages = table[act, la // page_size]
    return act, pages, la % page_size, lens + (lens > 0)


def paged_step_meta(token, lens, table, page_size: int, device
                    ) -> PagedStep:
    """Build a paged step's metadata from host arrays — ``lens`` (B,),
    ``table`` (B, W), and ``token`` (B,) unless it is already on the
    device — with one host-to-device copy (asynchronous from pinned
    memory on CUDA, so the host does not wait for the device here)."""
    lens = _to_host(lens).astype(np.int32)
    table = _to_host(table).astype(np.int32)
    B, W = table.shape
    act, pages, offs, n_valid = _page_write_ids(table, lens, page_size)
    counts = DD._page_counts(n_valid, W, page_size)
    on_device = (isinstance(token, torch.Tensor)
                 and token.device.type == device.type)
    parts = [lens, act, pages, offs, table.ravel(), counts.ravel()]
    if not on_device:
        parts.append(_to_host(token))
    # each part padded to 4 int32, so every view starts 16-byte aligned
    # as the kernels take their operands
    sizes = [len(x) for x in parts]
    starts = np.cumsum([0] + [-(-n // 4) * 4 for n in sizes])
    buf = np.zeros(starts[-1], np.int32)
    for x, at in zip(parts, starts):
        buf[at:at + len(x)] = x
    buf = torch.from_numpy(buf)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    lens_d, act_d, pages_d, offs_d, tbl_d, cnt_d, *tok = [
        buf[at:at + n] for at, n in zip(starts, sizes)]
    return PagedStep(token=token if on_device else tok[0], pos=lens_d,
                     table=tbl_d.view(B, W), counts=cnt_d.view(B, W),
                     act=act_d, pages=pages_d, offs=offs_d,
                     all_active=len(act) == B)


def _decode_gqa_paged(cfg, lp, h, kp, vp, ks, vs, meta, rope):
    """h: (B, D) normed; kp/vp: this layer's (n_pages, ps, KV, Dh)
    pools, written in place at each active slot's position; ks/vs its
    (n_pages, KV) scales for int8 pools, else None.  Returns the
    attention delta (B, D)."""
    q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
    k = torch.einsum("bd,dhk->bhk", h, lp["wk"])
    v = torch.einsum("bd,dhk->bhk", h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if rope is not None:
        q, k = _rope1(q, rope), _rope1(k, rope)
    if not meta.all_active:
        k, v = k.index_select(0, meta.act), v.index_select(0, meta.act)
    if ks is not None:
        from repro_torch.engine.paged_cache import quantized_page_write
        quantized_page_write(kp, ks, meta.pages, meta.offs, k)
        quantized_page_write(vp, vs, meta.pages, meta.offs, v)
    else:
        kp[meta.pages, meta.offs] = k.to(kp.dtype)
        vp[meta.pages, meta.offs] = v.to(vp.dtype)
    o = DD.paged_decode_attend(q, kp, vp, meta.table, meta.counts,
                               k_scale=ks, v_scale=vs,
                               backend=cfg.kernel_impl)
    return torch.einsum("bhk,hkd->bd", o, lp["wo"])


def _dense_paged_body(cfg, meta, rope, x, lp, kp, vp, ks, vs):
    h = _norm(cfg, lp["attn_norm"], x)
    x = x + _decode_gqa_paged(cfg, lp["attn"], h, kp, vp, ks, vs, meta,
                              rope)
    return x + L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
                     backend=cfg)


def paged_decode_step(params, batch, cfg):
    """One-token serve step over a paged KV cache (dense family).

    batch: ``token`` (B,), ``cur_len`` (B,) per-slot valid positions and
    ``block_table`` (B, W) — host arrays (numpy or CPU tensors; the
    token may already be on the device) — and ``cache``
    (``engine.paged_cache`` pools, written in place).  Slots with
    cur_len == 0 are inactive: they write nothing, their attention is
    masked to zero and their logits are garbage the caller discards.
    Returns (logits (B, vocab_padded) fp32, cache)."""
    # engine modules import this one: keep the import lazy
    from repro_torch.engine.paged_cache import check_family
    check_family(cfg)
    if cfg.decode_shard == "seq":
        # before any pool write, so a caller that catches this keeps its
        # cache as it was
        raise NotImplementedError(DD._SEQ_SHARD)
    cache = batch["cache"]
    kpool, vpool = cache["k"], cache["v"]
    meta = paged_step_meta(batch["token"], batch["cur_len"],
                           batch["block_table"], kpool.shape[2],
                           kpool.device)
    x = L.embed(params["embed"], meta.token).to(L.dt(cfg))   # (B, D)
    rope = None
    if cfg.rope_theta:
        rope = L.rope_tables(meta.pos[:, None], cfg.d_head,
                             cfg.rope_theta)          # per-slot positions
    q8 = "k_scale" in cache
    for i in range(cfg.n_layers):
        x = _dense_paged_body(
            cfg, meta, rope, x, _layer(params["layers"], i), kpool[i],
            vpool[i], cache["k_scale"][i] if q8 else None,
            cache["v_scale"][i] if q8 else None)
    h = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, h[:, None, :], cfg)[:, 0].float()
    return logits, cache
