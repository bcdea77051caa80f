"""Model assembly for every served family: spec, train loss, prefill and
decode.

Counterpart of ``repro.models.lm`` for the dense family (tinyllama,
granite, qwen, deepseek-coder), the moe family (olmoe with GQA,
deepseek-v3 with MLA), the two frontend families: vlm (internvl2, a
dense decoder whose prompt opens with the projected frontend
embeddings) and audio (seamless-m4t, an encoder-decoder whose encoder
reads the projected frame embeddings), and the two recurrent families:
hybrid (zamba2, Mamba2 blocks with one shared attention + MLP block
after every ``attn_every`` of them) and ssm (xlstm, groups of mLSTM
blocks closed by one sLSTM block).  Conventions kept from the JAX
package:

  * pre-norm attention + MLP (or MoE FFN); the attention and MLP
    sub-blocks take the residual stream as ``residual=`` on prefill
    (fused into the kernel epilogue on the 'cuda' backend), while decode
    adds the FFN output outside (``x + mlp(...)``), as the JAX decode
    body does; the moe family runs its ``first_k_dense`` dense layers
    (``dense_layers``, FFN width ``d_ff_dense``) before its MoE layers
    (``layers``); either family's attention is MLA when ``cfg.mla`` is
    set;
  * vlm: ``frontend_proj`` of the (B, S_f, frontend_dim) embeddings is
    concatenated before the token embeddings and positions run over
    both; audio: the projected frames run through ``enc_layers``
    (non-causal attention, on the blockwise path as in the JAX package:
    the prefill kernel is causal only) and ``enc_norm``, and each
    decoder layer adds a cross-attention block over the encoder output
    (plain q / k / v products, the output projection on the kernels);
  * hybrid: the Mamba2 blocks (``models.ssm``, plain products) return
    their residual delta; the shared block is a dense GQA layer with one
    set of weights (``shared_attn``), so it runs kernels 1-3 on prefill
    and kernel 4 on decode; ssm: mLSTM / sLSTM blocks (``models.xlstm``)
    launch no kernel, and sLSTM blocks norm their own input;
  * parameters are stacked on a leading layer axis (the recurrent
    families' grouped stacks on two: (groups, blocks a group, ...)); the
    layers run as a Python loop over them;
  * the dense decode cache is ``{"k", "v"}`` of shape (L, B, T, KV, Dh),
    or ``{"ckv", "krope"}`` (L, B, T, r / rope) for MLA, nested as
    ``{"dense": ..., "moe": ...}`` for the moe family (``"dense"`` None
    without dense layers); the audio family's is ``{"self_k", "self_v",
    "cross_k", "cross_v"}``, the cross pair sized by the encoder length;
    the hybrid family's ``{"mamba_main": Mamba2State (n_main, k, B,
    ...), "mamba_tail": Mamba2State (tail, B, ...) or None, "attn_k",
    "attn_v": (n_invocations, B, T, KV, Dh)}`` and the ssm family's
    ``{"mlstm": MLSTMState (groups, m a group, B, ...), "slstm":
    SLSTMState (groups, B, D)}``, with the JAX package's field names,
    fp32 states and model-dtype conv tails, the stabilizers ``m`` at
    -1e30 in a fresh cache;
    the paged one holds pools of shape (L, n_pages, page_size, KV, Dh)
    or (L, n_pages, page_size, r / rope) (+ fp32 scales for int8 pools)
    in the same nesting, addressed through per-slot block tables
    (``paged_decode_step``); the audio family's cross pair stays
    slot-dense (L, slots, enc_p, KV, Dh) and is viewed as an
    identity-paged pool at attend time; the recurrent families have no
    paged cache (O(1) state a slot: nothing to page), as in the JAX
    package;
  * a prompt whose prefix is already in the pools (a prefix-cache hit,
    or the earlier chunks of a chunked prefill) prefills only its
    suffix against the prefix gathered back out of the pools
    (``prefill_suffix``, ``prefill_chunk``), on the blockwise
    formulation, so every suffix row equals the whole prompt's row for
    model-dtype pools (GQA, and MLA through ``mla_attention_suffix``).
    The moe family's suffix runs its MoE FFN over the suffix tokens
    alone, as in the JAX package: with capacity drops (capacity
    ``ceil(S * top_k * capacity_factor / n_experts)`` of the tokens in
    the call) a suffix's rows can differ from the whole prompt's.  The
    frontend families have no suffix path (their prompts open with
    frontend positions a token-keyed prefix cannot match).

Training (``train_loss``, ``ce_loss``) runs on the 'torch' backend only,
as the JAX package trains on 'xla': the kernels are forward-only.  Every
layer body runs through ``_maybe_remat`` (``cfg.remat``), which acts only
under autograd; the moe family's ``backbone`` returns the MoE aux losses
averaged over its MoE layers.

``cfg.kernel_impl`` selects the dispatch backend ('torch' | 'cuda' | 'auto').

Tensor-parallel serving: ``prefill``, ``decode_step`` and
``paged_decode_step`` take a ``layout`` (``dist.sharding.TPLayout``)
when the parameters are this rank's blocks under ``dist.sharding.
param_pspecs(cfg, mesh, 'serve')`` (``DecodeEngine`` cuts them and reads
the layout off the same spec tree).  The layout says which parts are
split: the vocab-parallel embedding and head (``layers.embed`` /
``unembed``), column- then row-parallel attention (the rank's query
heads, its kv heads where 'model' divides them, else all of them,
``_read_kv``) and MLP, and the expert-parallel MoE FFN
(``moe.moe_ffn``), each with its collectives over the layout's mesh.
Without a layout the parameters are whole and compute as on one device;
the caches and pools then hold the rank's kv heads, the layout of
``cache_pspecs`` / ``paged_cache_pspecs``.  The dense and moe families
with GQA attention serve this way.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common import module as M
from repro_torch.dist import decode as DD
from repro_torch.dist import sharding as SH
from repro_torch.kernels import dispatch as D
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def _check_family(cfg) -> None:
    """Every family of the JAX package is served; any other name raises
    as the JAX ``model_spec`` does."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


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

def _attn_spec(cfg):
    return MLA.mla_spec(cfg) if cfg.mla is not None else A.gqa_spec(cfg)


def _dense_layer_spec(cfg, d_ff=None):
    return {
        "attn_norm": _norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "mlp_norm": _norm_spec(cfg),
        "mlp": L.mlp_spec(cfg.d_model, d_ff or cfg.d_ff, cfg.act,
                          L.dt(cfg)),
    }


def _moe_layer_spec(cfg):
    return {
        "attn_norm": _norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "mlp_norm": _norm_spec(cfg),
        "moe": MOE.moe_spec(cfg),
    }


def _encoder_layer_spec(cfg):
    return {
        "attn_norm": _norm_spec(cfg),
        "attn": A.gqa_spec(cfg),
        "mlp_norm": _norm_spec(cfg),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, L.dt(cfg)),
    }


def _decoder_xattn_layer_spec(cfg):
    return {
        "self_norm": _norm_spec(cfg),
        "self": A.gqa_spec(cfg),
        "cross_norm": _norm_spec(cfg),
        "cross": A.gqa_spec(cfg),
        "mlp_norm": _norm_spec(cfg),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, L.dt(cfg)),
    }


def _hybrid_groups(cfg):
    """zamba2's layout: ``n_layers`` Mamba2 blocks in groups of
    ``attn_every``, the shared block after each group and after the tail
    of the remaining blocks.  Returns (k, n_main_groups, tail,
    shared-block invocations)."""
    k = cfg.mamba2.attn_every
    n_main = cfg.n_layers // k
    tail = cfg.n_layers - n_main * k
    return k, n_main, tail, n_main + (1 if tail else 0)


def _ssm_groups(cfg):
    """xlstm's layout: groups of (slstm_every - 1) mLSTM blocks and one
    sLSTM block.  Returns (mLSTM blocks a group, groups)."""
    k = cfg.xlstm.slstm_every
    if cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {k}")
    return k - 1, cfg.n_layers // k


def model_spec(cfg) -> Dict[str, Any]:
    _check_family(cfg)
    dtype = L.dt(cfg)
    spec: Dict[str, Any] = {
        "embed": L.embedding_spec(cfg.vocab_padded, cfg.d_model, dtype),
        "final_norm": _norm_spec(cfg),
    }
    if cfg.family == "hybrid":
        k, n_main, tail, _ = _hybrid_groups(cfg)
        spec["mamba_main"] = M.stack_specs(
            M.stack_specs(SSM.mamba2_spec(cfg), k), n_main)
        spec["mamba_norms"] = M.stack_specs(
            M.stack_specs(_norm_spec(cfg), k), n_main)
        if tail:
            spec["mamba_tail"] = M.stack_specs(SSM.mamba2_spec(cfg), tail)
            spec["tail_norms"] = M.stack_specs(_norm_spec(cfg), tail)
        # the JAX package's _shared_attn_block_spec: GQA attention + MLP
        spec["shared_attn"] = _encoder_layer_spec(cfg)
    elif cfg.family == "ssm":
        m_per, n_groups = _ssm_groups(cfg)
        spec["mlstm"] = M.stack_specs(
            M.stack_specs(XL.mlstm_spec(cfg), m_per), n_groups)
        spec["mlstm_norms"] = M.stack_specs(
            M.stack_specs(_norm_spec(cfg), m_per), n_groups)
        spec["slstm"] = M.stack_specs(XL.slstm_spec(cfg), n_groups)
    elif cfg.family == "moe":
        m = cfg.moe
        if m.first_k_dense:
            spec["dense_layers"] = M.stack_specs(
                _dense_layer_spec(cfg, d_ff=m.d_ff_dense or cfg.d_ff),
                m.first_k_dense)
        spec["layers"] = M.stack_specs(_moe_layer_spec(cfg),
                                       cfg.n_layers - m.first_k_dense)
    elif cfg.family == "audio":
        spec["enc_layers"] = M.stack_specs(_encoder_layer_spec(cfg),
                                           cfg.enc_layers)
        spec["enc_norm"] = _norm_spec(cfg)
        spec["layers"] = M.stack_specs(_decoder_xattn_layer_spec(cfg),
                                       cfg.n_layers)
    else:
        spec["layers"] = M.stack_specs(_dense_layer_spec(cfg),
                                       cfg.n_layers)
    if not cfg.tie_embeddings:
        spec["unembed"] = L.unembed_spec(cfg.vocab_padded, cfg.d_model,
                                         dtype)
    if cfg.frontend:
        spec["frontend"] = L.frontend_proj_spec(cfg.frontend_dim,
                                                cfg.d_model, dtype)
    return spec


def init(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` on ``device``; raises if
    ``device`` is CUDA and there is no GPU."""
    return M.init_params(model_spec(cfg), seed=seed, device=device)


# ======================================================================
# remat
# ======================================================================

# the products whose outputs "dots" keeps: those with no batch dims (the
# JAX package's dots_with_no_batch_dims_saveable); batched einsums
# (bmm) are recomputed with everything else
_DOTS_SAVEABLE = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _requires_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_requires_grad(v) for v in tree)
    return False


def _maybe_remat(cfg, fn):
    """A layer body under ``cfg.remat``: "none" runs it as is, "full"
    through ``torch.utils.checkpoint`` (its activations recomputed in the
    backward), "dots" the same keeping the products with no batch dims.
    It checkpoints only when grad is enabled and an argument requires
    grad, so serving runs the body itself."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS_SAVEABLE)

    def body(*args):
        if not (torch.is_grad_enabled() and _requires_grad(args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return body


def _on(layout, part: str):
    """The mesh ``part`` of the model is split over under ``layout``
    (``dist.sharding.TPLayout.on``), or None: whole parameters, the
    one-device computation."""
    return None if layout is None else layout.on(part)


def _read_kv(cfg, layout, hl: int, *pairs):
    """The kv heads this rank's ``hl`` query heads read, from each
    (tensor, kv dim) pair (keys, values, their int8 scales; None passes):
    the tensors as they are unless ``layout`` splits the query heads
    while the kv heads stay whole ('model' does not divide them), then
    their heads by ``attention.kv_for_heads``."""
    tp = _on(layout, "heads")
    if tp is None or layout.kv:
        return tuple(t for t, _ in pairs)
    index = A.kv_for_heads(cfg.n_heads, cfg.n_kv_heads,
                           tp.coord("model") * hl, hl)
    return tuple(None if t is None else A.take_heads(t, index, d)
                 for t, d in pairs)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters (or cache): views into the stacks."""
    return M.map_tree(lambda a: a[i], stacked)


def _depth(stacked) -> int:
    return next(M.leaves(stacked))[1].shape[0]


def _stack_states(states):
    """NamedTuple states -> one state of the same type, each field
    stacked along a new leading axis."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


def _state_at(state, *index):
    """A stacked state's entry at ``index``: views into its fields."""
    return type(state)(*(f[index] for f in state))


def _write_state(dst, src) -> None:
    """``src``'s fields into ``dst``'s tensors, in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _groups(cfg, params):
    """The layer stacks in order: (stacked parameters, the key of their
    cache group (None: the whole cache), whether the FFN is the MoE)."""
    if cfg.family != "moe":
        return [(params["layers"], None, False)]
    groups = [(params["layers"], "moe", True)]
    if cfg.moe.first_k_dense:
        groups.insert(0, (params["dense_layers"], "dense", False))
    return groups


def _cache_group(cache, key):
    return cache if key is None else cache[key]


def _kv_names(cfg):
    """A cache group's two leaves: the latent and rope caches for MLA,
    K and V otherwise."""
    return ("ckv", "krope") if cfg.mla is not None else ("k", "v")


def pool_leaf(cfg, cache):
    """The cache leaf whose shape gives the pages and page size of a
    paged cache: the latent pool for MLA, the K pool otherwise (in the
    moe group for the moe family, the self-attention pool for audio)."""
    if cfg.family == "audio":
        return cache["self_k"]
    return _cache_group(cache, "moe" if cfg.family == "moe" else None)[
        _kv_names(cfg)[0]]


def _run_groups(cfg, params, x, layer, collect):
    """Every layer group in order (``_groups``): ``layer(x, lp, key, i,
    moe) -> (x, cache pair)`` for layer ``i`` of the group whose cache
    key is ``key``.  Returns (x, None or the cache stacks of ``backbone``:
    one group's (L, ...) pair, or for the moe family (dense layers'
    pair or None, MoE layers'))."""
    stacks = {}
    for stacked, key, moe in _groups(cfg, params):
        ks, vs = [], []
        for i in range(_depth(stacked)):
            x, (k, v) = layer(x, _layer(stacked, i), key, i, moe)
            if collect:
                ks.append(k)
                vs.append(v)
        if collect:
            stacks[key] = (torch.stack(ks), torch.stack(vs))
    if not collect:
        return x, None
    return x, ((stacks.get("dense"), stacks["moe"])
               if cfg.family == "moe" else stacks[None])


# ======================================================================
# prefill: tokens -> final hidden states (+ the per-layer KV)
# ======================================================================

def _attn_delta(cfg, ap, h, positions, *, causal=True, residual=None,
                layout=None):
    """h already normed.  Returns (residual + attn(h) if residual is
    given else attn(h), (k, v)) for cache building — (c_kv, k_rope) for
    MLA, whose prefill is the expanded form on the blockwise path.  The
    'cuda' attention op runs the prefill kernel for causal calls and the
    blockwise formulation for the non-causal (encoder) ones.  Under a
    ``layout`` that splits the heads, (k, v) are the rank's kv heads (all
    of them where 'model' does not divide them)."""
    if cfg.mla is not None:
        out, kv = MLA.mla_attention(ap, h, positions, cfg,
                                    dense=cfg.accounting)
        return (out if residual is None else residual + out), kv
    q, k, v = A.qkv_proj(ap, h, positions, cfg.rope_theta, cfg)
    kr, vr = _read_kv(cfg, layout, q.shape[2], (k, 2), (v, 2))
    o = D.dispatch("attention", cfg, q, kr, vr, causal=causal,
                   q_positions=positions, kv_positions=positions,
                   block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    return A.o_proj(ap, o, cfg, residual=residual,
                    mesh=_on(layout, "heads")), (k, v)


def _dense_body(cfg, positions, x, lp, *, causal=True, layout=None):
    x, kv = _attn_delta(cfg, lp["attn"], _norm(cfg, lp["attn_norm"], x),
                        positions, causal=causal, residual=x, layout=layout)
    x = L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
              backend=cfg, residual=x, mesh=_on(layout, "ffn"))
    return x, kv


def _moe_rows(cfg, p, h, mesh, layout, stats=False):
    """``moe.moe_ffn`` of this rank's prefill rows h (B, S, D), a group a
    row.  Experts split over every axis (``layout``) need every rank to
    hold the same groups: rows split over ``mesh``'s 'data' axis are
    gathered first and this rank's taken back out of y."""
    if _on(layout, "experts") is None or mesh is None \
            or mesh.axis_size("data") == 1:
        return MOE.moe_ffn(p, h, cfg, stats=stats, layout=layout)
    out = MOE.moe_ffn(p, mesh.all_gather(h, "data", 0), cfg, stats=stats,
                      layout=layout)
    b = h.shape[0]
    b0 = mesh.coord("data") * b
    return (out[0][b0:b0 + b], *out[1:])


def _moe_body(cfg, positions, x, lp, mesh=None, layout=None):
    """Returns (x, (k, v), the MoE FFN's aux losses and its load
    statistics ``me`` / ``ce``)."""
    x, kv = _attn_delta(cfg, lp["attn"], _norm(cfg, lp["attn_norm"], x),
                        positions, residual=x, layout=layout)
    y, aux, (me, ce) = _moe_rows(cfg, lp["moe"],
                                 _norm(cfg, lp["mlp_norm"], x), mesh,
                                 layout, stats=True)
    return x + y, kv, {**aux, "me": me, "ce": ce}


def _xattn_body(cfg, positions, enc, enc_valid, x, lp):
    """Encoder-decoder decoder layer (prefill): causal self-attention,
    cross-attention over the encoder output ``enc`` (B, S_enc, d) — its
    q / k / v plain products and its attention the blockwise formulation,
    as in the JAX package; the output projection on the kernels with the
    residual fused — then the MLP.  Returns (x, ((k, v), (xk, xv)))."""
    x, kv = _attn_delta(cfg, lp["self"], _norm(cfg, lp["self_norm"], x),
                        positions, residual=x)
    h = _norm(cfg, lp["cross_norm"], x)
    cp = lp["cross"]
    q = torch.einsum("bsd,dhk->bshk", h, cp["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc, cp["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, cp["wv"])
    if cfg.accounting:
        o = A.full_attn_ref(q, k, v, causal=False, kv_valid=enc_valid)
    else:
        o = A.blockwise_attn(q, k, v, causal=False, kv_valid=enc_valid,
                             block_q=cfg.attn_block_q,
                             block_kv=cfg.attn_block_kv)
    x = A.o_proj(cp, o, cfg, residual=x)
    x = L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
              backend=cfg, residual=x)
    return x, (kv, (k, v))


def encode(params, frontend_emb, cfg):
    """The audio encoder: the projected frames (B, S_enc, frontend_dim)
    through ``enc_layers`` (non-causal) and ``enc_norm``.  Returns
    (B, S_enc, d_model) in the model dtype."""
    enc = L.frontend_proj(params["frontend"], frontend_emb).to(L.dt(cfg))
    pos = torch.arange(enc.shape[1], device=enc.device)
    body = _maybe_remat(cfg, functools.partial(_dense_body, cfg, pos,
                                               causal=False))
    stacked = params["enc_layers"]
    for i in range(_depth(stacked)):
        enc, _ = body(enc, _layer(stacked, i))
    return _norm(cfg, params["enc_norm"], enc)


def _hybrid_backbone(params, x, cfg):
    """zamba2: each group of Mamba2 blocks, then the shared block (a
    dense layer: the JAX package's ``_shared_attn_apply`` is its dense
    body), over the groups and the tail.  Returns (x, ((main states
    (n_main, k, B, ...), main (k, v) (n_main, B, S, KV, Dh)), (tail
    states (tail, B, ...), tail (k, v) (B, S, KV, Dh)) or (None, None)))."""
    k, n_main, tail, _ = _hybrid_groups(cfg)
    sp = params["shared_attn"]
    positions = torch.arange(x.shape[1], device=x.device)

    def mamba_body(x, lp, norm):
        d, st = SSM.mamba2_forward(lp, _norm(cfg, norm, x), cfg)
        return x + d, st
    mamba_body = _maybe_remat(cfg, mamba_body)

    def mambas(x, stacked, norms, n):
        sts = []
        for i in range(n):
            x, st = mamba_body(x, _layer(stacked, i), _layer(norms, i))
            sts.append(st)
        x, kv = _dense_body(cfg, positions, x, sp)
        return x, _stack_states(sts), kv
    # each main group is one remat body, its Mamba2 blocks nested ones
    # (JAX scans and remats both); the tail's blocks are rematted one by
    # one and its shared block not at all, as in JAX
    group_body = _maybe_remat(cfg, mambas)

    sts, kvs = [], []
    for g in range(n_main):
        x, st, kv = group_body(x, _layer(params["mamba_main"], g),
                               _layer(params["mamba_norms"], g), k)
        sts.append(st)
        kvs.append(kv)
    main = (_stack_states(sts), tuple(torch.stack(t) for t in zip(*kvs)))
    tail_out = (None, None)
    if tail:
        x, st, kv = mambas(x, params["mamba_tail"], params["tail_norms"],
                           tail)
        tail_out = (st, kv)
    return x, (main, tail_out)


def _ssm_backbone(params, x, cfg):
    """xlstm: each group's mLSTM blocks (pre-normed, residual delta), then
    its sLSTM block (which norms its own input).  Returns (x, (mLSTM
    states (groups, m a group, B, ...), sLSTM states (groups, B, D)))."""
    m_per, n_groups = _ssm_groups(cfg)

    def ml_body(x, lp, norm):
        d, st = XL.mlstm_forward(lp, _norm(cfg, norm, x), cfg)
        return x + d, st
    ml_body = _maybe_remat(cfg, ml_body)

    def group_body(x, gp, gn, sp):
        sts = []
        for i in range(m_per):
            x, st = ml_body(x, _layer(gp, i), _layer(gn, i))
            sts.append(st)
        d, s_st = XL.slstm_forward(sp, x, cfg)
        return x + d, _stack_states(sts), s_st
    group_body = _maybe_remat(cfg, group_body)

    m_sts, s_sts = [], []
    for g in range(n_groups):
        x, m_st, s_st = group_body(x, _layer(params["mlstm"], g),
                                   _layer(params["mlstm_norms"], g),
                                   _layer(params["slstm"], g))
        m_sts.append(m_st)
        s_sts.append(s_st)
    return x, (_stack_states(m_sts), _stack_states(s_sts))


class ForwardOut(NamedTuple):
    h: torch.Tensor          # (B, S, D) final hidden (post-norm)
    aux: Dict[str, torch.Tensor]   # scalar aux metrics (moe losses)
    caches: Any              # KV stacks (see ``backbone``) or None
    # moe family: (me, ce), each (L_moe, E), the per-layer means that
    # ``lb_loss`` multiplies (``moe.moe_ffn(stats=True)``)
    moe_stats: Any = None


def backbone(params, tokens, cfg, *, frontend_emb=None,
             enc_tokens_valid=None, collect_cache=False,
             mesh=None, layout=None) -> ForwardOut:
    """tokens: (B, S) int; frontend_emb: (B, S_f, frontend_dim) or None —
    for 'vlm' projected and put before the token embeddings (the
    sequence is S_f + S), for 'audio' the encoder's input (the tokens
    are the decoder's; ``enc_tokens_valid`` (S_f,) bool masks encoder
    padding).  ``collect_cache=True`` (prefill) also returns the
    per-layer cache stacks: (k, v) (L, B, S, KV, Dh), or (c_kv, k_rope)
    (L, B, S, r / rope) for MLA; for the moe family the pair (dense
    layers' stacks or None, MoE layers' stacks); for audio the pair
    (self (k, v), cross (xk, xv) (L, B, S_f, KV, Dh)); for the recurrent
    families the final states (``_hybrid_backbone``, ``_ssm_backbone``),
    which are returned whether or not ``collect_cache`` is set.

    ``aux``: for the moe family ``lb_loss``, ``z_loss_router`` and
    ``drop_frac``, each the mean over the MoE layers; empty otherwise.
    Every layer body runs through ``_maybe_remat``.  ``mesh``: the
    layout of this rank's rows; ``layout``: of its parameters (the module
    docstring; the dense and moe families), whose caches are then the
    rank's kv heads."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens,
                _on(layout, "vocab")).to(L.dt(cfg))
    if ssm_decode_supported(cfg):
        x, caches = (_ssm_backbone if cfg.family == "ssm"
                     else _hybrid_backbone)(params, x, cfg)
        return ForwardOut(h=_norm(cfg, params["final_norm"], x), aux={},
                          caches=caches)
    if frontend_emb is not None:
        frontend_emb = torch.as_tensor(frontend_emb, device=x.device)
    if cfg.family == "vlm":
        pre = L.frontend_proj(params["frontend"], frontend_emb)
        x = torch.cat([pre.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "audio":
        enc = encode(params, frontend_emb, cfg)
        if enc_tokens_valid is not None:
            enc_tokens_valid = torch.as_tensor(enc_tokens_valid,
                                               device=x.device)
        body = _maybe_remat(cfg, functools.partial(
            _xattn_body, cfg, positions, enc, enc_tokens_valid))
        stacked, out = params["layers"], []
        for i in range(_depth(stacked)):
            x, kvs = body(x, _layer(stacked, i))
            if collect_cache:
                out.append(kvs)
        caches = None
        if collect_cache:
            caches = tuple(tuple(torch.stack([o[j][t] for o in out])
                                 for t in range(2)) for j in range(2))
        return ForwardOut(h=_norm(cfg, params["final_norm"], x), aux={},
                          caches=caches)

    dense_body = _maybe_remat(cfg, functools.partial(
        _dense_body, cfg, positions, layout=layout))
    moe_body = _maybe_remat(cfg, functools.partial(
        _moe_body, cfg, positions, mesh=mesh, layout=layout))
    moe_aux = []

    def layer(x, lp, key, i, moe):
        if not moe:
            return dense_body(x, lp)
        x, kv, aux = moe_body(x, lp)
        moe_aux.append(aux)
        return x, kv

    x, caches = _run_groups(cfg, params, x, layer, collect_cache)
    aux, stats = {}, None
    if moe_aux:
        # the JAX package's means over the scanned MoE layers' aux
        for name, key in (("lb_loss", "lb_loss"),
                          ("z_loss_router", "z_loss"),
                          ("drop_frac", "drop_frac")):
            aux[name] = torch.stack([a[key] for a in moe_aux]).mean()
        stats = tuple(torch.stack([a[k] for a in moe_aux])
                      for k in ("me", "ce"))
    return ForwardOut(h=_norm(cfg, params["final_norm"], x), aux=aux,
                      caches=caches, moe_stats=stats)


def _logits(params, h, cfg, layout=None):
    """The logits of h over the whole (padded) vocab; under a ``layout``
    that splits the vocab, the blocks gathered first."""
    tp = _on(layout, "vocab")
    if cfg.tie_embeddings:
        logits = L.unembed({"w": params["embed"]["table"].T}, h, tp)
    else:
        logits = L.unembed(params["unembed"], h, tp)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits.float()).to(logits.dtype)
    return logits


# ======================================================================
# loss
# ======================================================================

def ce_sums(params, h, labels, mask, cfg):
    """Cross-entropy over (B, S, D) hiddens, in chunks of
    ``cfg.logits_chunk`` positions (0: the whole sequence; a ragged tail
    is padded with masked positions).  The label logit is picked by a
    masked sum over the vocab, as in the JAX package.  Returns the sums
    over the masked positions of the loss and of the squared log-sum-exp
    (the z-loss), not yet divided by the mask count."""
    B, S, _ = h.shape
    C = min(cfg.logits_chunk or S, S)
    pad = (-S) % C
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    nchunk = h.shape[1] // C

    def one_chunk(hc, lc, mc):
        logits = _logits(params, hc, cfg).float()
        lz = torch.logsumexp(logits, -1)                     # (B, C)
        hit = (torch.arange(logits.shape[-1], device=logits.device)
               == lc[..., None])
        ll = torch.where(hit, logits, 0.0).sum(-1)
        return ((lz - ll) * mc).sum(), ((lz * lz) * mc).sum()

    if nchunk == 1:
        return one_chunk(h, labels, mask)
    loss_sum = z_sum = torch.zeros((), device=h.device)
    for i in range(nchunk):
        sl = slice(i * C, (i + 1) * C)
        a, b = one_chunk(h[:, sl], labels[:, sl], mask[:, sl])
        loss_sum, z_sum = loss_sum + a, z_sum + b
    return loss_sum, z_sum


def ce_loss(params, h, labels, mask, cfg):
    """``ce_sums`` divided by the mask count (at least 1): (loss,
    {"z_loss"})."""
    loss_sum, z_sum = ce_sums(params, h, labels, mask, cfg)
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss_sum / denom, {"z_loss": z_sum / denom}


def train_parts(params, batch, cfg):
    """The pieces of ``train_loss`` before any normalisation: a dict of
    ``ce_sum`` / ``z_sum`` (``ce_sums``), ``mask`` (the loss mask on the
    device), ``aux`` (``backbone``'s) and ``moe_stats`` (``ForwardOut``).
    A data-parallel step (``launch.steps``) divides them by the global
    batch's counts instead of this batch's.  Training runs on a
    differentiable backend only (``dispatch.training_backend``: a
    'cuda' pin raises)."""
    cfg = cfg.replace(kernel_impl=D.training_backend(cfg))
    dev = params["embed"]["table"].device
    out = backbone(params, torch.as_tensor(batch["tokens"], device=dev),
                   cfg, frontend_emb=batch.get("frontend_emb"))
    labels = torch.as_tensor(batch["labels"], device=dev)
    mask = torch.as_tensor(batch["loss_mask"], device=dev).float()
    h = out.h
    if cfg.family == "vlm":
        # the hidden sequence is the frontend prefix + the text: the loss
        # is taken on the text part only
        h = h[:, batch["frontend_emb"].shape[1]:]
    ce_sum, z_sum = ce_sums(params, h, labels, mask, cfg)
    return {"ce_sum": ce_sum, "z_sum": z_sum, "mask": mask,
            "aux": out.aux, "moe_stats": out.moe_stats}


def train_loss(params, batch, cfg):
    """batch: ``tokens`` (B, S), ``labels`` (B, S), ``loss_mask`` (B, S)
    [+ ``frontend_emb``], numpy arrays or tensors.  Returns (loss,
    metrics {"ce", "z_loss", moe aux..., "loss"}): the parts of
    ``train_parts`` divided by this batch's mask count."""
    parts = train_parts(params, batch, cfg)
    denom = torch.clamp(parts["mask"].sum(), min=1.0)
    loss, z_loss = parts["ce_sum"] / denom, parts["z_sum"] / denom
    aux = parts["aux"]
    metrics = {"ce": loss, "z_loss": z_loss, **aux}
    total = loss + cfg.z_loss_coef * z_loss
    if "lb_loss" in aux:
        total = (total + cfg.lb_coef * aux["lb_loss"]
                 + cfg.router_z_coef * aux["z_loss_router"])
    metrics["loss"] = total
    return total, metrics


def prefill(params, batch, cfg, mesh=None, layout=None):
    """Full-sequence prefill of ``batch["tokens"]`` (+ ``frontend_emb``
    for the frontend families): returns (last-token logits (B, V) fp32,
    the cache stacks of ``backbone``); ``engine.pad_cache_from_prefill``
    pads them into a fixed-size decode cache.  ``mesh`` / ``layout``: of
    this rank's rows and parameters (``backbone``)."""
    out = backbone(params, batch["tokens"], cfg,
                   frontend_emb=batch.get("frontend_emb"),
                   collect_cache=True, mesh=mesh, layout=layout)
    logits = _logits(params, out.h[:, -1:, :], cfg, layout)[:, 0]
    return logits.float(), out.caches


# ======================================================================
# suffix-only prefill (prefix cache) and chunked prefill
# ======================================================================

def _gather_prefix_kv(group, names, pages):
    """The matched prefix pages gathered back out of one layer group's
    pools ``names`` into prefill-cache-shaped (L, 1, M, ...) stacks (M =
    len(pages) * page_size); int8 pools are dequantized in fp32 through
    their scales: one a (page, KV head) for K/V pools, (L, J, KV), one a
    page for the latent and rope pools, (L, J).  For model-dtype pools
    the rows are exactly what the original prefill wrote."""
    out = []
    for name in names:
        g = group[name][:, pages]                 # (L, J, ps, ...)
        if name + "_scale" in group:
            s = group[name + "_scale"][:, pages]
            s = (s[:, :, None, :, None] if g.ndim == 5
                 else s[:, :, None, None])
            g = g.float() * s
        L_, J, ps = g.shape[:3]
        out.append(g.reshape(L_, 1, J * ps, *g.shape[3:]))
    return tuple(out)


def _suffix_attn_delta(cfg, ap, h, q_pos, kv_pos, prefix, *,
                       residual=None):
    """Attention step of the suffix body: queries at global positions
    ``q_pos`` over concat(prefix K/V from the pools, the suffix K/V
    computed here).  It calls the blockwise formulation itself, never the
    ``attention`` registry op: the kernel has no positional offset, and
    the streaming kv loop sees the same kv length and block boundaries
    as the whole-prompt prefill, so each suffix row is the whole
    prompt's row (as in the JAX package, whose suffix path also stays
    off its prefill kernel).  MLA rebuilds its keys and values from the
    prefix latents (``mla_attention_suffix``)."""
    if cfg.mla is not None:
        out, kv = MLA.mla_attention_suffix(ap, h, q_pos, kv_pos, cfg,
                                           *prefix)
        return (out if residual is None else residual + out), kv
    pk, pv = prefix
    q, k, v = A.qkv_proj(ap, h, q_pos, cfg.rope_theta, cfg)
    k_all = torch.cat([pk.to(k.dtype), k], dim=1)
    v_all = torch.cat([pv.to(v.dtype), v], dim=1)
    if cfg.accounting:
        o = A.full_attn_ref(q, k_all, v_all, causal=True,
                            q_positions=q_pos, kv_positions=kv_pos)
    else:
        o = A.blockwise_attn(q, k_all, v_all, causal=True,
                             q_positions=q_pos, kv_positions=kv_pos,
                             block_q=cfg.attn_block_q,
                             block_kv=cfg.attn_block_kv)
    return A.o_proj(ap, o, cfg, residual=residual), (k, v)


def _dense_suffix_body(cfg, q_pos, kv_pos, x, lp, prefix):
    x, kv = _suffix_attn_delta(cfg, lp["attn"],
                               _norm(cfg, lp["attn_norm"], x), q_pos,
                               kv_pos, prefix, residual=x)
    x = L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
              backend=cfg, residual=x)
    return x, kv


def _moe_suffix_body(cfg, q_pos, kv_pos, x, lp, prefix):
    x, kv = _suffix_attn_delta(cfg, lp["attn"],
                               _norm(cfg, lp["attn_norm"], x), q_pos,
                               kv_pos, prefix, residual=x)
    y, _aux = MOE.moe_ffn(lp["moe"], _norm(cfg, lp["mlp_norm"], x), cfg)
    return x + y, kv


def prefill_suffix(params, batch, cfg):
    """Prefill only the SUFFIX of a prompt whose prefix is already in the
    page pools (a prefix-cache hit).

    batch: ``tokens`` (1, S) suffix tokens; ``pages`` (J_m,) the matched
    physical page ids (whole pages, prefix order; host ints or a device
    tensor); ``cache`` the live pools the prefix is read from.  The
    prefix length M = J_m * page_size comes from the shape of ``pages``.

    Returns (last-token logits (1, vocab_padded) fp32, the suffix's cache
    stacks in ``prefill``'s layout (GQA (k, v) (L, 1, S, KV, Dh), MLA
    (c_kv, k_rope); for the moe family the pair (dense layers' stacks or
    None, MoE layers'))) as ``prefill`` restricted to positions [M, M+S):
    they scatter into the slot's pages from page J_m on (the suffix
    starts page-aligned).  Each layer group reads its prefix out of its
    own pools.  The token-only families: frontend families prepend
    positions a token-keyed prefix cannot match."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"prefill_suffix supports the token-only families ('dense', "
            f"'moe'); family {cfg.family!r} prepends frontend positions "
            "that a token-keyed prefix index cannot match")
    _check_family(cfg)
    cache = batch["cache"]
    leaf = pool_leaf(cfg, cache)
    dev = leaf.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    pages = torch.as_tensor(batch["pages"], device=dev).long()
    M = pages.shape[0] * leaf.shape[2]
    S = tokens.shape[1]
    q_pos = torch.arange(S, device=dev) + M
    kv_pos = torch.arange(M + S, device=dev)
    x = L.embed(params["embed"], tokens).to(L.dt(cfg))
    prefix = {key: _gather_prefix_kv(_cache_group(cache, key),
                                     _kv_names(cfg), pages)
              for _, key, _ in _groups(cfg, params)}

    def layer(x, lp, key, i, moe):
        body = _moe_suffix_body if moe else _dense_suffix_body
        return body(cfg, q_pos, kv_pos, x, lp,
                    tuple(t[i] for t in prefix[key]))

    x, caches = _run_groups(cfg, params, x, layer, True)
    h = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, h[:, -1:, :], cfg)[:, 0]
    return logits.float(), caches


def prefill_chunk(params, batch, cfg):
    """One chunk of a chunked prefill: the chunk's K/V against everything
    already resident, scattered into its granted pages.

    batch: ``tokens`` (1, C) chunk tokens at global positions [M, M+C),
    M = len(pages) * page_size; ``pages`` (J_p,) ALL pages holding
    positions [0, M) in prefix order (prefix-cache pages, then earlier
    chunks' pages: every non-final chunk ends page-aligned, so the
    resident prefix is whole pages); ``write_pages`` (J_w,) the pages
    positions [M, M+C) land in; ``cache`` the live pools, written in
    place (quantize-on-write for int8 pools), so the next chunk reads
    this one back through the block table.

    The attention is ``prefill_suffix``'s: every chunk row, and the final
    chunk's last-token logits, equal the whole-prompt prefill's for
    model-dtype pools.  Returns (last-chunk-token logits (1,
    vocab_padded) fp32, cache)."""
    from repro_torch.engine.paged_cache import write_prefill
    cache = batch["cache"]
    logits, caches = prefill_suffix(
        params, {"tokens": batch["tokens"], "pages": batch["pages"],
                 "cache": cache}, cfg)
    write_prefill(cfg, cache, caches, batch["write_pages"][None])
    return logits, cache


# ======================================================================
# decode
# ======================================================================

def _group_spec(cfg, n: int, lead):
    """One cache group of ``n`` layers: (L, *lead, KV, Dh) K/V, or the
    (L, *lead, r) latent and (L, *lead, rope) rope caches for MLA."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": (n, *lead, m.kv_lora_rank),
                "krope": (n, *lead, m.rope_head_dim)}
    sh = (n, *lead, cfg.n_kv_heads, cfg.d_head)
    return {"k": sh, "v": sh}


def group_specs(cfg, lead):
    """The cache tree's shapes: one group, or for the moe family
    ``{"dense": group or None, "moe": group}``, or for the audio family
    its self-attention pair ``{"self_k", "self_v"}`` (the cross pair is
    sized by the encoder: ``cache_spec``, ``engine.paged_cache``).
    ``engine.paged_cache`` builds its pools on it with ``lead =
    (n_pages, page_size)``."""
    if cfg.family == "moe":
        m = cfg.moe
        return {"dense": (_group_spec(cfg, m.first_k_dense, lead)
                          if m.first_k_dense else None),
                "moe": _group_spec(cfg, cfg.n_layers - m.first_k_dense,
                                   lead)}
    g = _group_spec(cfg, cfg.n_layers, lead)
    if cfg.family == "audio":
        return {"self_k": g["k"], "self_v": g["v"]}
    return g


def cross_shape(cfg, batch: int, enc_len: int):
    """The audio cross cache's (L, batch, enc_len, KV, Dh)."""
    return (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.d_head)


def _is_state(v) -> bool:
    return isinstance(v, tuple) and hasattr(v, "_fields")


def map_groups(fn, tree):
    """``fn`` over a cache tree's leaves (a nested dict whose groups may be
    NamedTuple recurrent states, mapped field by field; None stays)."""
    def one(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return map_groups(fn, v)
        if _is_state(v):
            return type(v)(*(fn(f) for f in v))
        return fn(v)
    return {k: one(v) for k, v in tree.items()}


def _recurrent_spec(cfg, batch: int, max_len: int):
    """The recurrent families' cache tree of (shape, dtype) leaves: fp32
    states, conv tails and the shared block's K/V in the model dtype."""
    dtype, f32 = L.dt(cfg), torch.float32
    if cfg.family == "hybrid":
        mc = cfg.mamba2
        k, n_main, tail, n_inv = _hybrid_groups(cfg)
        _, H, P, _, N, d_xbc = SSM._dims(cfg)

        def mstate(*lead):
            return SSM.Mamba2State(
                ssm=((*lead, batch, H, N, P), f32),
                conv=((*lead, batch, mc.d_conv - 1, d_xbc), dtype))
        kv = ((n_inv, batch, max_len, cfg.n_kv_heads, cfg.d_head), dtype)
        return {"mamba_main": mstate(n_main, k),
                "mamba_tail": mstate(tail) if tail else None,
                "attn_k": kv, "attn_v": kv}
    m_per, n_groups = _ssm_groups(cfg)
    d_inner, H, P = XL._mlstm_dims(cfg)
    lead, D = (n_groups, m_per, batch), cfg.d_model
    s = ((n_groups, batch, D), f32)
    return {
        "mlstm": XL.MLSTMState(
            C=((*lead, H, P, P), f32), n=((*lead, H, P), f32),
            m=((*lead, H), f32),
            conv=((*lead, cfg.xlstm.conv1d_kernel - 1, d_inner), dtype)),
        "slstm": XL.SLSTMState(c=s, n=s, h=s, m=s)}


def cache_spec(cfg, batch: int, max_len: int, enc_len: int = 0):
    """{name: (shape, dtype)} of the dense decode cache (nested for the
    moe family; the audio family's cross pair holds ``enc_len`` encoder
    positions, ``max_len`` when 0; NamedTuple states for the recurrent
    families)."""
    _check_family(cfg)
    if ssm_decode_supported(cfg):
        return _recurrent_spec(cfg, batch, max_len)
    tree = group_specs(cfg, (batch, max_len))
    if cfg.family == "audio":
        xh = cross_shape(cfg, batch, enc_len or max_len)
        tree = {**tree, "cross_k": xh, "cross_v": xh}
    return map_groups(lambda sh: (sh, L.dt(cfg)), tree)


def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0,
               device="cuda"):
    cache = map_groups(
        lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device),
        cache_spec(cfg, batch, max_len, enc_len))
    if cfg.family == "ssm":
        # the mLSTM / sLSTM stabilizers start at -inf-ish
        cache["mlstm"].m.fill_(XL.M_START)
        cache["slstm"].m.fill_(XL.M_START)
    return cache


def _rope_dim(cfg) -> int:
    """The features a rotary table turns: MLA's rope part, else a head."""
    return cfg.mla.rope_head_dim if cfg.mla is not None else cfg.d_head


def _step_rope(cfg, positions):
    """One set of rotary tables for every layer of a step (None without
    rotary embeddings; MLA always rotates its rope features)."""
    if not cfg.rope_theta and cfg.mla is None:
        return None
    return L.rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)


def _rope1(x, rope):
    """x: (B, H, Dh) one token; rope: its (cos, sin) tables."""
    return L.rotate(x[:, None], *rope)[:, 0]


def _seq_mesh(cfg, mesh):
    """The mesh a step's cache is sequence-sharded over: ``mesh`` when
    ``cfg.decode_shard == 'seq'`` and it has a 'model' axis, else None
    (the local path; seq without a mesh is local, as in JAX)."""
    if cfg.decode_shard == "seq" and DD._routes(mesh, True):
        return mesh
    return None


def _slab_index(mesh, pos: int, T_local: int):
    """This rank's local index of global position ``pos`` of a cache
    sequence-sharded over ``mesh`` ('model'; None: the whole cache), or
    None when another rank's slab holds it."""
    t = pos - (SH.block_start(mesh, "model", T_local) if mesh is not None
               else 0)
    return t if 0 <= t < T_local else None


def _decode_attend(cfg, q, ck, cv, n_valid, mesh=None):
    return DD.decode_attend(q, ck, cv, n_valid, backend=cfg.kernel_impl,
                            mesh=mesh, seq_shard=mesh is not None)


def _decode_gqa(cfg, lp, h, ck, cv, cur_len, rope, mesh=None,
                layout=None):
    """h: (B, D) normed; ck/cv: (B, T, KV, Dh) this layer's cache, written
    in place at ``cur_len``; rope: the (cos, sin) tables of ``cur_len``.
    With ``mesh`` (``_seq_mesh``) ck / cv are this rank's slab, and only
    the rank that holds ``cur_len`` writes.  Under a ``layout`` that
    splits the heads the projections are the rank's heads, ck / cv its kv
    heads, and the output projection's partials are summed over 'model'.
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
    t = _slab_index(mesh, cur_len, ck.shape[1])
    if t is not None:
        ck[:, t] = k
        cv[:, t] = v
    kr, vr = _read_kv(cfg, layout, q.shape[1], (ck, 2), (cv, 2))
    o = _decode_attend(cfg, q, kr, vr, cur_len + 1, mesh)
    return L.row_parallel(torch.einsum("bhk,hkd->bd", o, lp["wo"]),
                          _on(layout, "heads"))


def _mla_token(cfg, lp, h, rope):
    """One token's MLA material: (q_abs (B, H, r) fp32, q_rope (B, H,
    rope) fp32, scale, c_kv (B, r), k_rope (B, rope))."""
    h3 = h[:, None, :]
    q_nope, q_rope = MLA.mla_queries(lp, h3, None, cfg, rope=rope)
    c_kv, k_rope = MLA.mla_latent(lp, h3, None, cfg, rope=rope)
    q_abs, q_rope, scale = MLA.mla_absorbed_queries(lp, q_nope[:, 0],
                                                    q_rope[:, 0], cfg)
    return q_abs, q_rope, scale, c_kv[:, 0], k_rope[:, 0]


def _decode_mla(cfg, lp, h, cckv, ckr, cur_len, rope, mesh=None):
    """Absorbed MLA decode.  cckv (B, T, r) / ckr (B, T, rope) this
    layer's latent and rope caches (this rank's slab under ``mesh``),
    written in place at ``cur_len``; the two ride separately into
    ``dist.decode.mla_decode_attend``.  Returns the attention delta
    (B, D)."""
    q_abs, q_rope, scale, c_kv, k_rope = _mla_token(cfg, lp, h, rope)
    t = _slab_index(mesh, cur_len, cckv.shape[1])
    if t is not None:
        cckv[:, t] = c_kv
        ckr[:, t] = k_rope
    o = DD.mla_decode_attend(q_abs, q_rope, cckv, ckr, cur_len + 1,
                             scale=scale, backend=cfg.kernel_impl,
                             mesh=mesh, seq_shard=mesh is not None)
    return MLA.mla_decode_finish(lp, o.float(), cfg).to(h.dtype)


def _decode_attn_delta(cfg, ap, h, cs, cur_len, rope, mesh=None,
                       layout=None):
    """Attention step of the dense-cache decode: MLA or GQA on this
    layer's cache slice ``cs``; ``mesh`` the seq mesh (``_seq_mesh``),
    ``layout`` the parameters' (``_decode_gqa``)."""
    if cfg.mla is not None:
        return _decode_mla(cfg, ap, h, cs["ckv"], cs["krope"], cur_len,
                           rope, mesh)
    return _decode_gqa(cfg, ap, h, cs["k"], cs["v"], cur_len, rope, mesh,
                       layout)


def _decode_cross(cfg, lp, h, xk, xv):
    """Cross-attention of one decode token against the (static) encoder
    cache xk / xv (B, T_enc, KV, Dh): every one of its T_enc positions is
    valid.  q and the output projection are plain products, as in the
    JAX step; the attention is the decode op (kernel 4 on 'cuda')."""
    q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
    o = _decode_attend(cfg, q, xk, xv, xk.shape[1])
    return torch.einsum("bhk,hkd->bd", o, lp["wo"])


def _audio_layer(cfg, lp, x, self_delta, cross_delta):
    """One encoder-decoder decoder layer of a decode step: ``self_delta``
    / ``cross_delta`` (attention params, normed h) -> delta, then the
    MLP, each added to the residual stream."""
    x = x + self_delta(lp["self"], _norm(cfg, lp["self_norm"], x))
    x = x + cross_delta(lp["cross"], _norm(cfg, lp["cross_norm"], x))
    return x + L.mlp(lp["mlp"], _norm(cfg, lp["mlp_norm"], x), cfg.act,
                     backend=cfg)


def _ffn_delta(cfg, lp, x, moe: bool, mesh=None, layout=None):
    """The decode FFN's delta: the MLP, or the MoE FFN over all B slots
    as one group, inactive slots included, as the JAX decode step groups
    them (a slot's capacity depends on its neighbours).  With the rows
    split over ``mesh``'s 'data' axis the MoE group is still the whole
    batch: the rows are gathered for it and this rank's taken back.  The
    parameters may be the rank's blocks under ``layout`` (``L.mlp``,
    ``moe.moe_ffn``)."""
    h = _norm(cfg, lp["mlp_norm"], x)
    if moe:
        if mesh is None or mesh.axis_size("data") == 1:
            return MOE.moe_ffn(lp["moe"], h[None], cfg,
                               layout=layout)[0][0]
        b0, b = mesh.coord("data") * h.shape[0], h.shape[0]
        y = MOE.moe_ffn(lp["moe"], mesh.all_gather(h, "data")[None],
                        cfg, layout=layout)[0][0]
        return y[b0:b0 + b]
    return L.mlp(lp["mlp"], h, cfg.act, backend=cfg,
                 mesh=_on(layout, "ffn"))


def _hybrid_decode(params, x, cache, cur, rope, cfg):
    """zamba2's decode: each Mamba2 block's ``mamba2_step`` on its state
    (written back into the cache in place), the shared block (a dense
    layer's decode, kernel 4 on 'cuda') after each group and after the
    tail on its invocation's K/V cache."""
    k, n_main, tail, _ = _hybrid_groups(cfg)
    sp = params["shared_attn"]

    def mambas(x, stacked, norms, states, n, inv):
        for i in range(n):
            st = _state_at(states, i)
            d, st1 = SSM.mamba2_step(_layer(stacked, i),
                                     _norm(cfg, _layer(norms, i), x), st,
                                     cfg)
            x = x + d
            _write_state(st, st1)
        h = _norm(cfg, sp["attn_norm"], x)
        x = x + _decode_gqa(cfg, sp["attn"], h, cache["attn_k"][inv],
                            cache["attn_v"][inv], cur, rope)
        return x + _ffn_delta(cfg, sp, x, False)

    for g in range(n_main):
        x = mambas(x, _layer(params["mamba_main"], g),
                   _layer(params["mamba_norms"], g),
                   _state_at(cache["mamba_main"], g), k, g)
    if tail:
        x = mambas(x, params["mamba_tail"], params["tail_norms"],
                   cache["mamba_tail"], tail, n_main)
    return x


def _ssm_decode(params, x, cache, cfg):
    """xlstm's decode: each group's ``mlstm_step``s, then its
    ``slstm_step``, every state written back into the cache in place."""
    m_per, n_groups = _ssm_groups(cfg)
    for g in range(n_groups):
        gp = _layer(params["mlstm"], g)
        gn = _layer(params["mlstm_norms"], g)
        for i in range(m_per):
            st = _state_at(cache["mlstm"], g, i)
            d, st1 = XL.mlstm_step(_layer(gp, i),
                                   _norm(cfg, _layer(gn, i), x), st, cfg)
            x = x + d
            _write_state(st, st1)
        st = _state_at(cache["slstm"], g)
        d, st1 = XL.slstm_step(_layer(params["slstm"], g), x, st, cfg)
        x = x + d
        _write_state(st, st1)
    return x


def ssm_decode_supported(cfg) -> bool:
    """Whether ``cfg``'s family decodes from recurrent state."""
    return cfg.family in ("hybrid", "ssm")


def decode_step(params, batch, cfg, mesh=None, layout=None):
    """One-token serve step.  batch: ``token`` (B,), ``cur_len`` (host
    int: every slot at the same position), ``cache`` (updated in place;
    the audio family's cross pair is read whole, as the encoder's; the
    recurrent families' states are overwritten with the next ones).
    With a ``block_table`` in the batch (and per-slot ``cur_len``) the
    step runs over a paged cache instead: ``paged_decode_step``.

    ``mesh`` (``launch.mesh.Mesh``; the dense and moe families) is the
    layout of this rank's operands: its rows of the batch when the
    mesh's 'data' axis has more than one rank, with
    ``cfg.decode_shard == 'seq'`` its slab of the cache's sequence over
    'model' (``dist.sharding.cache_pspecs``).  ``layout``
    (``dist.sharding.TPLayout``): the parameters are the rank's blocks
    and the cache its kv heads (the module docstring).  The logits of
    this rank's rows come out equal on every rank of the 'model' axis.

    Returns (logits (B, vocab_padded) fp32, cache)."""
    if "block_table" in batch:
        return paged_decode_step(params, batch, cfg, mesh=mesh,
                                 layout=layout)
    _check_family(cfg)
    smesh = _seq_mesh(cfg, mesh)
    cur = int(batch["cur_len"])
    cache = batch["cache"]
    x = L.embed(params["embed"], batch["token"],
                _on(layout, "vocab")).to(L.dt(cfg))  # (B, D)
    # torch.full fills on the device (a tensor copied from a host scalar
    # would sync the stream)
    rope = _step_rope(cfg, torch.full((1,), cur, dtype=torch.float32,
                                      device=x.device))
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cache, cur, rope, cfg)
    elif cfg.family == "ssm":
        x = _ssm_decode(params, x, cache, cfg)
    elif cfg.family == "audio":
        stacked = params["layers"]
        for i in range(_depth(stacked)):
            cs = _layer(cache, i)
            x = _audio_layer(
                cfg, _layer(stacked, i), x,
                lambda ap, h: _decode_gqa(cfg, ap, h, cs["self_k"],
                                          cs["self_v"], cur, rope),
                lambda cp, h: _decode_cross(cfg, cp, h, cs["cross_k"],
                                            cs["cross_v"]))
    else:
        for stacked, key, moe in _groups(cfg, params):
            group = _cache_group(cache, key)
            for i in range(_depth(stacked)):
                lp = _layer(stacked, i)
                h = _norm(cfg, lp["attn_norm"], x)
                x = x + _decode_attn_delta(cfg, lp["attn"], h,
                                           _layer(group, i), cur, rope,
                                           smesh, layout)
                x = x + _ffn_delta(cfg, lp, x, moe, mesh, layout)
    h = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, h[:, None, :], cfg, layout)[:, 0].float()
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
    extra: tuple = ()        # further int32 host arrays, on the device
    cross_counts: Any = None  # audio: (B, Jx) valid encoder keys a page


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


def paged_step_meta(token, lens, table, page_size: int, device,
                    extra=(), enc_lens=None, enc_pages: int = 0,
                    slab=None) -> PagedStep:
    """Build a paged step's metadata from host arrays — ``lens`` (B,),
    ``table`` (B, W), and ``token`` (B,) unless it is already on the
    device — with one host-to-device copy (asynchronous from pinned
    memory on CUDA, so the host does not wait for the device here).
    ``extra`` host int arrays (the mixed step's chunk tokens and pages)
    ride the same copy and come back as ``PagedStep.extra``; so do, for
    the audio family, the per-page counts of the encoder lengths
    ``enc_lens`` (B,) over the cross cache's ``enc_pages`` pages a slot
    (``PagedStep.cross_counts``).

    ``slab`` (p0, pp): the pools are a rank's pages [p0, p0 + pp) of a
    pool sharded over 'model'.  The table and counts are then the
    replicated ones as this rank sees them (``dist.decode.own_pages``:
    local ids, foreign pages at count 0) and the writes are the active
    slots' whose page this rank owns, at local ids."""
    lens = _to_host(lens).astype(np.int32)
    table = _to_host(table).astype(np.int32)
    B, W = table.shape
    act, pages, offs, n_valid = _page_write_ids(table, lens, page_size)
    counts = DD._page_counts(n_valid, W, page_size)
    if slab is not None:
        p0, pp = slab
        mine = (pages >= p0) & (pages < p0 + pp)
        act, pages, offs = act[mine], pages[mine] - p0, offs[mine]
        table, counts = DD.own_pages(table, counts, p0, pp)
    on_device = (isinstance(token, torch.Tensor)
                 and token.device.type == device.type)
    cross = () if enc_lens is None else (DD._page_counts(
        _to_host(enc_lens), enc_pages, page_size).ravel(),)
    parts = [lens, act, pages, offs, table.ravel(), counts.ravel(),
             *cross, *(_to_host(x).ravel() for x in extra)]
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
    lens_d, act_d, pages_d, offs_d, tbl_d, cnt_d, *rest = [
        buf[at:at + n] for at, n in zip(starts, sizes)]
    xcnt = rest.pop(0).view(B, enc_pages) if cross else None
    n_extra = len(extra)
    return PagedStep(token=token if on_device else rest[n_extra],
                     pos=lens_d, table=tbl_d.view(B, W),
                     counts=cnt_d.view(B, W), act=act_d, pages=pages_d,
                     offs=offs_d, all_active=len(act) == B,
                     extra=tuple(rest[:n_extra]), cross_counts=xcnt)


@functools.lru_cache(maxsize=16)
def identity_table(B: int, Jx: int, device) -> torch.Tensor:
    """(B, Jx) int32 table whose slot b holds pages [b * Jx, (b + 1) *
    Jx): the slot-dense cross cache (B, Jx * ps, KV, Dh) viewed as a
    pool of B * Jx pages of ps.  Built once a (slots, pages, device) and
    read, never written, by every layer of every step."""
    return torch.arange(B * Jx, dtype=torch.int32,
                        device=device).view(B, Jx)


def _pool_write(pool, scales, meta, x):
    """Each active slot's token ``x`` (B, ...) into this layer's pool at
    its page and offset, in place (quantize-on-write for int8 pools)."""
    if not meta.all_active:
        x = x.index_select(0, meta.act)
    if scales is not None:
        from repro_torch.engine.paged_cache import quantized_page_write
        quantized_page_write(pool, scales, meta.pages, meta.offs, x)
    else:
        pool[meta.pages, meta.offs] = x.to(pool.dtype)


def _decode_gqa_paged(cfg, lp, h, kp, vp, ks, vs, meta, rope, mesh=None,
                      layout=None):
    """h: (B, D) normed; kp/vp: this layer's (n_pages, ps, KV, Dh)
    pools, written in place at each active slot's position; ks/vs its
    (n_pages, KV) scales for int8 pools, else None.  Under ``mesh``
    (``_seq_mesh``) the pools are this rank's slab and ``meta`` its view;
    under ``layout`` the rank's heads and kv heads, as in
    ``_decode_gqa``.  Returns the attention delta (B, D)."""
    q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
    k = torch.einsum("bd,dhk->bhk", h, lp["wk"])
    v = torch.einsum("bd,dhk->bhk", h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if rope is not None:
        q, k = _rope1(q, rope), _rope1(k, rope)
    _pool_write(kp, ks, meta, k)
    _pool_write(vp, vs, meta, v)
    kp, vp, ks, vs = _read_kv(cfg, layout, q.shape[1], (kp, 2), (vp, 2),
                              (ks, 1), (vs, 1))
    o = DD.paged_decode_attend(q, kp, vp, meta.table, meta.counts,
                               k_scale=ks, v_scale=vs,
                               backend=cfg.kernel_impl, mesh=mesh,
                               seq_shard=mesh is not None)
    return L.row_parallel(torch.einsum("bhk,hkd->bd", o, lp["wo"]),
                          _on(layout, "heads"))


def _decode_mla_paged(cfg, lp, h, ckv_pool, krope_pool, cs, rs, meta,
                      rope, mesh=None):
    """Absorbed MLA decode against this layer's latent pools (n_pages,
    ps, r) / (n_pages, ps, rope), written in place; cs/rs their
    (n_pages,) scales for int8 pools, else None.  The pools ride
    separately into ``dist.decode.mla_paged_decode_attend``.  Returns
    the attention delta (B, D)."""
    q_abs, q_rope, scale, c_kv, k_rope = _mla_token(cfg, lp, h, rope)
    _pool_write(ckv_pool, cs, meta, c_kv)
    _pool_write(krope_pool, rs, meta, k_rope)
    o = DD.mla_paged_decode_attend(q_abs, q_rope, ckv_pool, krope_pool,
                                   meta.table, meta.counts, scale=scale,
                                   ckv_scale=cs, krope_scale=rs,
                                   backend=cfg.kernel_impl, mesh=mesh,
                                   seq_shard=mesh is not None)
    return MLA.mla_decode_finish(lp, o.float(), cfg).to(h.dtype)


def _decode_cross_paged(cfg, lp, h, xk, xv, page_size, meta):
    """Cross-attention against the slot-dense encoder cache xk / xv (B,
    Tx, KV, Dh), viewed as an identity-paged pool of pages of
    ``page_size`` (a reshape, no copy), so the per-slot encoder lengths
    (``meta.cross_counts``; 0 for an inactive slot) mask as the paged
    self-attention does: the paged decode op (kernel 5 on 'cuda').  q and
    the output projection are plain products, as in the JAX step."""
    B, Tx = xk.shape[:2]
    kp = xk.reshape(B * (Tx // page_size), page_size, *xk.shape[2:])
    vp = xv.reshape(kp.shape)
    table = identity_table(B, Tx // page_size, xk.device)
    q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
    o = DD.paged_decode_attend(q, kp, vp, table, meta.cross_counts,
                               backend=cfg.kernel_impl)
    return torch.einsum("bhk,hkd->bd", o, lp["wo"])


def _paged_attn_delta(cfg, ap, h, cs, meta, rope, mesh=None, layout=None):
    """Attention step of the paged decode: MLA or GQA on this layer's
    pool slice ``cs``; int8 pools are told by their scales.  ``mesh`` the
    seq mesh, ``layout`` the parameters' (``_decode_attn_delta``)."""
    if cfg.mla is not None:
        return _decode_mla_paged(cfg, ap, h, cs["ckv"], cs["krope"],
                                 cs.get("ckv_scale"), cs.get("krope_scale"),
                                 meta, rope, mesh)
    return _decode_gqa_paged(cfg, ap, h, cs["k"], cs["v"], cs.get("k_scale"),
                             cs.get("v_scale"), meta, rope, mesh, layout)


def paged_decode_step(params, batch, cfg, meta=None, mesh=None,
                      layout=None):
    """One-token serve step over a paged KV cache.

    batch: ``token`` (B,), ``cur_len`` (B,) per-slot valid positions and
    ``block_table`` (B, W) — host arrays (numpy or CPU tensors; the
    token may already be on the device) — and ``cache``
    (``engine.paged_cache`` pools, written in place).  Slots with
    cur_len == 0 are inactive: they write nothing, their attention is
    masked to zero and their logits are garbage the caller discards
    (they still take part in the MoE FFN's one decode group, as in the
    JAX step).  The audio family also takes ``enc_lens`` (B,), each
    slot's encoder positions in its cross cache (host ints; 0 for an
    inactive slot), which ride the step's one metadata copy.  ``meta`` is
    the step's metadata when the caller already built it
    (``paged_step_meta``; the mixed step does, with its chunk's).
    ``mesh``: with ``cfg.decode_shard == 'seq'`` the pools are this
    rank's slab of a pool sharded over its 'model' axis
    (``dist.sharding.paged_cache_pspecs``), the table and lengths the
    replicated global ones.  ``layout``: the parameters are the rank's
    blocks and the pools its kv heads (``decode_step``).  Returns (logits
    (B, vocab_padded) fp32, cache)."""
    # engine modules import this one: keep the import lazy
    from repro_torch.engine.paged_cache import check_family
    check_family(cfg)
    smesh = _seq_mesh(cfg, mesh)
    cache = batch["cache"]
    leaf = pool_leaf(cfg, cache)
    ps = leaf.shape[2]
    if meta is None:
        enc = {}
        if cfg.family == "audio":
            enc = dict(enc_lens=batch["enc_lens"],
                       enc_pages=cache["cross_k"].shape[2] // ps)
        pp = leaf.shape[1]
        meta = paged_step_meta(
            batch["token"], batch["cur_len"], batch["block_table"], ps,
            leaf.device, slab=None if smesh is None
            else (SH.block_start(smesh, "model", pp), pp), **enc)
    x = L.embed(params["embed"], meta.token,
                _on(layout, "vocab")).to(L.dt(cfg))   # (B, D)
    rope = _step_rope(cfg, meta.pos[:, None])         # per-slot positions
    if cfg.family == "audio":
        stacked = params["layers"]
        for i in range(_depth(stacked)):
            cs = _layer(cache, i)
            x = _audio_layer(
                cfg, _layer(stacked, i), x,
                lambda ap, h: _decode_gqa_paged(
                    cfg, ap, h, cs["self_k"], cs["self_v"], None, None,
                    meta, rope),
                lambda cp, h: _decode_cross_paged(
                    cfg, cp, h, cs["cross_k"], cs["cross_v"], ps, meta))
    else:
        for stacked, key, moe in _groups(cfg, params):
            group = _cache_group(cache, key)
            for i in range(_depth(stacked)):
                lp = _layer(stacked, i)
                h = _norm(cfg, lp["attn_norm"], x)
                x = x + _paged_attn_delta(cfg, lp["attn"], h,
                                          _layer(group, i), meta, rope,
                                          smesh, layout)
                x = x + _ffn_delta(cfg, lp, x, moe, mesh, layout)
    h = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, h[:, None, :], cfg, layout)[:, 0].float()
    return logits, cache
