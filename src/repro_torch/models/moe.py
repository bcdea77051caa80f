"""Mixture-of-Experts FFN: shared + routed top-k, capacity dispatch.

Counterpart of ``repro.models.moe``.  Routing is fp32 (the router and the
selection bias ``e_bias`` stay fp32 whatever the model dtype).  Each
(token, k) assignment gets a position in its expert's queue, by a
one-hot cumsum (``dispatch='gather'``) or a stable argsort
(``dispatch='sort'``), both in (token, k) order; assignments past the
capacity ``ceil(S * K * capacity_factor / E)`` are dropped.  Tokens are
gathered into a (G, E, cap, D) buffer, the experts run as batched
products over the expert axis (plain products, as the JAX package leaves
them to XLA), and each assignment's output is gathered back and weighted
by its gate.  The shared expert is ``layers.mlp``, so it runs on the
'cuda' backend's ``vwr_swiglu`` / ``vwr_matmul`` kernels.

Grouping: one group per batch row for prefill; decode runs all B slots as
one group, inactive ones included, so a slot's capacity depends on its
neighbours exactly as in the JAX package.

Expert parallelism (``moe_ffn(layout=)``, a ``dist.sharding.TPLayout``
of ``param_pspecs``' 'serve' layout): the experts spread over every axis
of the mesh (data x model) when E divides the product.  A rank then
holds E / (D * M) experts and its block of ``router``, ``e_bias``,
``wi``, ``wg`` and ``wo``; its router logits are gathered over every
axis, so every rank routes every token of the group alike (the caller
hands each rank the whole group), ``shard_hint`` cuts the dispatched
tokens down to the rank's experts, and the rank's weighted outputs are
summed over every axis in fp32.
When E does not divide, the experts stay whole and ``expert_ff`` takes
'model': ``wi`` / ``wg`` are column- and ``wo`` row-parallel, and the
weighted outputs are summed over 'model'.  Either way which tokens drop
is the one-device computation's: the routing is.  ``ep='full_ep'``
constrains the JAX layout only, so it runs the same computation as
'gspmd' here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.hints import shard_hint
from repro_torch.common.module import ParamDef, zeros_init
from repro_torch.dist.sharding import PS, block_start
from repro_torch.models.layers import dt, mlp, mlp_spec

# the axes the experts spread over (``dist.sharding.rules``: every axis)
EP_AXES = ("data", "model")


def moe_spec(cfg):
    m = cfg.moe
    d = cfg.d_model
    dtype = dt(cfg)
    spec: Dict = {
        "router": ParamDef((d, m.n_experts), torch.float32,
                           ("embed", "experts")),
        "wi": ParamDef((m.n_experts, d, m.d_expert), dtype,
                       ("experts", "embed", "expert_ff")),
        "wg": ParamDef((m.n_experts, d, m.d_expert), dtype,
                       ("experts", "embed", "expert_ff")),
        "wo": ParamDef((m.n_experts, m.d_expert, d), dtype,
                       ("experts", "expert_ff", "embed")),
    }
    if m.n_shared:
        spec["shared"] = mlp_spec(d, m.n_shared * m.d_expert, "swiglu",
                                  dtype)
    if m.score_fn == "sigmoid":
        # DeepSeek-V3's selection bias: it picks the experts and takes no
        # part in the gate weights
        spec["e_bias"] = ParamDef((m.n_experts,), torch.float32,
                                  ("experts",), zeros_init)
    return spec


# ---------------- routing ----------------

def router_scores(p, x, cfg, mesh=None):
    """x: (..., D) -> (probs (..., E) fp32, selection scores, logits).
    With ``mesh`` the router and ``e_bias`` are this rank's experts'
    block over ``EP_AXES``, and the blocks are gathered into all E."""
    logits = torch.einsum("...d,de->...e", x.float(), p["router"])
    if mesh is not None:
        logits = mesh.all_gather(logits, EP_AXES, -1)
    if cfg.moe.score_fn == "sigmoid":
        probs = torch.sigmoid(logits)
        bias = p["e_bias"]
        sel = probs + (bias if mesh is None
                       else mesh.all_gather(bias, EP_AXES, 0))
    else:
        probs = torch.softmax(logits, dim=-1)
        sel = probs
    return probs, sel, logits


def top_k_gates(probs, sel, cfg):
    """(gates (..., K) fp32, idx (..., K) int64): the K largest selection
    scores in descending order, ties to the lower expert index as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    m = cfg.moe
    idx = torch.sort(sel, dim=-1, descending=True, stable=True)[1]
    idx = idx[..., :m.top_k]
    gates = torch.gather(probs, -1, idx)
    if m.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-20)
    return gates * m.routed_scale, idx


# ---------------- position-in-expert ----------------

def _positions_cumsum(idx_flat, n_experts):
    """idx_flat: (G, A) expert ids.  pos[a] = #{a' < a: idx[a'] ==
    idx[a]}, by a one-hot cumsum."""
    oh = F.one_hot(idx_flat, n_experts)                     # (G, A, E)
    pos = oh.cumsum(1) - 1
    return torch.gather(pos, -1, idx_flat[..., None])[..., 0]


def _positions_sort(idx_flat, n_experts):
    """The same by a stable argsort over expert ids (O(A log A))."""
    G, A = idx_flat.shape
    order = torch.argsort(idx_flat, dim=1, stable=True)
    sorted_e = torch.gather(idx_flat, 1, order)
    counts = F.one_hot(idx_flat, n_experts).sum(1)          # (G, E)
    starts = counts.cumsum(1) - counts                      # exclusive
    pos_sorted = (torch.arange(A, device=idx_flat.device)[None]
                  - torch.gather(starts, 1, sorted_e))
    return torch.zeros_like(idx_flat).scatter_(1, order, pos_sorted)


# ---------------- dispatch / combine ----------------

def moe_ffn(p, x, cfg, stats: bool = False, layout=None):
    """x: (G, S, D) grouped tokens.  Returns (y (G, S, D), aux) with aux
    'lb_loss' (load balance), 'z_loss' (router logit magnitude) and
    'drop_frac' (share of assignments dropped by capacity).  With
    ``stats`` also the two means ``lb_loss`` is the product of, each
    (E,) over the G * S tokens: the router probability (with its
    gradient) and the assignment count (none): a data-parallel step
    (``launch.steps``) sums them over the ranks before the product.

    ``layout``: which of ``p``'s dims are a rank's blocks, and over what
    mesh (the module docstring; the counterpart of JAX's ``mesh``, whose
    arrays carry their layout); ``x`` is then the same whole group on
    every rank, and so is ``y``.  Without it ``p`` is whole and computes
    as on one device."""
    m = cfg.moe
    G, S, D = x.shape
    E, K = m.n_experts, m.top_k
    A = S * K
    cap = int(max(1, -(-S * K * m.capacity_factor // E)))   # ceil
    # experts split over every axis, or their ffn dim over 'model'
    ep = None if layout is None else layout.on("experts")
    ff = None if layout is None else layout.on("expert_ff")

    probs, sel, logits = router_scores(p, x, cfg, ep)       # (G, S, E)
    gates, idx = top_k_gates(probs, sel, cfg)               # (G, S, K)

    idx_flat = idx.reshape(G, A)
    if m.dispatch == "sort":
        pos = _positions_sort(idx_flat, E)
    else:
        pos = _positions_cumsum(idx_flat, E)
    keep = pos < cap                                        # (G, A)

    # each kept assignment owns slot idx * cap + pos; the dropped ones
    # all land on the sentinel slot E * cap, cut off below
    slot = torch.where(keep, idx_flat * cap + pos, E * cap)
    token_of_assign = torch.arange(S, device=x.device).repeat_interleave(
        K)[None].expand(G, A)
    token_for_slot = torch.full((G, E * cap + 1), S, dtype=torch.long,
                                device=x.device)
    token_for_slot.scatter_(1, slot, token_of_assign)
    token_for_slot = token_for_slot[:, :E * cap]            # (G, E*cap)

    x_pad = torch.cat([x, x.new_zeros(G, 1, D)], 1)        # row S: zeros
    xd = torch.gather(x_pad, 1, token_for_slot[..., None].expand(
        G, E * cap, D)).reshape(G, E, cap, D)
    own = keep
    if ep is not None:
        # the dispatch cut: this rank's experts' slots (El of them)
        xd = shard_hint(xd, PS(None, EP_AXES, None, None), ep)
        e0 = block_start(ep, EP_AXES, xd.shape[1])
        own = keep & (idx_flat >= e0) & (idx_flat < e0 + xd.shape[1])
        slot = torch.where(own, slot - e0 * cap, xd.shape[1] * cap)
    El = xd.shape[1]

    # the experts' swiglu as products batched over the expert axis
    h = torch.einsum("gecd,edf->gecf", xd, p["wi"])
    gte = torch.einsum("gecd,edf->gecf", xd, p["wg"])
    h = F.silu(gte.float()).to(h.dtype) * h
    y_e = torch.einsum("gecf,efd->gecd", h, p["wo"])        # (G,El,cap,D)

    # combine: each assignment's slot output, weighted by its gate; on a
    # mesh the ranks' fp32 partials (their experts', or their ffn
    # blocks') are summed before the one cast
    y_flat = torch.cat([y_e.reshape(G, El * cap, D),
                        y_e.new_zeros(G, 1, D)], 1)
    y_a = torch.gather(y_flat, 1, slot[..., None].expand(G, A, D))
    w_a = (gates.reshape(G, A) * own).float()
    y = (y_a.float() * w_a[..., None]).reshape(G, S, K, D).sum(2)
    if ep is not None:
        ep.all_reduce(y, EP_AXES)
    elif ff is not None:
        ff.all_reduce(y, "model")
    y = y.to(x.dtype)

    if m.n_shared:
        y = y + mlp(p["shared"], x, "swiglu", backend=cfg, mesh=(
            None if layout is None else layout.on("shared")))

    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = F.one_hot(idx, E).float().sum(2).mean(dim=(0, 1))
    aux = {"lb_loss": E * torch.sum(me * ce) / K,
           "z_loss": torch.logsumexp(logits, -1).square().mean(),
           "drop_frac": 1.0 - keep.float().mean()}
    if stats:
        return y, aux, (me, ce)
    return y, aux
