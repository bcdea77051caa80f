"""Step functions (counterpart of ``repro.launch.steps``):
``build_train_step`` (microbatched gradient accumulation -> AdamW ->
metrics) for training, on one device or data-parallel over a mesh of
ranks with ZeRO-1, and ``build_prefill``, ``build_decode``,
``build_suffix_prefill`` and ``build_mixed_step`` for serving.  PyTorch
runs eagerly, so a step is a plain closure over the config.

The data-parallel step keeps the JAX step's GSPMD semantics: its loss,
metrics and update are those of the global batch on one device.  Each
rank takes its rows of each global microbatch (``train_batch_pspecs``
and ``local_block``; a microbatch the data axis does not divide is
computed whole on every rank, its share weighted 1/D) and weights its
parts by the global counts:

  * the cross-entropy and z-loss sums by the global mask count (not the
    rank's, which differs when the ranks' masks do);
  * the MoE ``lb_loss = E * sum(me * ce) / K`` is a product of two
    means over the global tokens: one all-reduce a microbatch sums
    every MoE layer's ``me`` / ``ce`` (and the metric sums) first, and
    the rank's surrogate takes its share of ``me`` times the global
    ``ce``, so the ranks' gradients sum to the global one;
  * ``z_loss_router`` and ``drop_frac`` (token means) by the rank's
    token share.

The rank's gradients of that surrogate accumulate over the microbatches
(fp32 when there are several), and one reduction a step follows: per
leaf a reduce-scatter into the ZeRO-1 blocks of ``adamw.state_specs``,
an all-reduce for the leaves it leaves whole.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from repro_torch.common.module import leaves
from repro_torch.dist import sharding as SH
from repro_torch.models import lm
from repro_torch.optim import adamw

# the tensor-parallel layers serve only: a 'model' axis > 1 refuses
ITEM_14_TP = ("tensor-parallel layers ('model' axis > 1) are not ported "
              "to repro_torch yet: ROADMAP.md queue 1 item 14")


# ======================================================================
# train step
# ======================================================================

def _with_leaves(tree, new, prefix=()):
    """``tree``'s structure with each leaf replaced by ``new[path]``."""
    return {k: (_with_leaves(v, new, prefix + (k,)) if isinstance(v, dict)
                else new[prefix + (k,)]) for k, v in tree.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(params, batch, cfg, loss_fn=lm.train_loss):
    """((loss, metrics), grads) of ``loss_fn`` (``lm.train_loss``) at
    ``params``: the gradient of every parameter leaf, in the parameters'
    dtypes, by ``torch.autograd.grad``; a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives it."""
    flat = dict(leaves(params))
    live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(_with_leaves(params, live), batch, cfg)
        got = torch.autograd.grad(loss, list(live.values()),
                                  allow_unused=True)
    grads = {k: (torch.zeros_like(flat[k]) if g is None else g)
             for k, g in zip(live, got)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _with_leaves(params, grads)


def build_train_step(cfg, opt_cfg: adamw.OptConfig, mesh=None,
                     zero1: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The batch's numpy arrays move to the parameters' device.  With
    ``cfg.n_microbatches`` nm > 1 the batch splits into nm microbatches
    along its first axis; their gradients accumulate in fp32 and are
    divided by nm, and every metric is the mean over the microbatches.
    Then ``adamw.update`` (in place); the metrics gain ``grad_norm`` and
    ``lr``.

    With a ``mesh`` whose data axis has more than one rank, the step is
    data-parallel (the module docstring): every rank passes the whole
    parameters, its state from ``adamw.init(opt_cfg, params, mesh,
    zero1)`` and the same global batch, and gets the global batch's
    metrics and the one-device update.  The step's ``last_sync`` holds
    the last gradient reduction's wall seconds (device synchronized
    around it) and the bytes each rank sent for it (a ring's: (D - 1) / D
    of a reduce-scattered leaf, twice that of an all-reduced one).  A
    'model' axis > 1 raises ``NotImplementedError``."""
    if mesh is not None and mesh.axis_size("model") > 1:
        raise NotImplementedError(ITEM_14_TP)
    if mesh is not None and SH.data_size(mesh) > 1:
        return _data_parallel_step(cfg, opt_cfg, mesh, zero1)

    def train_step(params, opt_state, batch):
        dev = next(leaves(params))[1].device
        batch = to_device(batch, dev)
        nm = cfg.n_microbatches
        if nm > 1:
            B = batch["tokens"].shape[0]
            if B % nm:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"n_microbatches {nm}")
            b = B // nm
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for k, p in leaves(params)}
            loss_sum = torch.zeros((), device=dev)
            mets = []
            for i in range(nm):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                (loss, metrics), grads = value_and_grad(params, mb, cfg)
                for k, g in leaves(grads):
                    acc[k].add_(g)
                loss_sum = loss_sum + loss
                mets.append(metrics)
            grads = _with_leaves(params, {k: g / nm for k, g in acc.items()})
            # every microbatch's metrics, averaged like the loss (the last
            # microbatch's alone would log a quarter of the batch)
            metrics = {k: torch.stack([m[k] for m in mets]).mean(0)
                       for k in mets[0]}
            metrics["loss"] = loss_sum / nm
        else:
            (loss, metrics), grads = value_and_grad(params, batch, cfg)

        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, {**metrics, **om}

    return train_step


def _global_loss(mesh, mask_count, w, frac):
    """The loss function of a rank's part of a global microbatch (for
    ``value_and_grad``): returns (the rank's surrogate, the global
    metrics).  ``mask_count`` is the global microbatch's mask count (at
    least 1), ``w`` the weight of the rank's sums (1, or 1/D when every
    rank computes the whole microbatch) and ``frac`` its share of the
    global token means (w * its rows / the microbatch's rows)."""

    def loss_fn(params, batch, cfg):
        parts = lm.train_parts(params, batch, cfg)
        ce_sum, z_sum = parts["ce_sum"] * w, parts["z_sum"] * w
        aux, stats = parts["aux"], parts["moe_stats"]
        # one all-reduce: the metric sums and every MoE layer's stats
        head = [ce_sum.detach(), z_sum.detach()]
        if stats is not None:
            me, ce = stats
            head += [aux["z_loss_router"].detach() * frac,
                     aux["drop_frac"].detach() * frac]
            flat = torch.cat([torch.stack(head).float(),
                              (me.detach() * frac).reshape(-1),
                              (ce * frac).reshape(-1)])
        else:
            flat = torch.stack(head).float()
        mesh.all_reduce(flat, "data")
        ce_g, z_g = flat[0] / mask_count, flat[1] / mask_count
        metrics = {"ce": ce_g, "z_loss": z_g}
        total = (ce_sum + cfg.z_loss_coef * z_sum) / mask_count
        loss = ce_g + cfg.z_loss_coef * z_g
        if stats is not None:
            m = cfg.moe
            L, E = me.shape
            me_g = flat[4:4 + L * E].view(L, E)
            ce_gl = flat[4 + L * E:].view(L, E)
            scale = E / m.top_k
            lb = (scale * (me_g * ce_gl).sum(-1)).mean()
            metrics.update(lb_loss=lb, z_loss_router=flat[2],
                           drop_frac=flat[3])
            # the rank's share of each layer's me against the global ce:
            # summed over the ranks, the global lb_loss and its gradient
            lb_r = (scale * (me * frac * ce_gl).sum(-1)).mean()
            total = (total + cfg.lb_coef * lb_r
                     + cfg.router_z_coef * aux["z_loss_router"] * frac)
            loss = loss + cfg.lb_coef * lb + cfg.router_z_coef * flat[2]
        metrics["loss"] = loss
        return total, metrics

    return loss_fn


def _reduce_grads(mesh, grads, specs, record):
    """Each leaf summed over the data axis: its ZeRO-1 block where its
    spec splits a dim (reduce-scatter), else whole (all-reduce).
    ``record`` gets the wall seconds and the bytes a rank sent."""
    n = SH.data_size(mesh)
    dev = next(leaves(grads))[1].device
    sync = dev.type == "cuda"
    if sync:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out, sent = {}, 0
    for path, g in leaves(grads):
        spec = adamw._at(specs, path)
        nbytes = g.numel() * g.element_size()
        if adamw.is_split(spec):
            dim = next(i for i, e in enumerate(spec) if e is not None)
            out[path] = mesh.reduce_scatter(g, "data", dim)
            sent += nbytes * (n - 1) // n
        else:
            out[path] = mesh.all_reduce(g, "data")
            sent += 2 * nbytes * (n - 1) // n
    if sync:
        torch.cuda.synchronize(dev)
    record.update(s=time.perf_counter() - t0, bytes=sent)
    return _with_leaves(grads, out)


def _data_parallel_step(cfg, opt_cfg, mesh, zero1):
    n = SH.data_size(mesh)
    record: Dict[str, float] = {}

    def train_step(params, opt_state, batch):
        dev = next(leaves(params))[1].device
        nm = cfg.n_microbatches
        B = batch["tokens"].shape[0]
        if B % nm:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"n_microbatches {nm}")
        b = B // nm
        acc = None
        mets = []
        for i in range(nm):
            mb = {k: torch.as_tensor(v)[i * b:(i + 1) * b]
                  for k, v in batch.items()}
            specs = SH.train_batch_pspecs(cfg, mesh, mb)
            local = {k: SH.local_block(v, specs[k], mesh).to(dev)
                     for k, v in mb.items()}
            rows = local["tokens"].shape[0]
            w = 1.0 / n if rows == b else 1.0
            mask_count = torch.clamp(
                mb["loss_mask"].to(dev).float().sum(), min=1.0)
            (_, metrics), grads = value_and_grad(
                params, local, cfg,
                _global_loss(mesh, mask_count, w, w * rows / b))
            mets.append(metrics)
            if nm == 1:
                acc = grads
            elif acc is None:
                acc = {k: g.to(torch.float32) for k, g in leaves(grads)}
            else:
                for k, g in leaves(grads):
                    acc[k].add_(g)
        if nm > 1:
            acc = _with_leaves(params, {k: g / nm for k, g in acc.items()})
            metrics = {k: torch.stack([m[k] for m in mets]).mean(0)
                       for k in mets[0]}
        specs = adamw.state_specs(opt_cfg, params, mesh, zero1).m
        grads = _reduce_grads(mesh, acc, specs, record)
        del acc
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params, mesh=mesh, zero1=zero1)
        return params, opt_state, {**metrics, **om}

    train_step.last_sync = record
    return train_step


# ======================================================================
# serving
# ======================================================================


def build_prefill(cfg, mesh=None, layout=None):
    """Full-sequence prefill (``lm.prefill``); ``mesh`` / ``layout`` the
    layout of this rank's rows and parameters."""
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, mesh=mesh, layout=layout)
    return prefill_step


def build_decode(cfg, mesh=None, layout=None):
    """One-token serve step: over the dense cache, or over the paged
    pools when the batch carries a ``block_table`` (``lm.decode_step``
    routes it to ``lm.paged_decode_step``); ``mesh`` / ``layout`` the
    layout of this rank's operands and parameters (``lm.decode_step``)."""
    def serve_step(params, batch):
        return lm.decode_step(params, batch, cfg, mesh=mesh, layout=layout)
    return serve_step


def build_suffix_prefill(cfg):
    """Suffix-only prefill of a prefix-cache hit: ``lm.prefill_suffix``
    (batch: ``tokens`` (1, S), ``pages`` (J_m,), ``cache``)."""
    def suffix_prefill_step(params, batch):
        return lm.prefill_suffix(params, batch, cfg)
    return suffix_prefill_step


def build_mixed_step(cfg):
    """The chunked-prefill step: one prompt chunk and the whole paged
    decode batch in one call.

    batch: the paged decode step's ``token``, ``cur_len``,
    ``block_table`` (host arrays) and ``cache``, plus ``chunk_tokens``
    (C,), ``chunk_pages`` (J_p,) and ``chunk_write_pages`` (J_w,) host
    int arrays (``lm.prefill_chunk``).  All of them reach the device in
    the step's one metadata copy.  The chunk prefills first and writes
    its pages; then the decode batch steps over the updated pools (the
    chunk's slot rides it with length 0: no write, masked, its row
    discarded).  Returns (decode logits (B, V) fp32, chunk logits (1, V)
    fp32, cache) — the pools are updated in place."""
    def mixed_step(params, batch):
        cache = batch["cache"]
        leaf = lm.pool_leaf(cfg, cache)
        meta = lm.paged_step_meta(
            batch["token"], batch["cur_len"], batch["block_table"],
            leaf.shape[2], leaf.device,
            extra=(batch["chunk_tokens"], batch["chunk_pages"],
                   batch["chunk_write_pages"]))
        toks, pages, write_pages = meta.extra
        chunk_logits, cache = lm.prefill_chunk(
            params, {"tokens": toks[None], "pages": pages,
                     "write_pages": write_pages, "cache": cache}, cfg)
        logits, cache = lm.paged_decode_step(
            params, {"cache": cache}, cfg, meta=meta)
        return logits, chunk_logits, cache
    return mixed_step
