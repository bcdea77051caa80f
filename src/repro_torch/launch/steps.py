"""Step functions (counterpart of ``repro.launch.steps`` on one device):
``build_train_step`` (microbatched gradient accumulation -> AdamW ->
metrics) for training, and ``build_prefill``, ``build_decode``,
``build_suffix_prefill`` and ``build_mixed_step`` for serving.  PyTorch
runs eagerly, so a step is a plain closure over the config."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.module import leaves
from repro_torch.models import lm
from repro_torch.optim import adamw


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


def value_and_grad(params, batch, cfg):
    """((loss, metrics), grads) of ``lm.train_loss`` at ``params``: the
    gradient of every parameter leaf, in the parameters' dtypes, by
    ``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives it."""
    flat = dict(leaves(params))
    live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
    with torch.enable_grad():
        loss, metrics = lm.train_loss(_with_leaves(params, live), batch,
                                      cfg)
        got = torch.autograd.grad(loss, list(live.values()),
                                  allow_unused=True)
    grads = {k: (torch.zeros_like(flat[k]) if g is None else g)
             for k, g in zip(live, got)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _with_leaves(params, grads)


def build_train_step(cfg, opt_cfg: adamw.OptConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The batch's numpy arrays move to the parameters' device.  With
    ``cfg.n_microbatches`` nm > 1 the batch splits into nm microbatches
    along its first axis; their gradients accumulate in fp32 and are
    divided by nm, and every metric is the mean over the microbatches.
    Then ``adamw.update`` (in place); the metrics gain ``grad_norm`` and
    ``lr``."""

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


# ======================================================================
# serving
# ======================================================================


def build_prefill(cfg):
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg)
    return prefill_step


def build_decode(cfg, mesh=None):
    """One-token serve step: over the dense cache, or over the paged
    pools when the batch carries a ``block_table`` (``lm.decode_step``
    routes it to ``lm.paged_decode_step``); ``mesh`` the layout of this
    rank's operands (``lm.decode_step``)."""
    def serve_step(params, batch):
        return lm.decode_step(params, batch, cfg, mesh=mesh)
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
