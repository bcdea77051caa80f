"""Step functions for serving (counterpart of ``repro.launch.steps``:
``build_prefill``, ``build_decode``, ``build_suffix_prefill`` and
``build_mixed_step`` on one device).  PyTorch runs eagerly, so a step is
a plain closure over the config."""
from __future__ import annotations

from repro_torch.models import lm


def build_prefill(cfg):
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg)
    return prefill_step


def build_decode(cfg):
    """One-token serve step: over the dense cache, or over the paged
    pools when the batch carries a ``block_table`` (``lm.decode_step``
    routes it to ``lm.paged_decode_step``)."""
    def serve_step(params, batch):
        return lm.decode_step(params, batch, cfg)
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
