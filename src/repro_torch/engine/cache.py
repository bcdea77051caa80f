"""Decode-cache construction: place prefill KV material into the
fixed-size decode buffers, and the recurrent families' final states into
the cache as they are (counterpart of ``repro.engine.cache``)."""
from __future__ import annotations

import torch

from repro_torch.models import lm


def _put(group, stacks, span=None):
    """Each (L, B, S, ...) prefill stack at offset 0 of its (L, B, T,
    ...) buffer in ``group`` ({"k", "v"}, {"ckv", "krope"} or the audio
    family's {"self_k", "self_v", "cross_k", "cross_v"}, keys in that
    order).  With ``span`` (t0, max_len) the buffer is a rank's slab of a
    ``max_len`` cache holding positions [t0, t0 + T), and gets the
    stack's rows of them."""
    t0, max_len = span if span is not None else (0, None)
    for buf, kv in zip(group.values(), stacks):
        if kv.shape[2] > (max_len or buf.shape[2]):
            raise ValueError(f"prefill length {kv.shape[2]} exceeds the "
                             f"cache's {max_len or buf.shape[2]} positions")
        rows = kv[:, :, t0:t0 + buf.shape[2]]
        buf[:, :, :rows.shape[2]] = rows


def pad_cache_from_prefill(cfg, caches, batch, max_len, enc_len=0,
                           span=None):
    """Place ``lm.prefill``'s cache stacks at offset 0 of a zeroed
    fixed-size decode cache: (k, v) or (c_kv, k_rope) stacks, or for the
    moe family the pair (dense layers' stacks or None, MoE layers'), or
    for the audio family the pair (self (k, v), cross (xk, xv)), whose
    cross cache holds ``enc_len`` positions (``max_len`` when 0).  The
    hybrid family's shared-block stacks land at offset 0 of ``attn_k`` /
    ``attn_v`` (main groups' invocations, then the tail's); its Mamba2
    states, and the ssm family's mLSTM / sLSTM states, are taken as they
    are.  ``span`` (t0, T) builds this rank's slab of a cache
    sequence-sharded over 'model' instead: positions [t0, t0 + T) (the
    dense and moe families)."""
    if cfg.family == "ssm":
        m_sts, s_st = caches
        return {"mlstm": m_sts, "slstm": s_st}
    if cfg.family == "hybrid":
        (st_main, kv_main), (st_tail, kv_tail) = caches
        cache = lm.init_cache(cfg, batch, max_len, device=kv_main[0].device)
        cache["mamba_main"] = st_main
        if st_tail is not None:
            cache["mamba_tail"] = st_tail
            kv_main = tuple(torch.cat([m, t[None]]) for m, t in
                            zip(kv_main, kv_tail))
        _put({"k": cache["attn_k"], "v": cache["attn_v"]}, kv_main)
        return cache
    if cfg.family == "audio":
        (k, v), (xk, xv) = caches
        cache = lm.init_cache(cfg, batch, max_len, enc_len=enc_len,
                              device=k.device)
        _put(cache, (k, v, xk, xv))
        return cache
    T = span[1] if span is not None else max_len
    span = (span[0], max_len) if span is not None else None
    groups = caches if cfg.family == "moe" else (None, caches)
    cache = lm.init_cache(cfg, batch, T, device=groups[1][0].device)
    if cfg.family == "moe":
        if groups[0] is not None:
            _put(cache["dense"], groups[0], span)
        _put(cache["moe"], groups[1], span)
    else:
        _put(cache, caches, span)
    return cache
