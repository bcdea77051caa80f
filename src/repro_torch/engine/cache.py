"""Decode-cache construction: place prefill KV material into the
fixed-size decode buffers (counterpart of ``repro.engine.cache``, dense
and moe families)."""
from __future__ import annotations

from repro_torch.models import lm


def _put(group, stacks):
    """Each (L, B, S, ...) prefill stack at offset 0 of its (L, B,
    max_len, ...) buffer in ``group`` ({"k", "v"} or {"ckv", "krope"},
    keys in that order)."""
    for buf, kv in zip(group.values(), stacks):
        buf[:, :, :kv.shape[2]] = kv


def pad_cache_from_prefill(cfg, caches, batch, max_len):
    """Place ``lm.prefill``'s cache stacks at offset 0 of a zeroed
    fixed-size decode cache: (k, v) or (c_kv, k_rope) stacks, or for the
    moe family the pair (dense layers' stacks or None, MoE layers')."""
    groups = caches if cfg.family == "moe" else (None, caches)
    S = groups[1][0].shape[2]
    if S > max_len:
        raise ValueError(f"prefill length {S} exceeds max_len {max_len}")
    cache = lm.init_cache(cfg, batch, max_len, device=groups[1][0].device)
    if cfg.family == "moe":
        if groups[0] is not None:
            _put(cache["dense"], groups[0])
        _put(cache["moe"], groups[1])
    else:
        _put(cache, caches)
    return cache
