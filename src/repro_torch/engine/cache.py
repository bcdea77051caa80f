"""Decode-cache construction: place prefill KV material into the
fixed-size decode buffers (counterpart of ``repro.engine.cache``,
dense family)."""
from __future__ import annotations

from repro_torch.models import lm


def pad_cache_from_prefill(cfg, caches, batch, max_len):
    """Place the prefill KV stacks (L, B, S, KV, Dh) at offset 0 of a
    zeroed (L, B, max_len, KV, Dh) decode cache."""
    k, v = caches
    S = k.shape[2]
    if S > max_len:
        raise ValueError(f"prefill length {S} exceeds max_len {max_len}")
    cache = lm.init_cache(cfg, batch, max_len, device=k.device)
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    return cache
