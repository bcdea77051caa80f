"""Step functions for serving (counterpart of ``repro.launch.steps``:
``build_prefill`` and ``build_decode`` on one device).  PyTorch runs
eagerly, so a step is a plain closure over the config."""
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
