"""Assigned-architecture registry: ``get_config(name)`` / ``--arch``.

A copy of ``repro.configs`` (that package pulls in JAX through its
parameter module).  Each module exports CONFIG (the exact published
numbers) and the registry adds ``reduced(cfg)`` — a same-family shrink
used by the CPU tests (tiny layers/width/experts, fp32).  The full
configs are materialized only on the GPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.config import (MLAConfig, Mamba2Config,  # noqa: F401
                                       ModelConfig, MoEConfig, XLSTMConfig)

from repro_torch.configs import (deepseek_coder_33b, deepseek_v3_671b,
                                 granite_3_8b, internvl2_2b, olmoe_1b_7b,
                                 qwen1_5_0_5b, seamless_m4t_large_v2,
                                 tinyllama_1_1b, xlstm_350m, zamba2_1_2b)

ARCHS = {
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "tinyllama-1.1b": tinyllama_1_1b.CONFIG,
    "deepseek-coder-33b": deepseek_coder_33b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family shrink for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)) or 4,
        d_head=16, d_ff=(128 if cfg.d_ff else 0), vocab=512,
        dtype="float32", remat="none", attn_block_q=32, attn_block_kv=32,
        logits_chunk=0, n_microbatches=1,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              rope_head_dim=8, nope_head_dim=16,
                              v_head_dim=16)
    if cfg.mamba2 is not None:
        kw["mamba2"] = dataclasses.replace(
            cfg.mamba2, d_state=8, head_dim=16, chunk=16,
            attn_every=2)
        kw["n_layers"] = 5                      # 2 groups of 2 + tail 1
        kw["n_kv_heads"] = 4
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=2,
                                          chunk=16)
        kw["n_layers"] = 4
        kw["n_kv_heads"] = 4
    if cfg.frontend:
        kw["frontend"] = cfg.frontend
        kw["frontend_tokens"] = 8
        kw["frontend_dim"] = 32
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    return cfg.replace(**kw)
