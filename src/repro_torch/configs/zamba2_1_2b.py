"""Zamba2-1.2B [arXiv:2411.15242]: 38 Mamba2 blocks + one SHARED
attention+MLP block invoked every 6 blocks (7 invocations, one weight
set — the Zamba2 shared-block design; the concat-embedding input to the
shared block is simplified to the current residual stream, DESIGN.md §8).
"""
from repro_torch.common.config import Mamba2Config, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000, act="swiglu", rope_theta=10000.0,
    mamba2=Mamba2Config(d_state=64, d_conv=4, expand=2, head_dim=64,
                        n_groups=1, chunk=256, attn_every=6),
)
