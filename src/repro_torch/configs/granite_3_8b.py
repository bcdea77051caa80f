"""Granite-3 8B [hf:ibm-granite]: dense GQA."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12800, vocab=49155, act="swiglu", rope_theta=10000.0,
)
