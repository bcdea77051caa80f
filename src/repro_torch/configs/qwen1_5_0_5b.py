"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: QKV bias, tied embeddings."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab=151936, qkv_bias=True, tie_embeddings=True,
    act="swiglu", rope_theta=1e6, logits_chunk=1024,
)
