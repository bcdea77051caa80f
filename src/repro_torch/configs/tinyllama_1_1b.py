"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=5632, vocab=32000, act="swiglu", rope_theta=10000.0,
)
