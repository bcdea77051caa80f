"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B backbone; the
InternViT frontend is a STUB per the brief — input_specs() provides 256
precomputed patch embeddings (InternVL's 256 tokens/tile after pixel
shuffle) of dim 1024, projected into the LM stream."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553, act="swiglu", rope_theta=1e6,
    frontend="vision", frontend_tokens=256, frontend_dim=1024,
)
