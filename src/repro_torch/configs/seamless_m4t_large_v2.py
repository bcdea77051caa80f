"""SeamlessM4T-large-v2 [arXiv:2308.11596]: encoder-decoder backbone
(24 enc + 24 dec, the text/unit decoder stack); the speech frontend is
a STUB per the brief — input_specs() provides precomputed frame
embeddings (dim 1024) as the encoder input sequence.  LayerNorm + ReLU
FFNs (NLLB-style)."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=8192, vocab=256206, norm="layernorm", act="relu",
    rope_theta=10000.0, logits_chunk=1024,
    frontend="audio", frontend_dim=1024,
)
