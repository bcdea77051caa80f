"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts, top-8, no shared."""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024, vocab=50304, act="swiglu", rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=8, n_shared=0, d_expert=1024,
                  score_fn="softmax", norm_topk=False),
)
