"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA + 1 shared + 256 routed
top-8 (sigmoid scoring, selection bias, gates renormalized, scale 2.5),
first 3 layers dense (d_ff 18432).

MTP (multi-token prediction) head omitted: the training objective here
is next-token CE; noted in DESIGN.md §8.
"""
from repro_torch.common.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=2048, vocab=129280, act="swiglu", rope_theta=10000.0,
    logits_chunk=1024,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert=2048,
                  first_k_dense=3, d_ff_dense=18432,
                  score_fn="sigmoid", norm_topk=True, routed_scale=2.5,
                  capacity_factor=1.25),
)
