"""Model / runtime configuration dataclasses.

A copy of ``repro.common.config`` for the PyTorch port; only the
``kernel_impl`` values differ ('torch' | 'cuda').

Every assigned architecture is expressed as a ``ModelConfig``; the exact
published numbers live in ``repro_torch.configs.<id>``.  Runtime knobs (remat,
microbatching, attention implementation) live here too so that a config
fully determines the lowered program.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # shared (always-on) experts
    d_expert: int = 0              # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_k_dense: int = 0         # leading dense layers (DeepSeek-V3: 3)
    d_ff_dense: int = 0            # FFN width of the dense layers (0 = d_ff)
    score_fn: str = "softmax"      # softmax | sigmoid (DeepSeek-V3)
    norm_topk: bool = False        # renormalize top-k gates (DeepSeek-V3: True)
    routed_scale: float = 1.0      # routed-expert output scale (V3: 2.5)
    # 'gather' = capacity dispatch, position-in-expert via one-hot cumsum
    # 'sort'   = same, position via stable argsort (beyond-paper opt)
    dispatch: str = "gather"
    # 'gspmd'   = let GSPMD reshard around the expert einsum (baseline)
    # 'full_ep' = constrain dispatched tokens to the expert owners
    #             (E sharded over data x model): tokens move (all-to-
    #             all-sized), weights never do (EXPERIMENTS.md §Perf H2)
    ep: str = "gspmd"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class Mamba2Config:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    # hybrid (Zamba2): a shared full-attention block every `attn_every`
    # Mamba blocks (0 = pure SSM stack)
    attn_every: int = 0


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 6           # 1-in-N layers are sLSTM, rest mLSTM
    proj_factor: float = 2.0       # mLSTM up-projection
    conv1d_kernel: int = 4
    chunk: int = 256               # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu | relu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    z_loss_coef: float = 1e-4      # output z-loss
    lb_coef: float = 0.01          # MoE load-balance coefficient
    router_z_coef: float = 1e-3    # MoE router z-loss coefficient

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba2: Optional[Mamba2Config] = None
    xlstm: Optional[XLSTMConfig] = None

    # encoder-decoder (audio family): n_layers counts DECODER layers.
    enc_layers: int = 0
    # modality frontend stub: number of precomputed embedding tokens the
    # frontend contributes ('input_specs' provides them directly).
    frontend: Optional[str] = None          # 'vision' | 'audio' | None
    frontend_tokens: int = 0
    frontend_dim: int = 0                   # raw embedding dim (pre-proj)

    # ---- runtime knobs (affect lowering, not semantics) ----
    # 'fsdp_tp' = TP over 'model' + param dim over data axes (default)
    # 'ddp'     = both mesh axes are data; params ZeRO-sharded over all
    #             (right choice for sub-1B archs on a 256-chip mesh)
    sharding_strategy: str = "fsdp_tp"
    # kernel-dispatch backend (repro_torch.kernels.dispatch registry):
    # 'torch' = plain PyTorch formulations (the counterpart of the JAX
    #           package's 'xla')
    # 'cuda'  = the hand-written Hopper kernels in repro_torch/csrc
    #           (the counterpart of 'pallas'; default).  On CPU tensors
    #           each kernel wrapper runs its plain version.
    kernel_impl: str = "cuda"
    # decode attention distribution:
    # 'none' = the cache is shard-local (GSPMD may still head-shard it)
    # 'seq'  = cache sequence-sharded over 'model'; decode attention
    #          runs distributed FlashDecoding (dist.decode) — per-shard
    #          online-softmax partials, a (B, H)-sized psum combine.
    #          Needs the mesh passed explicitly through
    #          lm.decode_step/steps.build_decode (engine.DecodeEngine
    #          does); the ambient-mesh fallback is deprecated.  Falls
    #          back to 'none' without a mesh.
    decode_shard: str = "none"
    dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    scan_layers: bool = True
    attn_impl: str = "auto"        # auto | tp_heads | seq_par
    attn_block_q: int = 512        # blockwise-attention q tile
    attn_block_kv: int = 1024      # blockwise-attention kv tile
    n_microbatches: int = 1        # grad-accumulation microbatches
    logits_chunk: int = 0          # 0 = whole-seq loss; else chunk seq
    max_seq: int = 32768
    # accounting mode: scan-free / dense formulations so that XLA
    # cost_analysis FLOP/byte counts are exact (see DESIGN.md §8 — XLA
    # counts while-loop bodies once).  Accounting programs are lowered,
    # never executed, so their transient sizes don't matter.
    accounting: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------- derived ----------
    @property
    def vocab_padded(self) -> int:
        """Embedding/unembedding tables are padded to a multiple of 128
        so the vocab dim shards over 'model' (Megatron-style padding;
        granite/internvl2/seamless have odd vocab sizes).  Logits at
        padded positions are masked to -inf."""
        return -(-self.vocab // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def n_params(self) -> int:
        """Total parameter count (analytic, matches the param tree)."""
        from repro_torch.common.module import count_params
        from repro_torch.models import lm  # local import: avoid cycle

        return count_params(lm.model_spec(self))

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe_layers = self.n_layers - m.first_k_dense
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return self.n_params() - inactive


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is a pure full-attention arch (skip per brief)"
        )
    return True, ""
