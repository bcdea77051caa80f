"""Roofline terms of a step on NVIDIA H100 SXM cards.

Counterpart of ``repro.launch.roofline`` with the H100's constants in
place of the TPU's.  Terms per (arch x shape) over ``chips`` cards:

    t_comp = FLOPs / (chips * PEAK_FLOPS[dtype])     [tensor-core peak]
    t_mem  = bytes / (chips * HBM_BW)                [HBM3]
    t_coll = collective_bytes / (chips * NVLINK_BW)  [NVLink per link]

``model_flops`` (6*N*D, MoE: active parameters) and ``attention_flops``
count the useful work; ``analytic_traffic`` is the per-family model of
the HBM bytes a step moves.  ``load_cell`` / ``build_roofline`` read the
records a dry run writes (the dry run itself is ROADMAP queue 1 item
15).  The kernel bounds of ``chip_smoke.py`` and the autotuner's priors
(``kernels.autotune``) use the same peaks.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
# fp32 outside them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the same data sheet: 80 GB of HBM3 at 3.35 TB/s
HBM_BW = 3.35e12             # bytes/s / card
H100_HBM_BYTES = 80 * 1024 ** 3
# the same data sheet: 900 GB/s of NVLink 4 over 18 links, both
# directions summed
NVLINK_BW = 900e9 / 18       # bytes/s / link


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    flops: float             # global, per step
    bytes_hbm: float         # global, per step
    bytes_coll: float        # global, per step
    model_flops: float       # analytic useful flops
    dtype: str = "bfloat16"  # selects the compute peak
    t_comp: float = 0.0
    t_mem: float = 0.0
    t_coll: float = 0.0

    def finalize(self):
        self.t_comp = self.flops / (self.chips * PEAK_FLOPS[self.dtype])
        self.t_mem = self.bytes_hbm / (self.chips * HBM_BW)
        self.t_coll = self.bytes_coll / (self.chips * NVLINK_BW)
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap upper bound is sum; perfect overlap is max.
        We report max (the roofline optimum a perf loop drives toward)."""
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def useful_frac(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_frac(self) -> float:
        """Fraction of the dominant-roofline optimum that is useful
        model compute: MODEL_FLOPS/peak vs achieved step time."""
        t_model = self.model_flops / (self.chips * PEAK_FLOPS[self.dtype])
        return t_model / max(self.step_time, 1e-30)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_coll": self.bytes_coll,
            "t_comp_s": self.t_comp, "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_frac": self.useful_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*D_step (decode); MoE uses
    active params.  D = tokens processed in the step."""
    n = cfg.n_active_params() if cfg.moe is not None else cfg.n_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence; params touched ~ active set
    return 2.0 * n * shape.global_batch


def attention_flops(cfg, shape) -> float:
    """Quadratic attention term excluded from 6ND (reported separately)."""
    if cfg.family in ("ssm",):
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    if cfg.family == "hybrid":
        from repro_torch.models.lm import _hybrid_groups
        L = _hybrid_groups(cfg)[3]
    dh = cfg.d_head if cfg.mla is None else (
        cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
    per_tok_pair = 2 * cfg.n_heads * dh * 2          # qk + pv
    if shape.kind == "train":
        return 3.0 * L * B * S * S / 2 * per_tok_pair
    if shape.kind == "prefill":
        return L * B * S * S / 2 * per_tok_pair
    return L * B * S * per_tok_pair


def load_cell(artifact_dir: str, arch: str, shape: str,
              mesh: str = "single") -> Optional[Dict]:
    path = os.path.join(artifact_dir, f"{arch}.{shape}.{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def build_roofline(cfg, shape, rec: Dict, corrected: Optional[Dict] = None
                   ) -> Roofline:
    flops = (corrected or rec).get("flops", rec.get("flops", 0.0))
    bts = (corrected or rec).get("bytes_accessed",
                                 rec.get("bytes_accessed", 0.0))
    mf = model_flops(cfg, shape) + attention_flops(cfg, shape)
    return Roofline(
        arch=cfg.name, shape=shape.name, chips=rec.get("n_devices", 1),
        flops=flops, bytes_hbm=bts,
        bytes_coll=rec.get("collective_bytes", 0.0),
        model_flops=mf,
        dtype="float32" if cfg.dtype == "float32" else "bfloat16",
    ).finalize()


# ======================================================================
# analytic HBM-traffic model (global bytes per step)
# ======================================================================

def analytic_traffic(cfg, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    dt = 2 if cfg.dtype == "bfloat16" else 4
    d = cfg.d_model
    L = cfg.n_layers
    n_params = cfg.n_params()
    n_active = cfg.n_active_params()
    tokens = B * S

    ff_ratio = (cfg.d_ff / d) if cfg.d_ff else 2.0
    # per-token per-layer activation words flowing through HBM
    # (residual, qkv, attn out, mlp hidden x2 gates)
    act_width = (4 + 2 * ff_ratio) * d

    if shape.kind == "train":
        # params: fsdp all-gather fwd+bwd (2x2B) + grad reduce-scatter
        # (4B) + adam m/v rw (bf16: 4x2B) + master rw (8B)
        p_bytes = n_params * (2 * dt + 4 + 8 + 8)
        # activations: fwd write+bwd read of layer boundaries + remat
        # recompute traffic (~3 passes over act_width)
        a_bytes = L * tokens * (2 * d * dt + 3 * act_width * dt)
        # attention KV streaming: fwd + bwd + remat-recompute passes
        kv_w = (cfg.n_kv_heads * cfg.d_head if cfg.mla is None else
                cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
        n_attn = L if cfg.family not in ("hybrid", "ssm") else (
            0 if cfg.family == "ssm" else
            (L // cfg.mamba2.attn_every + 1))
        bq = max(cfg.attn_block_q, 1)
        att_bytes = 3 * n_attn * B * (S / bq) * S * kv_w * 2 * dt
        # logits fwd+bwd (fp32)
        lg_bytes = tokens * cfg.vocab_padded * 4 * 2
        moe_bytes = 0.0
        if cfg.moe is not None:
            m = cfg.moe
            moe_bytes = 3 * tokens * m.top_k * m.capacity_factor * d \
                * dt * 2
        return p_bytes + a_bytes + att_bytes + lg_bytes + moe_bytes

    if shape.kind == "prefill":
        p_bytes = n_params * 2 * dt
        a_bytes = L * tokens * (d * dt + act_width * dt)
        kv_w = (cfg.n_kv_heads * cfg.d_head if cfg.mla is None else
                cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
        n_attn = L if cfg.family not in ("hybrid", "ssm") else (
            0 if cfg.family == "ssm" else
            (L // cfg.mamba2.attn_every + 1))
        bq = max(cfg.attn_block_q, 1)
        att_bytes = n_attn * B * (S / bq) * S * kv_w * 2 * dt
        lg_bytes = B * cfg.vocab_padded * 4
        moe_bytes = 0.0
        if cfg.moe is not None:
            m = cfg.moe
            moe_bytes = tokens * m.top_k * m.capacity_factor * d * dt * 2
        return p_bytes + a_bytes + att_bytes + lg_bytes + moe_bytes

    # decode: active params once (MoE: every expert slot that can be
    # hit; with B*k assignments >= E the whole expert set is touched)
    if cfg.moe is not None:
        m = cfg.moe
        hit = min(m.n_experts, B * m.top_k)
        per_layer_expert = 3 * d * m.d_expert
        n_moe_layers = L - m.first_k_dense
        p_bytes = (n_active - n_moe_layers * m.top_k * per_layer_expert
                   ) * dt + n_moe_layers * hit * per_layer_expert * dt
    else:
        p_bytes = n_params * dt
    # cache read (+1 token write)
    kv_w = (cfg.n_kv_heads * cfg.d_head * 2 if cfg.mla is None else
            cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
    if cfg.family == "ssm":
        xc = cfg.xlstm
        d_inner = int(xc.proj_factor * d)
        P = d_inner // cfg.n_heads
        cache_bytes = L * B * cfg.n_heads * P * P * 4 * 2
    elif cfg.family == "hybrid":
        mc = cfg.mamba2
        d_inner = mc.expand * d
        H = d_inner // mc.head_dim
        n_attn = L // mc.attn_every + 1
        cache_bytes = (L * B * H * mc.d_state * mc.head_dim * 4 * 2
                       + n_attn * B * S * kv_w * dt)
    elif cfg.family == "audio":
        cache_bytes = L * B * S * kv_w * dt * 2     # self + cross
    else:
        n_attn = L
        cache_bytes = n_attn * B * S * kv_w * dt
    act_bytes = L * B * act_width * dt * 3
    lg_bytes = B * cfg.vocab_padded * 4
    return p_bytes + cache_bytes + act_bytes + lg_bytes
