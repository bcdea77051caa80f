"""AdamW with mixed-precision state, warmup + cosine schedule and
global-norm clipping: the counterpart of ``repro.optim.adamw`` on one
device.

  * fp32 master copies when any parameter is not fp32 (bf16 weights),
  * m / v moments in ``moment_dtype`` (bf16 halves the optimizer memory),
  * global-norm clipping, then warmup + cosine decay,
  * weight decay on every leaf, as the JAX package applies it.

The arithmetic is the JAX package's, step by step, in fp32.  ``update``
writes the parameters, the moments and the master copies in place
(under ``torch.no_grad()``, as the port writes its caches) and returns
them with a new step counter: the state passed in is consumed, as the
JAX step donates it.  The ZeRO-1 sharding of the optimizer state
(``zero1_pspecs`` / ``opt_state_pspecs`` in the JAX package) is
distributed training: ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.common.module import leaves, map_tree


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # bfloat16 halves optimizer memory
    master_dtype: str = "float32"      # fp32 master copies of bf16 params


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any
    master: Any          # fp32 params, or None when every param is fp32


def schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int or a tensor): linear warmup,
    then cosine decay to ``min_lr_frac * lr``; fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: OptConfig, params) -> OptState:
    """Zero moments beside each parameter, on its device; fp32 master
    copies when any parameter is not fp32."""
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    flat = [p for _, p in leaves(params)]
    needs_master = any(p.dtype != torch.float32 for p in flat)
    master = (map_tree(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if needs_master else None)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
        m=map_tree(zeros, params), v=map_tree(zeros, params),
        master=master)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in leaves(tree)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def update(cfg: OptConfig, grads, state: OptState, params):
    """Returns (params, state, {"grad_norm", "lr"}), the parameters and
    the state's tensors written in place."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for path, g in leaves(grads):
        m, v, p = _at(state.m, path), _at(state.v, path), _at(params, path)
        ref = p if state.master is None else _at(state.master, path)
        g = g.to(torch.float32) * clip
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + g * g * (1 - cfg.b2)
        upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        p32 = ref.to(torch.float32)
        p32 = p32 - lr * (upd + cfg.weight_decay * p32)
        m.copy_(m32)
        v.copy_(v32)
        if state.master is not None:
            ref.copy_(p32)
        p.copy_(p32)

    st = OptState(step=step, m=state.m, v=state.v, master=state.master)
    return params, st, {"grad_norm": gnorm, "lr": lr}
