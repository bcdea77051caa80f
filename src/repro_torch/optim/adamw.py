"""AdamW with mixed-precision state, warmup + cosine schedule,
global-norm clipping and ZeRO-1: the counterpart of
``repro.optim.adamw``.

  * fp32 master copies when any parameter is not fp32 (bf16 weights),
  * m / v moments in ``moment_dtype`` (bf16 halves the optimizer memory),
  * global-norm clipping, then warmup + cosine decay,
  * weight decay on every leaf, as the JAX package applies it,
  * ZeRO-1: ``zero1_pspecs`` / ``opt_state_pspecs`` (the JAX package's
    rule) shard every optimizer-state leaf over the data axis on its
    largest dim that the axis divides.

The arithmetic is the JAX package's, step by step, in fp32.  ``update``
writes the parameters, the moments and the master copies in place
(under ``torch.no_grad()``, as the port writes its caches) and returns
them with a new step counter: the state passed in is consumed, as the
JAX step donates it.

Under a mesh with a data axis of D > 1 ranks (``init`` / ``update``
with ``mesh=``) every rank keeps the whole parameters (training has no
tensor-parallel layers yet, ROADMAP queue 1 item 14) and, with ``zero1``, only
its ``local_block`` of m, v and master under ``opt_state_pspecs``: about
1/D of the state.  ``update`` then takes the rank's blocks of the
data-reduced gradient (``launch.steps`` reduce-scatters them), updates
its blocks and all-gathers the new parameters, so every rank holds the
parameters of the one-device update.  The clip norm is the global norm
of the whole gradient: the squares of the owned blocks summed over the
data axis, a leaf that ZeRO-1 leaves whole (no dim the axis divides)
counted once.  ``gather_state`` / ``state_blocks`` move a state between
the whole layout of a checkpoint and a rank's blocks, leaf by leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.common.module import leaves, map_tree
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import PS


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


def _sharded(mesh) -> bool:
    return mesh is not None and SH.data_size(mesh) > 1


def init(cfg: OptConfig, params, mesh=None, zero1: bool = True
         ) -> OptState:
    """Zero moments beside each parameter, on its device; fp32 master
    copies when any parameter is not fp32.  Under a mesh with a data
    axis of more than one rank, each leaf of m, v and master is this
    rank's block under ``state_specs`` (whole where ``zero1`` is off or
    no dim divides)."""
    mdt = getattr(torch, cfg.moment_dtype)
    flat = [p for _, p in leaves(params)]
    needs_master = any(p.dtype != torch.float32 for p in flat)
    if not _sharded(mesh):
        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        master = (map_tree(lambda p: p.detach().to(torch.float32,
                                                    copy=True), params)
                  if needs_master else None)
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
            m=map_tree(zeros, params), v=map_tree(zeros, params),
            master=master)
    specs = state_specs(cfg, params, mesh, zero1).m

    def zeros_block(path, p):
        return torch.zeros(block_shape(p.shape, _at(specs, path), mesh),
                           dtype=mdt, device=p.device)

    def master_block(path, p):
        return SH.local_block(p.detach(), _at(specs, path), mesh).to(
            torch.float32, copy=True)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
        m=_map_paths(zeros_block, params), v=_map_paths(zeros_block, params),
        master=(_map_paths(master_block, params) if needs_master
                else None))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in leaves(tree)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _map_paths(fn, tree, prefix=()):
    """``tree``'s structure with each leaf ``x`` at ``path`` replaced by
    ``fn(path, x)``."""
    return {k: (_map_paths(fn, v, prefix + (k,)) if isinstance(v, dict)
                else fn(prefix + (k,), v)) for k, v in tree.items()}


@torch.no_grad()
def update(cfg: OptConfig, grads, state: OptState, params, mesh=None,
           zero1: bool = True):
    """Returns (params, state, {"grad_norm", "lr"}), the parameters and
    the state's tensors written in place.  Under a mesh with a data axis
    of more than one rank, ``grads`` and the state hold this rank's
    blocks under ``state_specs(cfg, params, mesh, zero1)`` (see the
    module docstring); without one it is the one-device update."""
    if _sharded(mesh):
        return _update_blocks(cfg, grads, state, params, mesh, zero1)
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


def _update_blocks(cfg: OptConfig, grads, state: OptState, params, mesh,
                   zero1: bool):
    """``update`` on this rank's blocks: the same arithmetic, the clip
    norm summed over the data axis, the new parameters all-gathered."""
    specs = state_specs(cfg, params, mesh, zero1).m
    owner = mesh.coord("data") == 0
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(leaves(params))[1].device)
    for path, g in leaves(grads):
        # a whole leaf is on every rank: rank 0 counts it
        if is_split(_at(specs, path)) or owner:
            sq += torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(mesh.all_reduce(sq, "data"))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for path, g in leaves(grads):
        spec = _at(specs, path)
        m, v, p = _at(state.m, path), _at(state.v, path), _at(params, path)
        ref = (SH.local_block(p, spec, mesh) if state.master is None
               else _at(state.master, path))
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
        new = p32.to(p.dtype)
        p.copy_(SH.gather_block(new, spec, mesh) if is_split(spec)
                else new)

    st = OptState(step=step, m=state.m, v=state.v, master=state.master)
    return params, st, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------- ZeRO-1

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def zero1_pspecs(param_pspec_tree, params_abstract, mesh,
                 dp_axis: str = "data"):
    """Shard optimizer-state copies of replicated dims over ``dp_axis``
    (the JAX package's rule): for each parameter spec, the largest dim
    whose entry is None and whose size the data-axis size divides takes
    ``dp_axis``; a spec that already names ``dp_axis`` stays.  Applied to
    m / v / master (ZeRO-1)."""
    n_dp = mesh.shape[dp_axis]

    def one(ps, aval):
        shape = tuple(aval.shape)
        entries = list(ps) + [None] * (len(shape) - len(ps))
        if any(dp_axis in _names(e) for e in entries):
            return PS(*entries)
        best, best_size = -1, 0
        for i, (e, n) in enumerate(zip(entries, shape)):
            if e is None and n % n_dp == 0 and n > best_size:
                best, best_size = i, n
        if best >= 0:
            entries[best] = dp_axis
        return PS(*entries)

    return _map_paths(lambda path, ps: one(ps, _at(params_abstract, path)),
                      param_pspec_tree)


def opt_state_pspecs(cfg: OptConfig, param_pspec_tree, params_abstract,
                     mesh, zero1: bool = True) -> OptState:
    """The optimizer state's spec tree: ``step`` replicated, m / v the
    ZeRO-1 specs (the parameters' with ``zero1`` off or no 'data' axis),
    master the same, or None when every parameter is fp32."""
    base = (zero1_pspecs(param_pspec_tree, params_abstract, mesh)
            if (zero1 and "data" in mesh.axis_names) else param_pspec_tree)
    needs_master = any(a.dtype != torch.float32
                       for _, a in leaves(params_abstract))
    return OptState(step=PS(), m=base, v=base,
                    master=(base if needs_master else None))


def replicated(params):
    """Every leaf's spec with no dim sharded: the port's parameters,
    whole on every rank."""
    return map_tree(lambda p: PS(*([None] * len(p.shape))), params)


def state_specs(cfg: OptConfig, params, mesh, zero1: bool = True
                ) -> OptState:
    """``opt_state_pspecs`` of the port's whole parameters on ``mesh``:
    the layout ``init`` / ``update`` keep the state in."""
    return opt_state_pspecs(cfg, replicated(params), params, mesh, zero1)


def is_split(spec) -> bool:
    return any(e is not None for e in spec)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor under
    ``spec``."""
    return tuple(SH.block_span(mesh, e, n)[1] if e is not None else n
                 for n, e in zip(shape, spec))


def gather_state(cfg: OptConfig, state: OptState, params, mesh,
                 keep: bool = True) -> OptState:
    """The whole state as host tensors, gathered leaf by leaf (one whole
    leaf on the card at a time): every rank of the data axis takes part
    in each gather, and only ranks with ``keep`` hold the results (the
    others get None leaves).  The layout of a one-device state, so a
    checkpoint of it restores on any mesh."""
    specs = state_specs(cfg, params, mesh).m

    def whole(tree):
        if tree is None:
            return None

        def one(path, t):
            w = SH.gather_block(t, _at(specs, path), mesh)
            return w.to("cpu", copy=True) if keep else None
        return _map_paths(one, tree)
    return OptState(step=state.step.to("cpu", copy=True), m=whole(state.m),
                    v=whole(state.v), master=whole(state.master))


def state_blocks(cfg: OptConfig, whole: OptState, params, mesh
                 ) -> OptState:
    """This rank's ZeRO-1 blocks of a whole state (host or device
    tensors) on the parameters' device: the inverse of
    ``gather_state``."""
    specs = state_specs(cfg, params, mesh).m
    dev = next(leaves(params))[1].device

    def cut(tree):
        if tree is None:
            return None
        return _map_paths(lambda path, t: SH.local_block(
            t, _at(specs, path), mesh).to(dev, copy=True), tree)
    return OptState(step=whole.step.to(dev, copy=True), m=cut(whole.m),
                    v=cut(whole.v), master=cut(whole.master))
