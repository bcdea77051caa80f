"""End-to-end training launcher: the counterpart of
``repro.launch.train``.

Wires together the config registry, init from a seed, the synthetic data
pipeline, AdamW, checkpoint / restart (``CheckpointStore`` holding
``{"params", "opt"}``: async every ``--ckpt-every`` steps, a final
synchronous save; a run resumes from the latest complete step), the
straggler monitor and the heartbeat.  Training runs on the 'torch'
backend (``kernel_impl="torch"``, printed in the header line): the
hand-written kernels are forward-only, as the JAX package trains on
'xla'.  The run is on the card unless ``--device cpu`` is given.  The
final line's tok/s counts the global tokens of the steps this run took
(a resumed run's, not the earlier ones').

Data-parallel training: ``--data-model D 1`` with D > 1 spawns a world
of D ranks itself (``launch.mesh.run_ranks``; gloo between ranks of one
card, nccl with a card each).  Every rank builds the
parameters from seed 0 (their digests are compared) and the same global
batches, and trains with ``build_train_step(..., mesh=)``: each rank
computes its rows and keeps its ZeRO-1 blocks of the optimizer state.
Rank 0 alone prints (the lines of ``1 1``), writes ``--metrics-out``,
keeps the heartbeat and the straggler monitor, and saves checkpoints:
the state's blocks are gathered leaf by leaf through the host into the
one-device layout, so a checkpoint restores on any ``--data-model``.
On restore every rank reads the whole file and keeps its blocks.  A
'model' axis > 1 (tensor-parallel layers) is ROADMAP queue 1 item 14.

Example (on the card, ~100M model):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduce width --steps 200 --batch 8 \\
        --seq 512 --ckpt ckpt/tiny
On the CPU, a few steps of a reduced config (over two gloo ranks with
``--data-model 2 1``):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduce smoke --steps 4 --batch 2 \\
        --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.common.config import ModelConfig
from repro_torch.common.module import leaves, map_tree, resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import ITEM_14_TP, build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.resilience import Heartbeat, StragglerMonitor


def width_reduce(cfg: ModelConfig, d_model: int = 512, layers: int = 8
                 ) -> ModelConfig:
    """~100M-class shrink that keeps the family structure."""
    kw = dict(name=cfg.name + "-100m", n_layers=layers, d_model=d_model,
              n_heads=8, n_kv_heads=max(1, 8 * cfg.n_kv_heads
                                        // max(cfg.n_heads, 1)),
              d_head=64, d_ff=(4 * d_model if cfg.d_ff else 0),
              vocab=8192, dtype="float32", logits_chunk=0)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=d_model,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            d_ff_dense=4 * d_model if cfg.moe.d_ff_dense else 0)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=128, kv_lora_rank=64, rope_head_dim=32,
            nope_head_dim=32, v_head_dim=64)
    if cfg.mamba2 is not None:
        kw["mamba2"] = dataclasses.replace(cfg.mamba2, head_dim=64,
                                           chunk=64, attn_every=3)
        kw["n_layers"] = 9
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=4,
                                          chunk=64)
    if cfg.frontend:
        kw["frontend_tokens"] = min(cfg.frontend_tokens, 32) or 32
        kw["frontend_dim"] = 64
    if cfg.enc_layers:
        kw["enc_layers"] = 4
    return cfg.replace(**kw)


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, seed=0):
    """step -> a numpy batch (SyntheticLM; vlm: ``frontend_tokens`` of the
    ``seq`` positions are frontend embeddings, audio: ``seq`` encoder
    frames), the JAX package's batches bit for bit."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))

    def get(step: int):
        b = data.batch(step)
        if cfg.family == "vlm":
            nf = cfg.frontend_tokens
            rng = np.random.default_rng(step)
            b = {"tokens": b["tokens"][:, : seq - nf],
                 "labels": b["labels"][:, : seq - nf],
                 "loss_mask": b["loss_mask"][:, : seq - nf],
                 "frontend_emb": rng.standard_normal(
                     (batch, nf, cfg.frontend_dim)).astype(np.float32)}
        elif cfg.family == "audio":
            rng = np.random.default_rng(step)
            b["frontend_emb"] = rng.standard_normal(
                (batch, seq, cfg.frontend_dim)).astype(np.float32)
        return b

    return get


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", choices=["none", "smoke", "width"],
                    default="width")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-model", type=int, nargs=2, default=None,
                    help="mesh shape (data, model); model must be 1")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _config(args) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.reduce == "smoke":
        cfg = reduced(cfg)
    elif args.reduce == "width":
        cfg = width_reduce(cfg)
    cfg = cfg.replace(n_microbatches=args.microbatches,
                      remat="none" if args.reduce != "none" else cfg.remat,
                      kernel_impl="torch")
    if cfg.mamba2 is not None or cfg.xlstm is not None:
        chunk = (cfg.mamba2 or cfg.xlstm).chunk
        if args.seq % chunk:
            raise ValueError(f"--seq {args.seq} is not a multiple of the "
                             f"recurrent chunk {chunk}")
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    _config(args)
    data, model = args.data_model or (1, 1)
    if model > 1:
        raise NotImplementedError(f"--data-model {data} {model}: "
                                  f"{ITEM_14_TP}")
    if data == 1:
        return _train(args)
    return run_ranks(_train_rank, data, 1, args=(args,),
                     device=args.device)


def _train_rank(mesh, args):
    """One rank of a data-parallel run: rank 0 prints, and its losses
    come back to the parent."""
    rank0 = mesh.coord("data") == 0
    with (contextlib.nullcontext() if rank0
          else contextlib.redirect_stdout(io.StringIO())):
        return _train(args, mesh)


def _params_digest(params) -> str:
    """sha256 over every leaf's path and bytes (host copies, one leaf at
    a time): equal on two ranks when they built the same parameters."""
    h = hashlib.sha256()
    for path, t in leaves(params):
        h.update("/".join(path).encode())
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _train(args, mesh=None):
    cfg = _config(args)
    rank0 = mesh is None or mesh.coord("data") == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"device {device}, kernel_impl={cfg.kernel_impl!r}")

    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    train_step = build_train_step(cfg, opt_cfg, mesh=mesh)
    params = lm.init(cfg, seed=0, device=device)
    if mesh is not None:
        digests = mesh.gather_objects(_params_digest(params))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks built different parameters "
                               f"from seed 0: {digests}")
        print(f"[train] data-parallel over {mesh.size} ranks "
              f"({mesh.transport}), ZeRO-1 optimizer state; the same "
              "parameters on every rank")
    opt_state = adamw.init(opt_cfg, params, mesh=mesh)

    store = CheckpointStore(args.ckpt) if args.ckpt else None
    start = 0
    if store is not None and store.latest_step() is not None:
        start = store.latest_step()
        if mesh is None:
            store.restore(start, {"params": params, "opt": opt_state})
        else:
            # every rank reads the whole state and keeps its blocks
            whole = adamw.init(opt_cfg, map_tree(
                lambda p: torch.empty(p.shape, dtype=p.dtype), params))
            store.restore(start, {"params": params, "opt": whole})
            opt_state = adamw.state_blocks(opt_cfg, whole, params, mesh)
            del whole
        print(f"[train] resumed from step {start}")

    def save(step, async_):
        if mesh is None:
            store.save(step, {"params": params, "opt": opt_state},
                       async_=async_)
            return
        # every rank takes part in the gathers; rank 0 keeps and writes
        whole = adamw.gather_state(opt_cfg, opt_state, params, mesh,
                                   keep=rank0)
        if rank0:
            store.save(step, {"params": params, "opt": whole},
                       async_=async_)

    get_batch = make_batch_fn(cfg, args.batch, args.seq)
    mon = StragglerMonitor() if rank0 else None
    hb = (Heartbeat(os.path.join(args.ckpt or tempfile.gettempdir(),
                                 "heartbeat.json")) if rank0 else None)
    losses = []

    t_start = time.time()
    for step in range(start, args.steps):
        if mon is not None:
            mon.start_step()
        batch = get_batch(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            losses.append((step, m["loss"]))
            print(f"  step {step:5d} loss={m['loss']:.4f} "
                  f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e}")
        if mon is not None:
            flag = mon.end_step()
            if flag:
                print(f"  [straggler] step {flag['step']} took "
                      f"{flag['dt']:.2f}s (median {flag['median']:.2f}s)")
            hb.beat(step)
        if store is not None and (step + 1) % args.ckpt_every == 0:
            save(step + 1, async_=True)
    if store is not None:
        save(args.steps, async_=False)
        store.wait()

    dt = time.time() - t_start
    if not losses:
        print(f"[train] done: step {start} reached, nothing to run")
        return losses
    toks = (args.steps - start) * args.batch * args.seq
    print(f"[train] done: {dt:.1f}s, {toks/dt:.0f} tok/s, "
          f"first loss {losses[0][1]:.4f} -> last {losses[-1][1]:.4f}")
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses, "tok_per_s": toks / dt}, f)
    return losses


if __name__ == "__main__":
    main()
