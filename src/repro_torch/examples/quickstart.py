"""Quickstart: build an assigned architecture, run a forward/train step,
inspect the Provet reproduction artifacts, launch a hand-written kernel.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``.  The model sections train on
the 'torch' backend (the kernels are forward-only, as the JAX package
trains on 'xla'); the last section runs ``ops.vwr_matmul`` on the GPU
(the CUDA kernel) unless ``--device cpu`` is given (its plain version);
with no GPU it raises rather than fall back.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common.module import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import ref_ops, templates
from repro_torch.core.machine import PAPER_EXAMPLE
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw


def main(device: str = "cuda") -> dict:
    """Runs and prints every section; returns their numbers."""
    device = resolve_device(device)
    res = {}

    # ---- 1. an assigned architecture (reduced) ---------------------------
    cfg = reduced(get_config("olmoe-1b-7b")).replace(kernel_impl="torch")
    print(f"arch: {cfg.name} family={cfg.family} "
          f"params={cfg.n_params()/1e6:.2f}M device={device}")
    params = lm.init(cfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens,
             "loss_mask": torch.ones(tokens.shape)}
    loss, metrics = lm.train_loss(params, batch, cfg)
    res["loss"] = float(loss)
    print(f"loss={res['loss']:.4f} "
          f"moe_drop={float(metrics['drop_frac']):.3f}")

    # ---- 2. one optimizer step -------------------------------------------
    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=100)
    step = build_train_step(cfg, opt_cfg)
    opt = adamw.init(opt_cfg, params)
    params, opt, m = step(params, opt, batch)
    res["step_loss"] = float(m["loss"])
    print(f"after 1 step: loss={res['step_loss']:.4f} "
          f"gnorm={float(m['grad_norm']):.2f}")

    # ---- 3. the paper's machine ------------------------------------------
    img = np.random.default_rng(0).standard_normal((1, 16, 16)).astype("f4")
    w = np.random.default_rng(1).standard_normal((1, 1, 5, 5)).astype("f4")
    out, machine = templates.conv2d(PAPER_EXAMPLE, img, w).run()
    res["isa_err"] = float(abs(out - ref_ops.conv2d_ref(img, w)).max())
    print(f"Provet ISA conv (section 6.1): maxerr={res['isa_err']:.2e} "
          f"cycles={machine.c.cycles} CMR={machine.cmr():.2f}")

    # ---- 4. a hand-written kernel (the CUDA kernel on the card) ----------
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(128, 256, generator=gen).to(device)
    wm = torch.randn(256, 128, generator=gen).to(device)
    y = ops.vwr_matmul(x, wm)
    res["matmul_err"] = float((y - x @ wm).abs().max())
    print(f"vwr_matmul on {device}: err={res['matmul_err']:.2e}")
    print("quickstart OK")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
