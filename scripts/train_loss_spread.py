"""Spread of chip_smoke phase 10 (e)'s loss fall over repeated runs.

Trains width_reduce(tinyllama-1.1b) in fp32 on the 'torch' backend for
50 steps (batch 8, seq 256, lr 1e-3, warm-up 5; the parameters from one
seed) again and again in one process, and prints each run's mean of the
first 5 and of the last 5 losses and the fall between them: first with
the default (non-deterministic) algorithms, then under
``torch.use_deterministic_algorithms(True)``.  The same seed and batches
every run, so any spread is the summation order's.

    PYTHONPATH=src python3 scripts/train_loss_spread.py --runs 8 --det-runs 3
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def train_once(cfg, opt_cfg, get, seed, device):
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    step = steps.build_train_step(cfg, opt_cfg)
    p = lm.init(cfg, seed=seed, device=device)
    o = adamw.init(opt_cfg, p)
    losses = []
    for s in range(50):
        p, o, m = step(p, o, get(s))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    head = statistics.mean(losses[:5])
    tail = statistics.mean(losses[-5:])
    return {"head": head, "tail": tail, "fall": head - tail,
            "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--det-runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    a = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    if a.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip() or smi.stderr.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cfg = train.width_reduce(get_config("tinyllama-1.1b")).replace(
        kernel_impl="torch", remat="none")
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    get = train.make_batch_fn(cfg, 8, 256)
    runs = {"default": [], "deterministic": []}
    for mode, n in (("default", a.runs), ("deterministic", a.det_runs)):
        if mode == "deterministic":
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
        for i in range(n):
            t0 = time.perf_counter()
            r = train_once(cfg, opt_cfg, get, a.seed, a.device)
            r["wall_s"] = time.perf_counter() - t0
            runs[mode].append(r)
            print(f"{mode} run {i}: first 5 {r['head']:.4f}, last 5 "
                  f"{r['tail']:.4f}, fall {r['fall']:.4f} "
                  f"({r['wall_s']:.1f} s)", flush=True)
    torch.use_deterministic_algorithms(False)
    summary = {mode: {"falls": [r["fall"] for r in rs],
                      "min": min((r["fall"] for r in rs), default=None),
                      "max": max((r["fall"] for r in rs), default=None)}
               for mode, rs in runs.items()}
    print(json.dumps(summary))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(runs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
