"""Where serving time goes on the GPU: a torch.profiler trace of one
prefill and a few decode steps of ``DecodeEngine`` at full width.

    PYTHONPATH=src python3 -m repro_torch.launch.trace \\
        --arch tinyllama-1.1b --kernel-impl cuda --cache paged-int8 \\
        --out trace.json
    PYTHONPATH=src python3 -m repro_torch.launch.trace \\
        --arch deepseek-v3-671b --n-layers 4 --cache paged

Batch 4, prompt 128, 8 decode steps, random weights from seed 0 (the
shapes ``chip_smoke.py`` serves), over the dense cache or, with
``--cache paged`` / ``paged-int8``, over page pools of 16 positions in
the model dtype / int8 (whole-batch block tables, as ``generate``
uses); ``--n-layers`` cuts the depth (the widths stay the published
ones).  Prints, for the prefill and for the decode steps: wall time,
summed device kernel time, the device's busy and idle shares of the
wall time, the number of device kernels launched, and kernel time by
name (largest first).  Writes the same as JSON to ``--out``.  Needs a
GPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.engine import DecodeEngine, EngineConfig

BATCH, PROMPT, STEPS, SEED = 4, 128, 8, 0


def _kernel_times(prof):
    """{name: (device microseconds, calls)} over the events that ran on
    the device (the host-side ``aten::`` ops that launched them also
    carry their device time, and are left out so nothing counts twice)."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            out[evt.key] = (float(us), int(evt.count))
    return out


def _window(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _kernel_times(prof)
    busy_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return result, {
        "wall_us": wall_us, "device_busy_us": busy_us,
        "busy_share": busy_us / wall_us, "idle_share": 1 - busy_us / wall_us,
        "launches": sum(n for _, n in kernels.values()),
        "kernels": [{"name": k, "us": us, "calls": n}
                    for k, (us, n) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--kernel-impl", default="cuda")
    ap.add_argument("--cache", default="dense",
                    choices=("dense", "paged", "paged-int8"))
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    paged = args.cache != "dense"
    eng = DecodeEngine(cfg, EngineConfig(
        batch=BATCH, max_len=PROMPT + STEPS + 1,
        kernel_impl=args.kernel_impl, paged=paged,
        kv_dtype="int8" if args.cache == "paged-int8" else "bf16"),
        seed=SEED)
    table = eng.default_block_table() if paged else None
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=g, device="cuda", dtype=torch.int32)
    eng.generate({"tokens": prompts}, gen=STEPS)          # warm-up

    (logits, cache), pre = _window(
        lambda: eng.prefill({"tokens": prompts}))
    tok = logits.argmax(-1).to(torch.int32)

    def decode():
        nonlocal tok, cache
        for i in range(STEPS):
            lg, cache = eng.decode_step(tok, PROMPT + i, cache,
                                        block_table=table)
            tok = lg.argmax(-1).to(torch.int32)

    _, dec = _window(decode)
    report = {"arch": args.arch, "n_layers": cfg.n_layers, "batch": BATCH,
              "prompt": PROMPT, "steps": STEPS,
              "kernel_impl": args.kernel_impl, "cache": args.cache,
              "device": torch.cuda.get_device_name(0),
              "prefill": pre, "decode": dec}
    for phase in ("prefill", "decode"):
        r = report[phase]
        print(f"{args.arch} {args.kernel_impl} {args.cache} {phase}: "
              f"wall {r['wall_us'] / 1e3:.3f} ms, device busy "
              f"{r['device_busy_us'] / 1e3:.3f} ms "
              f"(idle share {r['idle_share']:.3f}), {r['launches']} "
              "kernels launched")
        for k in r["kernels"][:8]:
            print(f"    {k['us'] / 1e3:9.3f} ms {k['calls']:6d}x "
                  f"{k['name'][:90]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
