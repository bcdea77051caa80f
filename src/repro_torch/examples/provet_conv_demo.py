"""The paper's section 6.1 CONV mapping, end to end on the ISA machine:
layout -> instruction stream -> cycle/access counters -> section 7
metrics, plus the section 6.2 folding/packing variants, and the same
conv with a fused bias + relu epilogue on the port's conv kernel.

    PYTHONPATH=src python -m repro_torch.examples.provet_conv_demo [--device cpu]

Counterpart of ``examples/provet_conv_demo.py`` on the port's numpy-only
``core`` copy.  The last section runs ``ops.vwr_conv2d`` on the GPU (the
CUDA kernel) unless ``--device cpu`` is given (its plain version); with
no GPU it raises rather than fall back.  The machine's numbers are the
paper's analytical models, not H100 measurements.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import analysis, ref_ops, templates
from repro_torch.core.machine import PAPER_EXAMPLE, ProvetConfig
from repro_torch.kernels import ops


def main(device: str = "cuda") -> dict:
    """Runs and prints every section; returns their errors and counters."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("provet_conv_demo: no CUDA device; pass "
                           "--device cpu to run the conv's plain version")
    rng = np.random.default_rng(0)
    res = {}

    # --- the exact section 6.1 example -----------------------------------
    img = rng.standard_normal((1, 16, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 5, 5)).astype(np.float32)
    mp = templates.conv2d(PAPER_EXAMPLE, img, w)
    out, m = mp.run()
    res["6.1_err"] = float(abs(out - ref_ops.conv2d_ref(img, w)).max())
    res["6.1_instr_mix"] = dict(m.c.instr_mix)
    res["6.1_cycles"] = m.c.cycles
    print("section 6.1 conv: 5x5 kernel, 16x16 image, 16-lane VFU, "
          "64-op SRAM")
    print(f"  maxerr vs numpy: {res['6.1_err']:.2e}")
    print(f"  instruction mix: {m.c.instr_mix}")
    print(f"  cycles={m.c.cycles} sram R/W={m.c.sram_reads}/"
          f"{m.c.sram_writes} vwr R/W={m.c.vwr_reads}/{m.c.vwr_writes}")
    print(f"  CMR (eq.4) = {m.cmr():.2f}; utilization (eq.3) = "
          f"{m.utilization(mp.meta['total_macs']):.3f}")
    print(f"  energy = {m.c.energy_fj / 1e6:.2f} nJ")

    # --- section 6.2.1: image wider than the datapath --------------------
    img = rng.standard_normal((1, 8, 40)).astype(np.float32)
    w = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    parts = [(templates.conv2d(ProvetConfig(), s, w).run()[0], off)
             for s, off in templates.partition_image(img, 16, 3)]
    full = templates.stitch_strips(parts, 38)
    res["6.2.1_err"] = float(abs(full - ref_ops.conv2d_ref(img, w)).max())
    print(f"\nsection 6.2.1 partition: strips={len(parts)} "
          f"maxerr={res['6.2.1_err']:.2e}")

    # --- section 6.2.2: two images packed into the lanes -----------------
    imgs = [rng.standard_normal((1, 8, 6)).astype(np.float32)
            for _ in range(2)]
    packed, spans = templates.pack_width(imgs, 16, 3)
    out, _ = templates.conv2d(ProvetConfig(), packed, w).run()
    errs = [abs(out[:, :, o:o + wd - 2] - ref_ops.conv2d_ref(im, w)).max()
            for (o, wd), im in zip(spans, imgs)]
    res["6.2.2_err"] = float(max(errs))
    print(f"section 6.2.2 packing: 2 images, maxerr={res['6.2.2_err']:.2e}")

    # --- section 7 analytical suite --------------------------------------
    print("\nsection 7 suite (analytical):  layer   Provet_util  Provet_CMR")
    res["suite"] = {}
    for lname, r in analysis.run_suite().items():
        p = r["Provet"]
        res["suite"][lname] = (p.utilization, p.cmr)
        print(f"  {lname:<14} {p.utilization:10.3f} {p.cmr:10.1f}")

    # --- the same conv with the fused bias + relu epilogue ---------------
    # The port's conv kernel applies conv -> bias -> relu in its single
    # output store; the two-pass composition writes the conv, then reads
    # it back for the bias and the relu.
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 8)).astype(
        np.float32)).to(device)
    wt = torch.from_numpy(rng.standard_normal((3, 3, 8, 16)).astype(
        np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32)).to(
        device)
    fused = ops.vwr_conv2d(x, wt, b, activation="relu")
    two_pass = torch.relu(ops.vwr_conv2d(x, wt) + b)
    res["fused_err"] = float((fused - two_pass).abs().max())
    print(f"\nvwr_conv2d fused epilogue on {device}: maxerr vs two-pass = "
          f"{res['fused_err']:.2e} (one output store instead of three "
          "passes)")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
