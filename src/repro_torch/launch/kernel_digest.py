"""A digest and the device time of kernel 15's output, to hold two
checkouts' kernels bitwise against each other on one card.

    PYTHONPATH=<checkout>/src python3 -P \\
        src/repro_torch/launch/kernel_digest.py

``vwr_mla_chunk_prefix_attend_q8`` (kernel 15) at chip_smoke.py's
headline shape (DeepSeek-V3 widths: a 64-token chunk of 128 heads, r 512,
rope 64, over 16 int8 pages of 16 with fp32 page scales; fp32 queries),
inputs from seed 15.  Prints one JSON line: the sha256 of the fp32
outputs (o_tilde, m, l) and the mean device ms of 20 launches (CUDA
events, each after a 64 MB write that evicts the L2).  The ``-P`` keeps
this file's directory off ``sys.path``, so ``PYTHONPATH`` names the
package whose kernel runs.  Needs a GPU.
"""
from __future__ import annotations

import hashlib
import json

import torch

from repro_torch.kernels import vwr_mla_decode as KM

C, H, R, RP, PS, J, N_PAGES, SEED = 64, 128, 512, 64, 16, 16, 64, 15


def main():
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qa = torch.randn(C, H, R, generator=g, device="cuda")
    qr = torch.randn(C, H, RP, generator=g, device="cuda")
    pools = [torch.randint(-127, 128, (N_PAGES, PS, w), generator=g,
                           device="cuda", dtype=torch.int8) for w in (R, RP)]
    scales = [torch.rand(N_PAGES, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in range(2)]
    table = torch.randperm(N_PAGES, generator=g,
                           device="cuda")[:J].to(torch.int32)
    counts = torch.full((J,), PS, dtype=torch.int32, device="cuda")

    def run():
        return KM.vwr_mla_chunk_prefix_attend_q8(
            qa, qr, *pools, *scales, table, counts, scale=(R + RP) ** -0.5)

    out = run()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in out:
        digest.update(t.contiguous().cpu().numpy().tobytes())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(20):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    print(json.dumps({"kernel": "vwr_mla_chunk_prefix_attend_q8",
                      "sha256": digest.hexdigest(), "ms": ms,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
