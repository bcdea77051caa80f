"""Digests and device times of kernels 4, 5, 9, 10, 11, 13 and 15's
outputs, to hold two checkouts' kernels bitwise against each other on one
card.

    PYTHONPATH=<checkout>/src python3 -P \\
        src/repro_torch/launch/kernel_digest.py

Each case runs a kernel through its public wrapper at chip_smoke.py's
shapes, inputs from a seed of its own: ``vwr_flash_decode`` (kernel 4,
bf16: tinyllama's B4 T160 cache, one split a group, and B1 T2048, 8
splits), ``vwr_paged_flash_decode`` (kernel 5, bf16 pools: 8 slots, J 16
of 16, and a J 128 table), ``vwr_flash_decode_q8`` (kernel 9, the int8
cache at both dense shapes), ``vwr_mla_flash_decode`` (kernel 10, bf16:
DeepSeek-V3's B4 T160 cache at 144 keys, and B1 T2048),
``vwr_mla_paged_flash_decode`` and its ``_q8`` sibling (kernels 11 and
13, bf16 and int8 pools of 16: 8 slots at J 17, and a J 128 table) and
``vwr_mla_chunk_prefix_attend_q8`` (kernel 15: a 64-token chunk of 128
heads, r 512, rope 64, over 16 int8 pages of 16); the MLA kernels take
fp32 queries of 128 heads, r 512, rope 64.  Prints one JSON line a case:
the sha256 of the fp32 outputs (o_tilde, m, l) and the mean and median
device ms of 20 launches (CUDA events, each after a 64 MB write that
evicts the L2).  The ``-P`` keeps this file's directory off ``sys.path``,
so ``PYTHONPATH`` names the package whose kernels run.  Needs a GPU.
"""
from __future__ import annotations

import hashlib
import json
import statistics

import numpy as np
import torch

from repro_torch.kernels import vwr_decode as KD
from repro_torch.kernels import vwr_mla_decode as KM

PAGED_LENS = (0, 1, 16, 17, 255, 100, 200, 64)
LONG_LENS = (2048, 1900, 1500, 1024, 777, 2000, 100, 1)


def _table(g, lens, J, ps, n_pages):
    """Each slot's live pages a permuted page each, zero past them."""
    perm = torch.randperm(n_pages, generator=g, device="cuda").cpu()
    table = np.zeros((len(lens), J), np.int32)
    counts = np.zeros((len(lens), J), np.int32)
    k = 0
    for b, n in enumerate(lens):
        live = -(-n // ps)
        table[b, :live] = perm[k:k + live].numpy()
        counts[b, :live] = np.clip(n - ps * np.arange(live), 0, ps)
        k += live
    return torch.from_numpy(table).cuda(), torch.from_numpy(counts).cuda()


def _dense(g, B, T, n, q8):
    KV, G, D = 4, 8, 64
    q = torch.randn(B * KV, G, D, generator=g, device="cuda").bfloat16()
    if not q8:
        k, v = (torch.randn(B, T, KV, D, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        return lambda: KD.vwr_flash_decode(q, k, v, n)
    k, v = (torch.randint(-127, 128, (B, T, KV, D), generator=g,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B * KV, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in range(2))
    return lambda: KD.vwr_flash_decode_q8(q, k, v, ks, vs, n)


def _paged(g, lens, J, n_pages):
    KV, G, D, PS = 4, 8, 64, 16
    q = torch.randn(len(lens) * KV, G, D, generator=g,
                    device="cuda").bfloat16()
    k, v = (torch.randn(n_pages, PS, KV, D, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    table, counts = _table(g, lens, J, PS, n_pages)
    return lambda: KD.vwr_paged_flash_decode(q, k, v, table, counts)


def _mla_queries(g, B):
    return (torch.randn(B, 128, 512, generator=g, device="cuda"),
            torch.randn(B, 128, 64, generator=g, device="cuda"))


def _mla_dense(g, B, T, n):
    qa, qr = _mla_queries(g, B)
    ckv, kr = (torch.randn(B, T, w, generator=g, device="cuda").bfloat16()
               for w in (512, 64))
    return lambda: KM.vwr_mla_flash_decode(qa, qr, ckv, kr, n,
                                           scale=576 ** -0.5)


def _mla_paged(g, lens, J, n_pages, q8):
    qa, qr = _mla_queries(g, len(lens))
    if q8:
        pools = [torch.randint(-127, 128, (n_pages, 16, w), generator=g,
                               device="cuda", dtype=torch.int8)
                 for w in (512, 64)]
        scales = [torch.rand(n_pages, generator=g, device="cuda") * 0.02
                  + 1e-3 for _ in range(2)]
    else:
        pools = [torch.randn(n_pages, 16, w, generator=g,
                             device="cuda").bfloat16() for w in (512, 64)]
    table, counts = _table(g, lens, J, 16, n_pages)
    if q8:
        return lambda: KM.vwr_mla_paged_flash_decode_q8(
            qa, qr, *pools, *scales, table, counts, scale=576 ** -0.5)
    return lambda: KM.vwr_mla_paged_flash_decode(qa, qr, *pools, table,
                                                 counts, scale=576 ** -0.5)


def _chunk_q8(g):
    C, H, R, RP, PS, J, N_PAGES = 64, 128, 512, 64, 16, 16, 64
    qa = torch.randn(C, H, R, generator=g, device="cuda")
    qr = torch.randn(C, H, RP, generator=g, device="cuda")
    pools = [torch.randint(-127, 128, (N_PAGES, PS, w), generator=g,
                           device="cuda", dtype=torch.int8) for w in (R, RP)]
    scales = [torch.rand(N_PAGES, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in range(2)]
    table = torch.randperm(N_PAGES, generator=g,
                           device="cuda")[:J].to(torch.int32)
    counts = torch.full((J,), PS, dtype=torch.int32, device="cuda")
    return lambda: KM.vwr_mla_chunk_prefix_attend_q8(
        qa, qr, *pools, *scales, table, counts, scale=(R + RP) ** -0.5)


def _cases():
    """(kernel, shape, seed, a function of a generator that sets up the
    inputs and returns the call)."""
    return [
        ("vwr_flash_decode", "B4 T160 cur 144", 4,
         lambda g: _dense(g, 4, 160, 144, False)),
        ("vwr_flash_decode", "B1 T2048", 41,
         lambda g: _dense(g, 1, 2048, 2048, False)),
        ("vwr_paged_flash_decode", "8 slots, J 16 of 16", 5,
         lambda g: _paged(g, PAGED_LENS, 16, 1024)),
        ("vwr_paged_flash_decode", "8 slots, J 128 of 16", 51,
         lambda g: _paged(g, LONG_LENS, 128, 1200)),
        ("vwr_flash_decode_q8", "B4 T160 cur 144", 9,
         lambda g: _dense(g, 4, 160, 144, True)),
        ("vwr_flash_decode_q8", "B1 T2048", 91,
         lambda g: _dense(g, 1, 2048, 2048, True)),
        ("vwr_mla_flash_decode", "B4 T160 cur 144", 10,
         lambda g: _mla_dense(g, 4, 160, 144)),
        ("vwr_mla_flash_decode", "B1 T2048", 101,
         lambda g: _mla_dense(g, 1, 2048, 2048)),
        ("vwr_mla_paged_flash_decode", "8 slots, J 17 of 16", 11,
         lambda g: _mla_paged(g, PAGED_LENS, 17, 1024, False)),
        ("vwr_mla_paged_flash_decode", "8 slots, J 128 of 16", 111,
         lambda g: _mla_paged(g, LONG_LENS, 128, 1200, False)),
        ("vwr_mla_paged_flash_decode_q8", "8 slots, J 17 of 16", 13,
         lambda g: _mla_paged(g, PAGED_LENS, 17, 1024, True)),
        ("vwr_mla_paged_flash_decode_q8", "8 slots, J 128 of 16", 131,
         lambda g: _mla_paged(g, LONG_LENS, 128, 1200, True)),
        ("vwr_mla_chunk_prefix_attend_q8", "C64 H128, 16 pages of 16", 15,
         _chunk_q8),
    ]


def main():
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for kernel, shape, seed, make in _cases():
        run = make(torch.Generator(device="cuda").manual_seed(seed))
        out = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in out:
            digest.update(t.contiguous().cpu().numpy().tobytes())
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
        ms = [a.elapsed_time(b) for a, b in events]
        print(json.dumps({"kernel": kernel, "shape": shape,
                          "sha256": digest.hexdigest(),
                          "ms": sum(ms) / len(ms),
                          "median_ms": statistics.median(ms),
                          "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
