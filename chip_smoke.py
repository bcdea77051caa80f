#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, the exit is non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/csrc`` (into ``build/repro_torch``);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus ragged edges, bias, G = 1, bf16 and fp32;
   for the paged kernels permuted block tables, slots of length 0, 1,
   16, 17 and 255, int8 pools with random scales; kernel 9 at kernel
   4's shapes over int8 caches with (B*KV,) scales; the attention,
   decode and chunk kernels at the reduced configs' head dim 16, zero-
   padded by their wrappers, and decode groups of 32 and 40 query rows,
   launched in slices of 16; every MLA kernel at the reduced r 16 /
   rope 8) and time kernel, plain version and one PyTorch library call;
3. serve tinyllama-1.1b at full width (22 layers, d 2048, vocab 32000,
   bf16, random weights from a seed) through ``DecodeEngine.generate``
   on the kernels (after one warm-up generate), with every launch counter
   set to 0 just before the timed generate and read just after; then replay the same token stream teacher-forced
   through the plain 'torch' backend and hold each step's logits to it
   (the random weights are rescaled to a well-conditioned model first),
   and run kernel 9 through ``dist.decode.local_decode_attend`` with
   scales over the replay's dense cache quantized one scale a (batch,
   KV head) row, against dequantize-then-attend (its launches counted);
   the same for reduced fp32 configs, at a tight tolerance;
4. the same for qwen1.5-0.5b at full width (QKV bias, MHA, tied vocab);
5. continuous batching on the paged pools: on reduced fp32 configs the
   Scheduler's greedy streams on the kernels equal the plain backend's
   (model-dtype and int8 pools, a stream that preempts); then
   full-width tinyllama-1.1b through the ``Scheduler`` (8 slots, 128
   pages of 16, 24 requests with prompts of 32-256 tokens and gen 32,
   8 submitted at once and 2 more every 4 steps), once with bf16 and
   once with int8 pools: every request FINISHED, every page free after
   the drain, the paged kernel launched 22 times a decode step, the
   dense decode kernel never, ``vwr_attention`` 22 times a (batch-1)
   prefill; the same stream again with 40 pages held, where growth must
   preempt and every request still finish; 4 requests replayed
   teacher-forced and held against the plain path; steps, preemptions,
   peak pages, table widths, generated tokens/s and p50/p99 latency and
   ITL printed;
6. the prefix cache and chunked prefill: kernels 6 and 8 are held and
   timed in phase 2 (tinyllama's 64-token chunk over 16 pages, partial
   and masked pages, the first chunk, C 1, qwen's G 1, D 32 and 128,
   fp32, page 8, int8 pools, tables past the pool); on reduced fp32
   configs the prefix + chunked Scheduler streams on the kernels equal
   the plain backend's (unchunked ones for model-dtype pools); at full
   width, tinyllama-1.1b layer 0's chunk rows through
   ``chunk_prefill_attend`` and ``local_chunk_prefix_attend`` (the
   phase whose launches of kernels 6 and 8 are counted), a 256-token
   prompt's final-chunk logits through ``lm.prefill_chunk`` against the
   plain path, then the shared-prompt stream (16 of 24 requests open
   with one 128-token system prompt) through the Scheduler in six
   prefix / chunked modes, launch counts checked, the on/on streams
   replayed teacher-forced (each step whose pick is not the served
   token printed with its logit gaps beside its error);
7. the moe family: kernels 10, 14 (dense latent cache) and 11, 13
   (latent page pools, int8 with page scales) are held and timed in
   phase 2 at DeepSeek-V3's widths (H 128, r 512, rope 64); on reduced
   fp32 deepseek-v3 (MLA) and olmoe (GQA) ``generate`` and the
   Scheduler's streams (model-dtype and int8 pools) on the kernels
   equal the plain path's; then deepseek-v3-671b at full width cut to
   4 layers (3 dense, 1 MoE of 256 experts; bf16, ~30 GB of random,
   conditioned weights): ``generate`` (batch 4, prompt 128, gen 32;
   kernel 10 four times a decode step) teacher-forced against the plain
   path with the routing of both compared, kernel 14 through
   ``dist.decode.local_mla_decode_attend`` over generate's latent cache
   quantized per sequence, and the Scheduler stream of phase 5 on bf16
   and int8 latent pools (kernels 11 and 13), its requests replayed in
   the live slots through both paths;
8. the prefix cache and chunked prefill of the MLA families: kernels 12
   and 15 (a chunk's C tokens against its prior latent pages, one (J,)
   table) are held and timed in phase 2 at DeepSeek-V3's widths (a
   64-token chunk over 16 pages of 16, a partial page, a count-0 page,
   a first chunk, C 1, fp32 pools, a table entry past the pool); on
   reduced fp32 deepseek-v3, olmoe and a dense config with MLA the
   prefix + chunked Scheduler streams on the kernels equal the plain
   path's (both pools); then deepseek-v3-671b at depth 4 serves the
   shared-prompt stream of phase 6 with the prefix cache and chunked
   prefill on (chunks of 64) on bf16 and int8 latent pools (kernel 11 or
   13 four times a decode or mixed step), every request finished and
   every page but the trie's free; kernels 12 and 15 run through
   ``chunk_prefix_mla_paged{,_q8}`` on the stream's system-prompt pages
   with each layer's true queries (the phase whose launches of 12 and
   15 are counted), and 8 requests are replayed, prompts in chunks,
   through both paths with the routing rule of phase 7.  A chunk or a
   suffix is its own MoE group, whose capacity (1.25 x its tokens x 8 /
   256) drops otherwise than the whole prompt's, so the chunked streams
   are held against the plain path's chunked ones, not the unchunked;
9. the paper's CNN path (``core``, ``configs.provet_cnn``, kernels 16
   ``vwr_conv2d`` and 17 ``vwr_depthwise``): phase 2 holds both against
   their plain versions at the JAX tests' ragged shapes (C 7 / 3, F 5 /
   9, 1x1, 5x5 and 7x7 taps, H_out and W_out off the tile, every
   epilogue with and without bias) and at every stride-1 layer of the
   suite (N 1 and 32, bf16 and fp32), each timed beside its bound, its
   plain version and cuDNN; here the suite runs through
   ``ops.vwr_conv2d`` (bias + relu) and ``ops.vwr_depthwise``, and the
   section 6.1 demo on the card, launches counted, outputs held against
   the plain versions, and the fused bias + relu conv is timed against
   the conv followed by separate bias and relu passes; RN_112x112
   (stride 2) and AN_55x55 (stride 4) are printed as not covered;
10. print ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

The reduced fp32 configs of phases 3-8 run at the CPU tests' widths
(head dim 16; MLA rank 16, rope 8): the kernel wrappers zero-pad them to
the kernels' widths.  Their greedy Scheduler streams equal the plain
path's; on int8 pools, where the pool write's int8 rounding can turn a
last-bit difference of two fp32 products into a step of the page's
scale and so part two streams at a near-tie, a stream that parts is
replayed with the plain path's tokens through both paths, the plain path
reading the kernel path's int8 pages, and held at the fp32 logits
tolerance to its end (``_hold_streams``).

Details go to ``chiprun_out/chip_smoke.json``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is
# max(operations / peak rate of their type, bytes / memory rate)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of a kernel against its plain version on the same inputs.
# fp32: both accumulate in fp32, only the order of the sums differs.
# bf16 outputs: that plus one rounding of the output to bf16 (2^-8).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}   # atol, rtol
# End to end, teacher-forced logits of the kernel path against the plain
# path, both relative to the logits' scale.  fp32 reduced configs: 1e-3;
# these random models amplify fp32 rounding (the JAX package's own fp32
# logits are 1.6e-4 from a float64 evaluation on the CPU, and two fp32
# paths on the card differed by 1.3e-4 of scale), and the greedy tokens
# must still be identical.  bf16 full-width configs: 5e-2, since the
# two paths round to bf16 at different points in each of 22-24 layers.
E2E_FP32_TOL = 1e-3
E2E_BF16_REL = 5e-2
# int8 chunk rows through kernel 8 against the same math on the
# dequantized pools: fp32 against fp32 on the same int8 pages, only the
# order of the sums differs (as TOL's fp32 atol)
CHUNK_Q8_REL = 1e-4


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def time_ms(torch, fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after a 64 MB write that evicts the 50 MB L2 (the main
    path finds every weight cold).  A ~0.5 ms device sleep ahead of each
    launch keeps the device behind the host, so the events time queued
    device work, not the host's launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    events = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    for a, b in events:
        total += a.elapsed_time(b)
    return total / reps


def bound_ms(flops, nbytes, dtype):
    return 1e3 * max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def check_kernels(torch, F):
    from repro_torch.kernels import vwr_attention as KA
    from repro_torch.kernels import vwr_chunk as KC
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_matmul as KM

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def compare(name, shape, dtype, got, want):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        got, want = [t if isinstance(t, tuple) else (t,) for t in
                     (got, want)]
        err, excess = 0.0, 0.0
        for g, w in zip(got, want):
            d = (g.float() - w.float()).abs()
            err = max(err, d.max().item())
            excess = max(excess, (d - atol - rtol * w.float().abs()).max()
                         .item())
        ok = excess <= 0
        print(f"  {name:18s} {shape:34s} {str(dtype)[6:]:9s} "
              f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape} {dtype}: kernel "
                                 "disagrees with its plain version")
        return err

    results = []

    def record(kernel, label, shape, dtype, err, fn, plain, library,
               flops, nbytes, headline=False, op_dtype=None):
        """``op_dtype``: the type the operations run in, for the bound
        (the input dtype unless given)."""
        ms = time_ms(torch, fn)
        ops_t = str(op_dtype or dtype)[6:]
        row = {"kernel": kernel, "case": label, "shape": shape,
               "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": time_ms(torch, plain),
               "library_ms": (None if library is None
                              else time_ms(torch, library)),
               "bound_ms": bound_ms(flops, nbytes, ops_t),
               "bound_by": ("operations" if flops / PEAK_FLOPS[ops_t]
                            > nbytes / PEAK_BYTES else "bytes"),
               "headline": headline}
        results.append(row)
        print(f"    {label}: kernel {ms:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, library {row['library_ms']} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")

    # ---- vwr_matmul: act(x @ w + bias) + residual ----
    print("vwr_matmul")
    mm_cases = [
        # label, M, K, N, dtype, bias, residual, act, timed, headline
        ("tinyllama q", 512, 2048, 2048, bf16, False, False, None, True, False),
        ("tinyllama k/v", 512, 2048, 256, bf16, False, False, None, True, False),
        ("tinyllama o+res", 512, 2048, 2048, bf16, False, True, None, True, False),
        ("tinyllama down+res", 512, 5632, 2048, bf16, False, True, None, True, True),
        ("tinyllama decode down", 4, 5632, 2048, bf16, False, False, None, True, False),
        ("qwen qkv+bias", 512, 1024, 1024, bf16, True, False, None, True, False),
        ("qwen decode down", 4, 2816, 1024, bf16, False, False, None, True, False),
        ("fp32 k/v", 512, 2048, 256, f32, False, False, None, False, False),
        ("ragged gelu", 100, 130, 50, f32, True, True, "gelu", False, False),
        ("ragged relu", 77, 200, 333, bf16, True, False, "relu", False, False),
        ("ragged silu", 5, 70, 19, f32, False, True, "silu", False, False),
        ("ragged silu", 5, 72, 24, bf16, True, True, "silu", False, False),
    ]
    for label, M, K, N, dt, has_b, has_r, act, timed, head in mm_cases:
        x = randn(M, K, dtype=dt)
        w = randn(K, N, dtype=dt, scale=K ** -0.5)
        b = randn(1, N, dtype=dt) if has_b else None
        r = randn(M, N, dtype=dt) if has_r else None
        shape = f"{M}x{K}x{N}" + ("+bias" if has_b else "") + (
            "+res" if has_r else "") + (f"+{act}" if act else "")
        got = KM.vwr_matmul(x, w, b, r, activation=act)
        torch.cuda.synchronize()
        err = compare("vwr_matmul", shape, dt, got,
                      KM.vwr_matmul_ref(x, w, b, r, activation=act))
        if timed:
            elt = x.element_size()
            nbytes = elt * (M * K + K * N + M * N * (2 if has_r else 1)
                            + (N if has_b else 0))
            lib = None
            if act is None and not (has_b and has_r):
                add = b if has_b else r
                lib = ((lambda: torch.matmul(x, w)) if add is None
                       else (lambda: torch.addmm(add, x, w)))
            record("vwr_matmul", label, shape, dt, err,
                   lambda: KM.vwr_matmul(x, w, b, r, activation=act),
                   lambda: KM.vwr_matmul_ref(x, w, b, r, activation=act),
                   lib, 2 * M * K * N, nbytes, head)

    # ---- vwr_swiglu: silu(x @ wg) * (x @ wi) ----
    print("vwr_swiglu")
    sw_cases = [
        ("tinyllama gate/up", 512, 2048, 5632, bf16, True, True),
        ("tinyllama decode", 4, 2048, 5632, bf16, True, False),
        ("qwen gate/up", 512, 1024, 2816, bf16, True, False),
        ("fp32", 64, 256, 512, f32, False, False),
        ("ragged", 37, 100, 70, f32, False, False),
        ("ragged", 37, 104, 72, bf16, False, False),
    ]
    for label, M, K, N, dt, timed, head in sw_cases:
        x = randn(M, K, dtype=dt)
        wg = randn(K, N, dtype=dt, scale=K ** -0.5)
        wi = randn(K, N, dtype=dt, scale=K ** -0.5)
        shape = f"{M}x{K}x{N}"
        got = KM.vwr_swiglu(x, wg, wi)
        torch.cuda.synchronize()
        err = compare("vwr_swiglu", shape, dt, got,
                      KM.vwr_swiglu_ref(x, wg, wi))
        if timed:
            record("vwr_swiglu", label, shape, dt, err,
                   lambda: KM.vwr_swiglu(x, wg, wi),
                   lambda: KM.vwr_swiglu_ref(x, wg, wi),
                   lambda: F.silu(x @ wg) * (x @ wi),
                   4 * M * K * N,
                   x.element_size() * (M * K + 2 * K * N + M * N), head)

    # ---- vwr_attention: causal, zero-copy GQA ----
    print("vwr_attention")
    at_cases = [
        ("tinyllama prefill", 4, 128, 32, 4, 64, bf16, True, True),
        ("qwen prefill (G=1)", 4, 128, 16, 16, 64, bf16, True, False),
        ("ragged S", 2, 100, 8, 2, 64, f32, False, False),
        ("ragged S", 1, 200, 4, 1, 64, bf16, False, False),
        ("D=128", 1, 70, 4, 2, 128, f32, False, False),
        ("D=32", 2, 33, 2, 2, 32, bf16, False, False),
        ("D=16 (reduced, padded)", 2, 33, 4, 2, 16, f32, False, False),
        ("D=16 (reduced, padded)", 1, 40, 4, 4, 16, bf16, False, False),
    ]
    for label, B, S, H, KV, D, dt, timed, head in at_cases:
        q = randn(B, S, H, D, dtype=dt)
        k = randn(B, S, KV, D, dtype=dt)
        v = randn(B, S, KV, D, dtype=dt)
        shape = f"B{B} S{S} H{H} KV{KV} D{D}"
        got = KA.vwr_attention(q, k, v)
        torch.cuda.synchronize()
        err = compare("vwr_attention", shape, dt, got,
                      KA.vwr_attention_ref(q, k, v))
        if timed:
            G = H // KV
            # the library call gets the heads expanded outside its time
            qt = q.transpose(1, 2)
            kt, vt = (t.transpose(1, 2).repeat_interleave(G, 1)
                      for t in (k, v))
            record("vwr_attention", label, shape, dt, err,
                   lambda: KA.vwr_attention(q, k, v),
                   lambda: KA.vwr_attention_ref(q, k, v),
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True),
                   4 * B * H * D * S * (S + 1) // 2,
                   q.element_size() * 2 * B * S * D * (H + KV), head)

    # ---- vwr_flash_decode: unnormalized partials vs a dense cache ----
    print("vwr_flash_decode")
    dc_cases = [
        # label, B, T, KV, G, D, cur_len, pos0, dtype, timed, headline
        ("tinyllama decode", 4, 160, 4, 8, 64, 144, 0, bf16, True, True),
        ("tinyllama decode full", 4, 160, 4, 8, 64, 160, 0, bf16, False, False),
        ("qwen decode (G=1)", 4, 136, 16, 1, 64, 130, 0, bf16, True, False),
        ("ragged slab", 2, 77, 2, 4, 64, 50, 5, f32, False, False),
        ("masked row", 2, 40, 2, 4, 64, 3, 10, f32, False, False),
        ("D=128 G=16", 1, 65, 1, 16, 128, 65, 0, f32, False, False),
        ("D=32 G=3", 3, 33, 2, 3, 32, 20, 0, bf16, False, False),
        ("D=16 G=4 (reduced, padded)", 2, 40, 1, 4, 16, 37, 0, f32, False,
         False),
        ("D=16 G=32 (2 launches)", 2, 40, 2, 32, 16, 37, 0, bf16, False,
         False),
        ("D=64 G=40 (3 launches)", 1, 70, 1, 40, 64, 66, 2, f32, False,
         False),
    ]
    for label, B, T, KV, G, D, cur, pos0, dt, timed, head in dc_cases:
        q = randn(B * KV, G, D, dtype=dt)
        k = randn(B, T, KV, D, dtype=dt)
        v = randn(B, T, KV, D, dtype=dt)
        shape = f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0}"
        got = KD.vwr_flash_decode(q, k, v, cur, pos0)
        torch.cuda.synchronize()
        # fp32 partials whatever the input type
        err = compare("vwr_flash_decode", shape, f32, got,
                      KD.vwr_flash_decode_ref(q, k, v, cur, pos0))
        if label == "masked row" and got[2].abs().max().item() != 0.0:
            raise AssertionError("a group with no valid key must give l=0")
        if timed:
            n = max(0, min(T, cur - pos0))
            qs = q.reshape(B, KV * G, 1, D)
            ks = k[:, :n].transpose(1, 2).repeat_interleave(G, 1)
            vs = v[:, :n].transpose(1, 2).repeat_interleave(G, 1)
            elt = q.element_size()
            record("vwr_flash_decode", label, shape, dt, err,
                   lambda: KD.vwr_flash_decode(q, k, v, cur, pos0),
                   lambda: KD.vwr_flash_decode_ref(q, k, v, cur, pos0),
                   lambda: F.scaled_dot_product_attention(qs, ks, vs),
                   4 * B * KV * G * D * n,
                   elt * (B * KV * G * D + 2 * B * n * KV * D)
                   + 4 * B * KV * G * (D + 2), head)

    # ---- vwr_flash_decode_q8: the same over an int8 cache, (B*KV,) scales
    print("vwr_flash_decode_q8")
    for label, B, T, KV, G, D, cur, pos0, dt, timed, head in dc_cases:
        q = randn(B * KV, G, D, dtype=dt)
        k, v = [torch.randint(-127, 128, (B, T, KV, D), generator=gen,
                              device="cuda", dtype=torch.int8)
                for _ in range(2)]
        ks, vs = [torch.rand(B * KV, generator=gen, device="cuda") * 0.02
                  + 1e-3 for _ in range(2)]
        args = (q, k, v, ks, vs, cur, pos0)
        shape = f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0}"
        got = KD.vwr_flash_decode_q8(*args)
        torch.cuda.synchronize()
        err = compare("vwr_flash_decode_q8", shape, f32, got,
                      KD.vwr_flash_decode_q8_ref(*args))
        if label == "masked row" and got[2].abs().max().item() != 0.0:
            raise AssertionError("a group with no valid key must give l=0")
        if timed:
            n = max(0, min(T, cur - pos0))
            qs = q.reshape(B, KV * G, 1, D)

            def library(q=qs, k=k, v=v, ks=ks, vs=vs, n=n, B=B, KV=KV,
                        dt=dt):
                """Dequantize the valid rows, then SDPA (GQA)."""
                kd, vd = [(x[:, :n].to(dt) * s.reshape(B, 1, KV, 1).to(dt)
                           ).transpose(1, 2) for x, s in ((k, ks), (v, vs))]
                return F.scaled_dot_product_attention(q, kd, vd,
                                                      enable_gqa=True)
            record("vwr_flash_decode_q8", label, shape, dt, err,
                   lambda: KD.vwr_flash_decode_q8(*args),
                   lambda: KD.vwr_flash_decode_q8_ref(*args), library,
                   4 * B * KV * G * D * n,
                   q.element_size() * B * KV * G * D + 2 * B * n * KV * D
                   + 8 * B * KV + 4 * B * KV * G * (D + 2), head)

    # ---- vwr_paged_flash_decode[_q8]: partials through a block table ----
    tiny_lens = (0, 1, 16, 17, 255, 100, 200, 64)
    pg_cases = [
        # label, B, KV, G, D, page_size, n_pages, J, lens, dtype, timed,
        # headline
        ("tinyllama 8 slots", 8, 4, 8, 64, 16, 1024, 16, tiny_lens, bf16,
         True, True),
        ("qwen 8 slots (G=1)", 8, 16, 1, 64, 16, 1024, 16, tiny_lens, bf16,
         True, False),
        ("fp32", 4, 4, 8, 64, 16, 256, 16, (255, 0, 17, 16), f32, False,
         False),
        ("D=32 G=3", 3, 2, 3, 32, 16, 64, 6, (5, 0, 90), bf16, False,
         False),
        ("D=128 G=16", 2, 1, 16, 128, 16, 64, 5, (33, 64), f32, False,
         False),
        ("page 8, wide table", 3, 2, 4, 64, 8, 128, 12, (1, 40, 9), bf16,
         False, False),
        ("D=16 G=4 (reduced, padded)", 3, 1, 4, 16, 8, 12, 6, (40, 0, 9),
         f32, False, False),
        ("D=16 G=32 (2 launches)", 2, 2, 32, 16, 8, 32, 6, (33, 17), bf16,
         False, False),
    ]
    for q8 in (False, True):
        kname = "vwr_paged_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        for (label, B, KV, G, D, ps, n_pages, J, lens, dt, timed,
             head) in pg_cases:
            q = randn(B * KV, G, D, dtype=dt)
            shape = (n_pages, ps, KV, D)
            if q8:
                pools = [torch.randint(-127, 128, shape, generator=gen,
                                       device="cuda", dtype=torch.int8)
                         for _ in range(2)]
                scales = [torch.rand((n_pages, KV), generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                pools = [randn(*shape, dtype=dt) for _ in range(2)]
                scales = []
            table, counts, live = _paged_table(torch, gen, lens, J, ps,
                                               n_pages)
            ops_ = (q, *pools, *scales, table, counts)
            fn = KD.vwr_paged_flash_decode_q8 if q8 \
                else KD.vwr_paged_flash_decode
            ref = KD.vwr_paged_flash_decode_q8_ref if q8 \
                else KD.vwr_paged_flash_decode_ref
            shape_s = (f"B{B} KV{KV} G{G} D{D} ps{ps} J{J} "
                       f"pages{n_pages} lens{max(lens)}")
            got = fn(*ops_)
            torch.cuda.synchronize()
            err = compare(kname, shape_s, f32, got, ref(*ops_))
            for b, n in enumerate(lens):
                if n == 0 and got[2][b * KV:(b + 1) * KV].abs().max() != 0:
                    raise AssertionError("a slot with no valid key must "
                                         "give l=0")
            if timed:
                # the kernel reads only the valid keys of a live page,
                # but both scales of every live (page, head)
                n_keys = sum(lens)
                pool_elt = pools[0].element_size()
                nbytes = (pool_elt * 2 * n_keys * KV * D
                          + (8 * live * KV if q8 else 0)
                          + q.element_size() * q.numel()
                          + 8 * B * J + 4 * B * KV * G * (D + 2))
                record(kname, label, shape_s, dt, err,
                       lambda: fn(*ops_), lambda: ref(*ops_),
                       _paged_sdpa(torch, F, q, pools, scales, table,
                                   counts, KV, G, D),
                       4 * KV * G * D * n_keys, nbytes, head)

    # ---- vwr_chunk_prefix_attend[_q8]: a prompt chunk vs its prior pages ----
    ck_cases = [
        # label, KV, G, D, page_size, C, counts, dtype, timed, headline
        ("tinyllama chunk 64, 16 pages", 4, 8, 64, 16, 64, (16,) * 16, bf16,
         True, True),
        ("partial tail", 4, 8, 64, 16, 64, (16,) * 5 + (7,), bf16, False,
         False),
        ("masked middle pages", 4, 8, 64, 16, 64, (16, 0, 0, 16, 3), bf16,
         False, False),
        ("first chunk: all masked", 4, 8, 64, 16, 64, (0, 0, 0), bf16, False,
         False),
        ("C=1", 4, 8, 64, 16, 1, (16, 16, 5), bf16, False, False),
        ("qwen chunk 64 (G=1)", 16, 1, 64, 16, 64, (16,) * 16, bf16, True,
         False),
        ("D=32", 2, 4, 32, 16, 8, (16, 9), bf16, False, False),
        ("D=128", 2, 4, 128, 16, 8, (16, 9), bf16, False, False),
        ("fp32", 4, 8, 64, 16, 16, (16, 16, 11), f32, False, False),
        ("page 8", 2, 3, 64, 8, 5, (8, 8, 0, 1), bf16, False, False),
        ("D=16 (reduced, padded)", 1, 4, 16, 8, 8, (8, 8, 5), f32, False,
         False),
        ("D=16 (reduced, padded)", 2, 2, 16, 8, 3, (8, 0, 3), bf16, False,
         False),
    ]
    for q8 in (False, True):
        kname = "vwr_chunk_prefix_attend" + ("_q8" if q8 else "")
        print(kname)
        for (label, KV, G, D, ps, C, counts, dt, timed,
             head) in ck_cases:
            n_pages = 64
            J = len(counts)
            q = randn(KV, C * G, D, dtype=dt)
            shape = (n_pages, ps, KV, D)
            if q8:
                pools = [torch.randint(-127, 128, shape, generator=gen,
                                       device="cuda", dtype=torch.int8)
                         for _ in range(2)]
                scales = [torch.rand((n_pages, KV), generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                pools = [randn(*shape, dtype=dt) for _ in range(2)]
                scales = []
            # a permuted table whose last entry lies past the pool (the
            # kernel clamps it to the last page, as the plain version)
            table = torch.randperm(n_pages, generator=gen,
                                   device="cuda")[:J].to(torch.int32)
            table[-1] = n_pages + 5
            cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
            ops_ = (q, *pools, *scales, table, cnt)
            fn = KC.vwr_chunk_prefix_attend_q8 if q8 \
                else KC.vwr_chunk_prefix_attend
            ref = KC.vwr_chunk_prefix_attend_q8_ref if q8 \
                else KC.vwr_chunk_prefix_attend_ref
            shape_s = (f"KV{KV} G{G} D{D} ps{ps} C{C} J{J} "
                       f"keys{sum(counts)}")
            got = fn(*ops_)
            torch.cuda.synchronize()
            err = compare(kname, shape_s, f32, got, ref(*ops_))
            if not any(counts) and (got[2].abs().max().item() != 0.0
                                    or got[0].abs().max().item() != 0.0
                                    or got[1].max().item() > -1e29):
                raise AssertionError("a chunk with no valid prior key must "
                                     "give m=-1e30, l=0, o=0")
            if timed:
                # the kernel reads the valid keys of the live pages and
                # both scales of every live (page, head)
                n_keys = sum(counts)
                live = sum(1 for c in counts if c)
                nbytes = (pools[0].element_size() * 2 * n_keys * KV * D
                          + (8 * live * KV if q8 else 0)
                          + q.element_size() * q.numel() + 8 * J
                          + 4 * KV * C * G * (D + 2))
                record(kname, label, shape_s, dt, err,
                       lambda: fn(*ops_), lambda: ref(*ops_),
                       _chunk_sdpa(torch, F, q, pools, scales, table, cnt),
                       4 * KV * C * G * D * n_keys, nbytes, head)
    check_mla_kernels(torch, F, gen, compare, record)
    check_conv_kernels(torch, F, gen, compare, record)
    return results


def check_mla_kernels(torch, F, gen, compare, record):
    """Kernels 10, 14 (dense latent cache, bf16 / fp32 / int8 with (B,)
    scales), 11, 13 (latent page pools, int8 with (n_pages,) scales) and
    12, 15 (a prompt chunk against its prior latent pages) at
    DeepSeek-V3's widths (H 128, r 512, rope 64, fp32 queries) against
    their plain versions; the bound counts the fp32 queries and partials
    beside the valid keys, and fp32 operations (the queries are fp32)."""
    from repro_torch.kernels import vwr_mla_decode as KM

    f32, bf16 = torch.float32, torch.bfloat16
    H, R, RP, SCALE = 128, 512, 64, 1.0 / 192 ** 0.5

    def queries(B):
        return (torch.randn(B, H, R, generator=gen, device="cuda"),
                torch.randn(B, H, RP, generator=gen, device="cuda"))

    def caches(lead, dt, q8):
        if q8:
            return ([torch.randint(-127, 128, (*lead, w), generator=gen,
                                   device="cuda", dtype=torch.int8)
                     for w in (R, RP)],
                    [torch.rand(lead[0], generator=gen, device="cuda")
                     * 0.02 + 1e-3 for _ in range(2)])
        return [torch.randn(*lead, w, generator=gen, device="cuda").to(dt)
                for w in (R, RP)], []

    def split(B, keys, elt, scale_bytes, index_bytes):
        parts = {"queries": 4 * B * H * (R + RP),
                 "keys": elt * keys * (R + RP), "scales": scale_bytes,
                 "index": index_bytes, "partials": 4 * B * H * (R + 2)}
        print("      bytes: " + ", ".join(f"{k} {v:,}" for k, v in
                                          parts.items())
              + f"; total {sum(parts.values()):,}")
        return sum(parts.values())

    def library(qa, qr, ckv, kr, valid):
        """SDPA on the concatenated view of the valid keys: the heads as
        the query rows of one shared KV head, masked by ``valid``."""
        from repro_torch.models.mla import mla_concat_view

        def run():
            q_cat, k_cat, v_cat, _ = mla_concat_view(qa, qr, ckv, kr, SCALE)
            return F.scaled_dot_product_attention(
                q_cat[:, None].to(ckv.dtype), k_cat.transpose(1, 2),
                v_cat.transpose(1, 2), attn_mask=valid[:, None, None, :])
        return run

    dense_cases = [
        # label, B, T, cur_len, pos0, dtype, timed, headline
        ("deepseek decode", 4, 160, 144, 0, bf16, True, True),
        ("slab pos0 30, keys past cur", 4, 160, 150, 30, bf16, False, False),
        ("fp32 cache", 2, 77, 77, 0, f32, False, False),
        ("no valid key", 2, 40, 3, 10, bf16, False, False),
    ]
    for q8 in (False, True):
        kname = "vwr_mla_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        fn = KM.vwr_mla_flash_decode_q8 if q8 else KM.vwr_mla_flash_decode
        ref = (KM.vwr_mla_flash_decode_q8_ref if q8
               else KM.vwr_mla_flash_decode_ref)
        for label, B, T, cur, pos0, dt, timed, head in dense_cases:
            qa, qr = queries(B)
            cache, scales = caches((B, T), dt, q8)
            args = (qa, qr, *cache, *scales, cur, pos0)
            shape = f"B{B} H{H} r{R} rope{RP} T{T} cur{cur} pos0{pos0}"
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            err = compare(kname, shape, f32, got, ref(*args, scale=SCALE))
            if cur <= pos0 and (got[2].abs().max().item() != 0.0
                                or got[1].max().item() > -1e29):
                raise AssertionError("a head with no valid key must give "
                                     "m=-1e30, l=0")
            if timed:
                n = max(0, min(T, cur - pos0))
                elt = cache[0].element_size()
                nbytes = split(B, B * n, elt, 8 * B if q8 else 0, 0)
                valid = torch.ones(B, n, dtype=torch.bool, device="cuda")

                def sliced(qa=qa, qr=qr, cache=cache, scales=scales, n=n,
                           valid=valid):
                    kv = [c[:, :n] for c in cache]
                    if scales:
                        kv = [c.to(bf16) * s[:, None, None].to(bf16)
                              for c, s in zip(kv, scales)]
                    return library(qa, qr, *kv, valid)()
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), sliced,
                       2 * H * B * n * (2 * R + RP), nbytes, head,
                       op_dtype=f32)

    # 8 slots, ragged: 653 keys in 44 live pages; slot 0 is inactive, a
    # page of slot 4 is counted 0 and slot 2's table entry lies past the
    # pool (the kernel clamps it to the last page, as the plain version)
    lens, ps, n_pages, J = (0, 1, 16, 17, 255, 100, 200, 64), 16, 1024, 17
    paged_cases = [
        # label, page_size, dtype, timed, headline
        ("deepseek 8 slots", ps, bf16, True, True),
        ("fp32 pools", ps, f32, False, False),
        ("page 8", 8, bf16, False, False),
    ]
    for q8 in (False, True):
        kname = "vwr_mla_paged_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        fn = (KM.vwr_mla_paged_flash_decode_q8 if q8
              else KM.vwr_mla_paged_flash_decode)
        ref = (KM.vwr_mla_paged_flash_decode_q8_ref if q8
               else KM.vwr_mla_paged_flash_decode_ref)
        for label, pgs, dt, timed, head in paged_cases:
            B = len(lens)
            qa, qr = queries(B)
            pools, scales = caches((n_pages, pgs), dt, q8)
            table, counts, live = _paged_table(torch, gen, lens,
                                               J * ps // pgs, pgs, n_pages)
            counts[4, 3] = 0
            table[2, 0] = n_pages + 5
            args = (qa, qr, *pools, *scales, table, counts)
            n_keys = int(counts.sum())
            live = int((counts > 0).sum())
            shape = (f"B{B} H{H} r{R} rope{RP} ps{pgs} J{table.shape[1]} "
                     f"keys{n_keys} pages{live}")
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            err = compare(kname, shape, f32, got, ref(*args, scale=SCALE))
            if got[2][0].abs().max().item() != 0.0:
                raise AssertionError("an inactive slot must give l=0")
            if timed:
                elt = pools[0].element_size()
                nbytes = split(B, n_keys, elt, 8 * live if q8 else 0,
                               8 * table.numel())
                tbl = table.long().clamp(0, n_pages - 1)
                valid = (torch.arange(pgs, device="cuda")[None, None, :]
                         < counts[..., None]).reshape(B, -1)

                def gathered(qa=qa, qr=qr, pools=pools, scales=scales,
                             tbl=tbl, valid=valid):
                    kv = []
                    for i, pool in enumerate(pools):
                        x = pool[tbl]
                        if scales:
                            x = (x.to(bf16) * scales[i][tbl][:, :, None,
                                                              None].to(bf16))
                        kv.append(x.reshape(B, -1, x.shape[-1]))
                    return library(qa, qr, *kv, valid)()
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), gathered,
                       2 * H * n_keys * (2 * R + RP), nbytes, head,
                       op_dtype=f32)

    # kernels 12 and 15: a prompt chunk's C tokens against its prior
    # pages, one (J,) table; each case's last table entry lies past the
    # pool (the kernel clamps it to the last page, as the plain version)
    chunk_cases = [
        # label, C, counts, dtype, timed, headline
        ("deepseek chunk 64, 16 pages of 16", 64, (16,) * 16, bf16, True,
         True),
        ("partial page", 64, (16,) * 5 + (7,), bf16, False, False),
        ("count-0 page", 64, (16, 0, 16, 3), bf16, False, False),
        ("first chunk: all masked", 64, (0, 0), bf16, False, False),
        ("C=1", 1, (16, 16, 5), bf16, False, False),
        ("fp32 pools", 16, (16, 16, 11), f32, False, False),
    ]
    n_pages = 64
    for q8 in (False, True):
        kname = "vwr_mla_chunk_prefix_attend" + ("_q8" if q8 else "")
        print(kname)
        fn = (KM.vwr_mla_chunk_prefix_attend_q8 if q8
              else KM.vwr_mla_chunk_prefix_attend)
        ref = (KM.vwr_mla_chunk_prefix_attend_q8_ref if q8
               else KM.vwr_mla_chunk_prefix_attend_ref)
        for label, C, cnts, dt, timed, head in chunk_cases:
            qa, qr = queries(C)
            pools, scales = caches((n_pages, ps), dt, q8)
            J = len(cnts)
            table = torch.randperm(n_pages, generator=gen,
                                   device="cuda")[:J].to(torch.int32)
            table[-1] = n_pages + 5
            counts = torch.tensor(cnts, dtype=torch.int32, device="cuda")
            args = (qa, qr, *pools, *scales, table, counts)
            n_keys, live = sum(cnts), sum(1 for c in cnts if c)
            shape = (f"C{C} H{H} r{R} rope{RP} ps{ps} J{J} keys{n_keys}")
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            err = compare(kname, shape, f32, got, ref(*args, scale=SCALE))
            if not any(cnts) and (got[2].abs().max().item() != 0.0
                                  or got[0].abs().max().item() != 0.0
                                  or got[1].max().item() > -1e29):
                raise AssertionError("a chunk with no valid prior key must "
                                     "give m=-1e30, l=0, o=0")
            if timed:
                elt = pools[0].element_size()
                nbytes = split(C, n_keys, elt, 8 * live if q8 else 0,
                               8 * J)
                tbl = table.long().clamp(0, n_pages - 1)
                valid = (torch.arange(ps, device="cuda")[None, :]
                         < counts[:, None]).reshape(1, -1)

                def gathered(qa=qa, qr=qr, pools=pools, scales=scales,
                             tbl=tbl, valid=valid, C=C):
                    """The chunk's C*H rows as the queries of one
                    sequence over its gathered (dequantized) pages."""
                    kv = []
                    for i, pool in enumerate(pools):
                        x = pool[tbl]
                        if scales:
                            x = x.to(bf16) * scales[i][tbl][:, None,
                                                            None].to(bf16)
                        kv.append(x.reshape(1, -1, x.shape[-1]))
                    return library(qa.reshape(1, C * H, R),
                                   qr.reshape(1, C * H, RP), *kv, valid)()
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), gathered,
                       2 * C * H * n_keys * (2 * R + RP), nbytes, head,
                       op_dtype=f32)

    # the reduced configs' widths (r 16, rope 8: zero-padded to 32 / 32 by
    # the wrappers), every MLA kernel once, against its plain version
    h, r, rp, lead, ps8 = 4, 16, 8, 12, 8
    qa = torch.randn(3, h, r, generator=gen, device="cuda")
    qr = torch.randn(3, h, rp, generator=gen, device="cuda")
    table = torch.tensor([[3, 0], [11, 7], [5, 5]], dtype=torch.int32,
                         device="cuda")
    counts = torch.tensor([[8, 3], [8, 0], [0, 0]], dtype=torch.int32,
                          device="cuda")
    for q8 in (False, True):
        sfx = "_q8" if q8 else ""
        for kind, lead_shape, index in (
                ("flash_decode", (3, 20), ()),
                ("paged_flash_decode", (lead, ps8), (table, counts)),
                ("chunk_prefix_attend", (lead, ps8),
                 (table[1].clone(), counts[0].clone()))):
            kname = f"vwr_mla_{kind}{sfx}"
            if q8:
                cache = [torch.randint(-127, 128, (*lead_shape, w),
                                       generator=gen, device="cuda",
                                       dtype=torch.int8) for w in (r, rp)]
                scales = [torch.rand(lead_shape[0], generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                cache = [torch.randn(*lead_shape, w, generator=gen,
                                     device="cuda") for w in (r, rp)]
                scales = []
            tail = (13, 0) if not index else index
            args = (qa, qr, *cache, *scales, *tail)
            got = getattr(KM, kname)(*args, scale=SCALE)
            torch.cuda.synchronize()
            compare(kname, f"H{h} r{r} rope{rp} (reduced, padded)", f32,
                    got, getattr(KM, kname + "_ref")(*args, scale=SCALE))


# ----------------------------------------------------------------------
# kernels 16 and 17: the paper's CNN layers (phase 2 and phase 9)
# ----------------------------------------------------------------------

# the paper's one image, and a batch of 32
CNN_BATCHES = (1, 32)
# the headline cases of the {"kernels"} line
CNN_HEADLINE = {"vwr_conv2d": ("RN_56x56", 32, "bfloat16"),
                "vwr_depthwise": ("MN_56x56", 32, "bfloat16")}


def _cnn_layers():
    """The provet_cnn suite's layers the kernels take (stride 1) and the
    ones they do not (RN_112x112 at stride 2, AN_55x55 at stride 4)."""
    from repro_torch.configs import provet_cnn

    return ([l for l in provet_cnn.LAYERS if l.stride == 1],
            [l for l in provet_cnn.LAYERS if l.stride != 1])


def _conv_operands(torch, gen, n, H, W, C, n_out, KH, KW, dt, bias=True,
                   depthwise=False):
    """x (n, H, W, C), w (KH, KW, C[, n_out]) scaled by 1/sqrt(fan-in),
    and a bias (n_out,) (None for depthwise or ``bias=False``)."""
    x = torch.randn(n, H, W, C, generator=gen, device="cuda").to(dt)
    if depthwise:
        w = torch.randn(KH, KW, C, generator=gen, device="cuda")
        return x, (w / (KH * KW) ** 0.5).to(dt), None
    w = torch.randn(KH, KW, C, n_out, generator=gen, device="cuda")
    b = (torch.randn(n_out, generator=gen, device="cuda") * 0.1).to(dt)
    return x, (w / (KH * KW * C) ** 0.5).to(dt), (b if bias else None)


def _conv_work(x, w, bias, act, depthwise=False):
    """(operations, bytes) of one conv: a multiply and an add a tap of
    each output (KH*KW*C taps, KH*KW depthwise), the bias and the
    activation one operation an output each; x, w, bias and the output
    moved once each."""
    N, H, W, C = x.shape
    KH, KW = w.shape[:2]
    outs = N * (H - KH + 1) * (W - KW + 1) * (C if depthwise else w.shape[3])
    ops_ = 2 * outs * KH * KW * (1 if depthwise else C)
    ops_ += outs * ((bias is not None) + (act is not None))
    nbytes = x.element_size() * (x.numel() + w.numel() + outs + (
        0 if bias is None else bias.numel()))
    return ops_, nbytes


def _cudnn(torch, F, x, w, bias, depthwise=False):
    """The library yardstick: one cuDNN ``F.conv2d`` on channels-last
    views of x (no copy) and of the weights (reformatted once, outside
    the timed call), with the bias; ``groups=C`` for depthwise."""
    xl = x.permute(0, 3, 1, 2)
    if depthwise:
        wl = w.permute(2, 0, 1).unsqueeze(1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xl, wl, groups=x.shape[3])
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xl, wl, bias)


def check_conv_kernels(torch, F, gen, compare, record):
    """Kernels 16 (vwr_conv2d) and 17 (vwr_depthwise) against their plain
    versions: the JAX tests' ragged shapes (C 7 / 3, F 5 / 9, a 1x1 and a
    5x5 conv), H_out and W_out off the tile, every epilogue with and
    without bias, in bf16 and fp32; then every stride-1 layer of the
    provet_cnn suite at N 1 and 32, bf16 and fp32 (conv with bias +
    relu), each timed beside its bound, its plain version and cuDNN."""
    from repro_torch.kernels import vwr_conv2d as K16
    from repro_torch.kernels import vwr_depthwise as K17

    f32, bf16 = torch.float32, torch.bfloat16
    print("vwr_conv2d")
    conv_edges = [
        # label, N, H, W, C, F, KH, KW, bias, activation
        ("3x3", 1, 9, 9, 8, 8, 3, 3, True, "relu"),
        ("C 7 F 5", 2, 13, 11, 7, 5, 3, 3, True, "gelu"),
        ("1x1, bias only", 1, 8, 8, 4, 16, 1, 1, True, None),
        ("5x5 C 3 F 9, no bias", 2, 12, 10, 3, 9, 5, 5, False, "relu"),
        ("H_out 13 W_out 19", 2, 15, 21, 24, 70, 3, 3, True, "silu"),
        ("F 130, no bias or act", 1, 10, 40, 64, 130, 3, 3, False, None),
        ("gelu, no bias", 1, 11, 18, 16, 24, 3, 3, False, "gelu"),
        ("silu, no bias", 1, 11, 18, 16, 24, 3, 3, False, "silu"),
        ("7x7 C 3, W_out 37", 1, 43, 43, 3, 64, 7, 7, True, "relu"),
    ]
    for label, N, H, W, C, Fo, KH, KW, has_b, act in conv_edges:
        for dt in (f32, bf16):
            x, w, b = _conv_operands(torch, gen, N, H, W, C, Fo, KH, KW, dt,
                                     bias=has_b)
            got = K16.vwr_conv2d(x, w, b, activation=act)
            torch.cuda.synchronize()
            compare("vwr_conv2d", f"{label} {act or ''}", dt, got,
                    K16.vwr_conv2d_ref(x, w, b, activation=act))
    print("vwr_depthwise")
    dw_edges = [
        # label, N, H, W, C, K
        ("3x3 C 8", 1, 10, 10, 8, 3),
        ("C 16, H_out 10 W_out 7", 2, 12, 9, 16, 3),
        ("5x5 C 4", 1, 9, 9, 4, 5),
        ("C 70 (past a 64-channel block, not 8-aligned)", 2, 13, 21, 70, 3),
        ("C 3, 7x7", 1, 20, 30, 3, 7),
    ]
    for label, N, H, W, C, K in dw_edges:
        for dt in (f32, bf16):
            x, w, _ = _conv_operands(torch, gen, N, H, W, C, C, K, K, dt,
                                     depthwise=True)
            got = K17.vwr_depthwise(x, w)
            torch.cuda.synchronize()
            compare("vwr_depthwise", label, dt, got,
                    K17.vwr_depthwise_ref(x, w))

    covered, _ = _cnn_layers()
    for layer in covered:
        dw = layer.depthwise
        kname = "vwr_depthwise" if dw else "vwr_conv2d"
        print(f"{kname} {layer.name}")
        for n in CNN_BATCHES:
            for dt in (bf16, f32):
                x, w, b = _conv_operands(
                    torch, gen, n, layer.H_in, layer.W_in, layer.C_in,
                    layer.C_out, layer.K, layer.K, dt, depthwise=dw)
                act = None if dw else "relu"
                if dw:
                    fn = (lambda x=x, w=w: K17.vwr_depthwise(x, w))
                    plain = (lambda x=x, w=w: K17.vwr_depthwise_ref(x, w))
                else:
                    fn = (lambda x=x, w=w, b=b:
                          K16.vwr_conv2d(x, w, b, activation="relu"))
                    plain = (lambda x=x, w=w, b=b:
                             K16.vwr_conv2d_ref(x, w, b, activation="relu"))
                shape = (f"N{n} {layer.H_in}x{layer.W_in}x{layer.C_in}"
                         + ("" if dw else f" F{layer.C_out}")
                         + f" {layer.K}x{layer.K}"
                         + ("" if dw else " +bias+relu"))
                got = fn()
                torch.cuda.synchronize()
                err = compare(kname, f"{layer.name} N{n}", dt, got, plain())
                head = CNN_HEADLINE[kname] == (layer.name, n, str(dt)[6:])
                library = _cudnn(torch, F, x, w, b, depthwise=dw)
                if head:
                    # the yardstick computes the same function (the relu
                    # aside, which it leaves out)
                    lib = library()
                    lib = lib if dw else torch.relu(lib.float()).to(dt)
                    compare(f"{kname} (cuDNN)", layer.name, dt,
                            lib.permute(0, 2, 3, 1), got)
                flops, nbytes = _conv_work(x, w, b, act, depthwise=dw)
                # depthwise has no product to put on the tensor cores:
                # its operations are fp32 FMAs whatever the input type
                record(kname, f"{layer.name} N{n}", shape, dt, err, fn,
                       plain, library, flops, nbytes, head,
                       op_dtype=f32 if dw else None)


def _paged_table(torch, gen, lens, J, ps, n_pages):
    """A block table of randomly permuted physical pages for each slot's
    live pages, zero past them, and its (B, J) counts; plus the number
    of live pages."""
    import numpy as np

    B = len(lens)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    table = np.zeros((B, J), np.int32)
    counts = np.zeros((B, J), np.int32)
    k = 0
    for b, n in enumerate(lens):
        live = -(-n // ps)
        table[b, :live] = perm[k:k + live].numpy()
        counts[b, :live] = np.clip(n - ps * np.arange(live), 0, ps)
        k += live
    return (torch.from_numpy(table).cuda(), torch.from_numpy(counts).cuda(),
            k)


def _chunk_sdpa(torch, F, q, pools, scales, table, counts):
    """The library yardstick of a chunk-prefix partial: gather the prior
    pages into a dense (KV, T, D) prefix (dequantized for int8) and run
    SDPA with each KV head's C*G query rows, the counts as the mask."""
    J = table.shape[0]
    n_pages, ps, KV, D = pools[0].shape
    idx = table.long().clamp(0, n_pages - 1)
    mask = (torch.arange(ps, device="cuda")[None, :]
            < counts[:, None]).reshape(1, 1, 1, J * ps)

    def run():
        kv = []
        for i, pool in enumerate(pools):
            x = pool[idx]                          # (J, ps, KV, D)
            if scales:
                x = x.to(q.dtype) * scales[i][idx][:, None, :, None].to(
                    q.dtype)
            kv.append(x.reshape(1, J * ps, KV, D).transpose(1, 2))
        return F.scaled_dot_product_attention(q[None], kv[0], kv[1],
                                              attn_mask=mask)
    return run


def _paged_sdpa(torch, F, q, pools, scales, table, counts, KV, G, D):
    """The library yardstick of a paged decode: gather each slot's
    pages into a dense (B, KV, T, D) cache (dequantized for int8) and
    run SDPA with the G query heads of a KV head as its query rows and
    the counts as the mask."""
    B, J = table.shape
    ps = pools[0].shape[1]
    idx = table.long()
    mask = (torch.arange(ps, device="cuda")[None, None, :]
            < counts[..., None]).reshape(B, 1, 1, J * ps)
    qs = q.reshape(B, KV, G, D)

    def run():
        kv = []
        for i, pool in enumerate(pools):
            x = pool[idx]                          # (B, J, ps, KV, D)
            if scales:
                x = (x.to(q.dtype)
                     * scales[i][idx][:, :, None, :, None].to(q.dtype))
            kv.append(x.reshape(B, J * ps, KV, D).transpose(1, 2))
        return F.scaled_dot_product_attention(qs, kv[0], kv[1],
                                              attn_mask=mask)
    return run


# ----------------------------------------------------------------------
# phases 3-4: serving end to end
# ----------------------------------------------------------------------

def serve(torch, name, gen, expected_launches, kernel9=False):
    """Full-width generate on the kernels (launches counted), then the
    same token stream teacher-forced through the plain backend; with
    ``kernel9``, kernel 9 over the kernel path's dense cache after the
    stream (``dense_kernel9``)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build

    cfg = get_config(name)
    B, P = 4, 128
    ecfg = EngineConfig(batch=B, max_len=P + gen, kernel_impl="cuda")
    t0 = time.perf_counter()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    print(f"{name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, {n_params / 1e9:.3f} B params "
          f"({time.perf_counter() - t0:.1f} s to init)")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)

    # one warm-up generate at the same shapes, so the timed one below
    # finds the allocator's pools and the kernels' first launches done
    eng.generate({"tokens": prompts}, gen=gen)
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": prompts}, gen=gen)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"  launches in generate: {launches}")
    for k, n in expected_launches.items():
        if launches[k] != n:
            raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: bad tokens {tokens.shape}")
    print(f"  prefill_tok_s {stats['prefill_tok_s']:.1f}  decode_tok_s "
          f"{stats['decode_tok_s']:.1f}  (t_prefill {stats['t_prefill_s']:.4f}"
          f" s, t_decode {stats['t_decode_s']:.4f} s)")

    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    rel, cache = _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                                 check_greedy=True)
    worst = max(rel)
    print(f"  teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{worst:.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g})")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"{name}: logits diverge from the plain path")
    k9 = dense_kernel9(torch, cfg, cache, P + gen - 1) if kernel9 else None
    del eng, ref, cache
    torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt": P, "gen": gen,
            "n_params": n_params, "launches": launches,
            "logits_rel_err": rel, "kernel9": k9, **stats}


def dense_kernel9(torch, cfg, cache, cur_len):
    """Kernel 9 through ``dist.decode.local_decode_attend`` with scales,
    over the dense K/V cache the teacher-forced stream left behind,
    quantized one scale a (batch, KV head) row, against the plain
    dequantize-then-attend op on the same int8 cache; launches counted
    (one a layer)."""
    from repro_torch.dist import decode as DD
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import int8_scale

    g = torch.Generator(device="cuda").manual_seed(12)
    atol, rtol = TOL["float32"]
    work = []
    for i in range(cache["k"].shape[0]):
        q8, sc = [], []
        for x in (cache["k"][i], cache["v"][i]):       # (B, T, KV, D)
            s = int8_scale(x.float().abs().amax(dim=(1, 3)))    # (B, KV)
            q8.append(torch.clamp(torch.round(x.float() / s[:, None, :,
                                                            None]),
                                  -127, 127).to(torch.int8))
            sc.append(s)
        B = q8[0].shape[0]
        q = torch.randn(B, cfg.n_heads, cfg.d_head, generator=g,
                        device="cuda").to(cache["k"].dtype)
        work.append((q, q8, sc))
    torch.cuda.synchronize()
    build.reset_launches()
    got = [DD.local_decode_attend(q, *q8, cur_len, k_scale=sc[0],
                                  v_scale=sc[1], backend="cuda")
           for q, q8, sc in work]
    torch.cuda.synchronize()
    launches = build.LAUNCHES["vwr_flash_decode_q8"]
    err = 0.0
    for (q, q8, sc), x in zip(work, got):
        want = DD.local_decode_attend(q.float(), *q8, cur_len,
                                      k_scale=sc[0], v_scale=sc[1],
                                      backend="torch")
        # the kernel path returns the queries' bf16: one rounding more
        d = (x.float() - want).abs()
        err = max(err, d.max().item())
        atol_, rtol_ = TOL["bfloat16"] if x.dtype == torch.bfloat16 \
            else (atol, rtol)
        if not bool((d <= atol_ + rtol_ * want.abs()).all()):
            raise AssertionError("kernel 9 disagrees with "
                                 "dequantize-then-attend")
    print(f"  kernel 9 over the int8 dense cache of the stream "
          f"({len(work)} layers, cur_len {cur_len}): max|err| {err:.3e}, "
          f"{launches} launches")
    if launches != len(work):
        raise AssertionError(f"kernel 9 launched {launches} times")
    return {"layers": len(work), "max_abs_err": err, "launches": launches}


# projections rescaled by ``_condition``: GQA's, the MLPs' and experts',
# the unembedding, and MLA's
PROJECTIONS = ("wq", "wk", "wv", "wo", "wi", "wg", "w", "wq_a", "wq_b",
               "wkv_a", "wk_b", "wv_b")


def _std(torch, t, chunk=1 << 24):
    """The standard deviation of ``t``, summed in fp64 over slices of
    ``chunk`` elements: no fp32 copy of a whole (15 GB) expert stack."""
    flat = t.reshape(-1)
    n = flat.numel()
    s = torch.zeros((), dtype=torch.float64, device=t.device)
    s2 = torch.zeros_like(s)
    for i in range(0, n, chunk):
        c = flat[i:i + chunk].double()
        s += c.sum()
        s2 += c.square().sum()
    return ((s2 - s * s / n) / (n - 1)).sqrt().item()


def _condition(torch, params):
    """Rescale random weights to a well-conditioned model, in place.

    The JAX package's fan-in init (mirrored by ``init_params``) takes
    ``shape[-2]`` as the fan-in, which for ``wq``/``wk``/``wv``
    ``(d, H, Dh)`` — and MLA's ``wq_b``/``wk_b``/``wv_b`` ``(rank, H,
    Dh)`` — is the head count: q and k come out with stds of ~8-20,
    attention is close to a hard argmax and the residual stream grows
    layer by layer, so 1-ulp bf16 differences flip attention choices
    and no two rounding orders agree after 22 layers.  Every projection
    is rescaled to std 0.02 (HF Llama's initializer_range) and the QKV
    biases drawn at std 0.02, so the fused bias is not a sum of
    zeros."""
    from repro_torch.common.module import leaves

    g = torch.Generator(device="cuda").manual_seed(3)
    for path, t in leaves(params):
        if path[-1] in PROJECTIONS:
            t.mul_(0.02 / _std(torch, t))
        elif path[-1] in ("bq", "bk", "bv"):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * 0.02)


def _decode(eng, tok, pos, cache):
    table = eng.default_block_table() if eng.ecfg.paged else None
    return eng.decode_step(tok, pos, cache, block_table=table)


def _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                    check_greedy=False, atol=None):
    """Per-step max |logits error| of ``eng`` against ``ref`` on one
    stream, relative to max|ref|; with ``atol``, absolute, and raising
    past ``atol`` times the logits' scale (max|ref|, at least 1).
    Returns the errors and ``eng``'s dense cache after the stream."""
    out = []
    vocab = eng.cfg.vocab
    lc, cc = eng.prefill({"tokens": prompts})
    lr, cr = ref.prefill({"tokens": prompts})
    for i in range(gen):
        if check_greedy and not bool(
                (lc.argmax(-1).to(torch.int32) == tokens[:, i]).all()):
            raise AssertionError(f"step {i}: the kernel path is not "
                                 "deterministic (replay != generate)")
        d = (lc - lr)[:, :vocab]           # padded vocab columns are -1e30
        err, scale = d.abs().max().item(), lr[:, :vocab].abs().max().item()
        if atol is not None:
            if not err <= atol * max(1.0, scale):
                raise AssertionError(f"step {i}: max|d| {err} past "
                                     f"{atol} x {max(1.0, scale)}")
            out.append(err)
        else:
            out.append(err / scale)
        if i + 1 < gen:
            tok = tokens[:, i]
            lc, cc = _decode(eng, tok, P + i, cc)
            lr, cr = _decode(ref, tok, P + i, cr)
    return out, cc


def _reduced(name):
    """``reduced(name)`` as the CPU tests run it: head dim 16 and, for MLA,
    latent rank 16 and rope width 8, which the kernel wrappers zero-pad to
    the kernels' widths on each call."""
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(name))


def serve_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: kernel path against the plain
    path at the Pallas-vs-XLA tolerance, greedy streams identical."""
    from repro_torch.engine import DecodeEngine, EngineConfig

    cfg = _reduced(name)
    ecfg = EngineConfig(batch=2, max_len=40, kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (2, 31), generator=g,
                            device="cuda", dtype=torch.int32)
    tok_c, _ = eng.generate({"tokens": prompts}, gen=9)
    tok_r, _ = ref.generate({"tokens": prompts}, gen=9)
    if not bool((tok_c == tok_r).all()):
        raise AssertionError(f"{name} reduced fp32: greedy streams differ")
    err, _ = _teacher_forced(torch, eng, ref, prompts, tok_c, 31, 9,
                             atol=E2E_FP32_TOL)
    print(f"  {cfg.name} fp32: max|d logits| {max(err):.3e} "
          f"(limit {E2E_FP32_TOL:g} x max(1, max|logits|)), greedy tokens "
          "identical")
    return max(err)


# ----------------------------------------------------------------------
# phases 5-6: continuous batching on the paged pools
# ----------------------------------------------------------------------

# the Scheduler stream: 24 requests with seeded prompt lengths in
# 32-256 and gen 32; 8 submitted at once, then 2 more every 4 steps,
# over 8 slots and 128 pages of 16 (fewer than 8 long requests need,
# so growth can preempt)
N_REQ, FIRST, EVERY, BURST, GEN = 24, 8, 4, 2, 32
PROMPT = (32, 256)
SLOTS, PAGE, N_PAGES = 8, 16, 128
# the full pool never runs dry on this stream (admission waits for
# pages, and 32 tokens grow a request by at most 2 pages); the same
# stream again with this many pages held (``faults.hold_pages``) does,
# so growth preempts at full width
HELD = 40
# the teacher-forced replay runs the same kernels on the same rows as
# the served stream, but its table width and slot mates differ, so the
# partials may round differently and a near-tie flip a greedy pick:
# at least this share of the replayed steps must pick the served token
REPLAY_AGREE = 0.95
# the int8 prefix + chunked stream reads each prefix through quantized
# pages where the replay's whole-prompt prefill reads it in full
# precision, so more near-ties flip: 236/256 steps agreed on an NVIDIA
# H100 80GB HBM3 at 700 W, and this floor leaves room for 5 more flips
REPLAY_AGREE_Q8 = 0.9


def _requests(cfg, n, prompt, gen, seed):
    import numpy as np

    from repro_torch.engine import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab, int(p))
                    .astype(np.int32), gen=gen)
            for i, p in enumerate(lens)]


def _drive(sched, reqs):
    """Submit FIRST requests, then BURST more every EVERY steps (or at
    once when the scheduler runs dry), and step until all are done."""
    k = min(FIRST, len(reqs))
    for r in reqs[:k]:
        sched.submit(r)
    next_at = EVERY
    while (k < len(reqs) or sched.pending or sched.parked
           or sched.n_active):
        idle = not (sched.n_active or sched.pending or sched.parked)
        if k < len(reqs) and (sched.stats["steps"] >= next_at or idle):
            for r in reqs[k:k + BURST]:
                sched.submit(r)
            k += BURST
            next_at += EVERY
        sched.admit()
        sched.step()
    return sched.results()


def serve_scheduler(torch, kv_dtype, params=None):
    """Full-width tinyllama-1.1b through the Scheduler on the kernels:
    the stream above, launch counts checked, the stream again with
    pages held so that growth preempts, then finished requests replayed
    teacher-forced through the engine's slots and held against the
    plain path (``_replay_slots``)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import (DecodeEngine, EngineConfig,
                                    RequestStatus, Scheduler)
    from repro_torch.kernels import build

    cfg = get_config("tinyllama-1.1b")
    ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
                        page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
                        kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, params=params, device="cuda", seed=0)
    if params is None:
        _condition(torch, eng.params)
    print(f"Scheduler, tinyllama-1.1b, {kv_dtype} pools: {SLOTS} slots, "
          f"{N_PAGES} pages of {PAGE}, {N_REQ} requests, prompts "
          f"{PROMPT[0]}-{PROMPT[1]}, gen {GEN}")
    # a short warm-up stream, so the counted one finds the allocator's
    # pools and the kernels' first launches done
    _drive(Scheduler(eng), _requests(cfg, 4, PROMPT, 4, seed=5))
    reqs = _requests(cfg, N_REQ, PROMPT, GEN, seed=4)
    sched = Scheduler(eng)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    st = sched.stats
    L = cfg.n_layers
    paged = "vwr_paged_flash_decode" + ("_q8" if kv_dtype == "int8"
                                        else "")
    other = ("vwr_paged_flash_decode" if kv_dtype == "int8"
             else "vwr_paged_flash_decode_q8")
    want = {paged: L * st["steps"], other: 0, "vwr_flash_decode": 0,
            "vwr_attention": L * st["prefills"],
            "vwr_swiglu": L * (st["prefills"] + st["steps"]),
            "vwr_matmul": L * (5 * st["prefills"] + st["steps"]),
            "vwr_chunk_prefix_attend": 0, "vwr_chunk_prefix_attend_q8": 0}
    print(f"  launches: {launches}")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"scheduler {kv_dtype}: {k} launched "
                                 f"{launches[k]} times, expected {n}")
    bad = {rid: r.status for rid, r in out.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN}
    if len(out) != N_REQ or bad:
        raise AssertionError(f"scheduler {kv_dtype}: unfinished {bad}")
    sched.allocator.check()
    if sched.allocator.free_pages != N_PAGES:
        raise AssertionError("pages left allocated after the drain")
    n_tok = sum(len(r) for r in out.values())
    lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
    summary = {
        "kv_dtype": kv_dtype, "steps": st["steps"],
        "prefills": st["prefills"], "preempted": st["preempted"],
        "parked": st["parked"], "peak_pages": st["peak_pages"],
        "table_widths": {str(k): v for k, v in
                         sorted(st["table_widths"].items())},
        "generated_tokens": n_tok, "wall_s": wall,
        "gen_tok_s": n_tok / wall,
        "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
        "itl_p50_s": itl["p50"], "itl_p99_s": itl["p99"],
        "launches": launches}
    print(f"  steps {st['steps']}, prefills {st['prefills']}, preempted "
          f"{st['preempted']}, peak pages {st['peak_pages']}/{N_PAGES}, "
          f"table widths {summary['table_widths']}")
    print(f"  {n_tok} tokens in {wall:.4f} s: {summary['gen_tok_s']:.1f} "
          f"generated tok/s; request latency p50 {lat['p50']:.4f} s p99 "
          f"{lat['p99']:.4f} s; ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
          f"{itl['p99'] * 1e3:.3f} ms")
    summary["held_pages_stream"] = _pressured_stream(torch, eng, cfg, out,
                                                     paged)

    rel, agree, flips = _replay_slots(torch, eng, sched.cache, reqs, out,
                                      kv_dtype)
    summary.update(logits_rel_err=rel, replay_agree=agree,
                   replay_flips=flips,
                   n_params=sum(t.numel() for _, t in leaves(eng.params)))
    params = eng.params
    del eng, sched
    torch.cuda.empty_cache()
    return summary, params


def _replay_slots(torch, eng, cache, reqs, out, kv_dtype,
                  agree_floor=REPLAY_AGREE):
    """Teacher-force finished requests through the serving engine's
    slots, all of them live in one decode batch, on the drained stream's
    pools (stale pages and int8 scales included), and hold each
    request's logits at every step against a batch-1 plain engine: dense
    for model-dtype pools, paged int8 for int8 pools, which reads the
    same quantized pages.  A wrong table or counts row, a write into
    another slot's page or a stale scale shows here.  Returns the
    per-step relative errors, the steps whose greedy pick equals the
    served token, which must be at least ``agree_floor`` of them, and
    one record a step where it does not: the replay's gap between its
    top two logits and between its pick and the served token, beside
    that step's max |d| against the plain path (a near-tie flip has a
    gap below the error) and whether the plain path picks the served
    token."""
    import numpy as np

    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.engine.paged_cache import write_prefill

    cfg, vocab = eng.cfg, eng.cfg.vocab
    # the first requests whose pages fit the pool together, one a slot
    picked, need = [], 0
    for r in reqs:
        n = -(-(len(r.tokens) + GEN - 1) // PAGE)
        if len(picked) < SLOTS and need + n <= N_PAGES:
            picked.append((r, n))
            need += n
    if len(picked) < SLOTS:
        raise AssertionError(f"only {len(picked)} requests fit the pool")
    perm = np.random.default_rng(7).permutation(N_PAGES).astype(np.int32)
    table = np.zeros((SLOTS, eng.max_pages), np.int32)
    lens = np.zeros((SLOTS,), np.int32)
    served = np.zeros((SLOTS, GEN), np.int32)
    got = [[] for _ in picked]
    at = 0
    for b, (r, n) in enumerate(picked):
        table[b, :n] = perm[at:at + n]
        at += n
        logits, caches = eng.prefill_fn(
            eng.params, {"tokens": torch.from_numpy(r.tokens)[None].cuda()})
        write_prefill(cfg, cache, caches, table[b][None])
        got[b].append(logits[0, :vocab])
        lens[b] = len(r.tokens)
        served[b] = out[r.rid].tokens
    for i in range(GEN - 1):
        logits, cache = eng.decode_step(served[:, i], lens + i, cache,
                                        block_table=table)
        for b in range(SLOTS):
            got[b].append(logits[b, :vocab])

    one = EngineConfig(batch=1, max_len=eng.ecfg.max_len,
                       kernel_impl="torch")
    if kv_dtype == "int8":
        one = one.replace(paged=True, page_size=PAGE, kv_dtype="int8")
    ref = DecodeEngine(cfg, one, params=eng.params, device="cuda")
    rel, agree, flips = [], 0, []
    for b, (r, _) in enumerate(picked):
        P = len(r.tokens)
        lr, cr = ref.prefill({"tokens": torch.from_numpy(r.tokens)[None]
                              .cuda()})
        for i in range(GEN):
            want, x = lr[0, :vocab], got[b][i]
            err = (x - want).abs().max().item()
            rel.append(err / want.abs().max().item())
            tok = int(served[b, i])
            if int(x.argmax()) == tok:
                agree += 1
            else:
                top2 = x.float().topk(2).values
                flips.append({
                    "rid": r.rid, "step": i,
                    "top2_gap": (top2[0] - top2[1]).item(),
                    "served_gap": (top2[0] - x[tok].float()).item(),
                    "abs_err": err,
                    "plain_picks_served": int(want.argmax()) == tok})
            if i + 1 < GEN:
                lr, cr = _decode(ref, served[b, i:i + 1], P + i, cr)
    worst = max(rel)
    print(f"  {len(picked)} requests replayed in {SLOTS} live slots, "
          f"teacher-forced: logits vs the plain "
          f"{'dense' if kv_dtype == 'bf16' else 'paged int8'} path max "
          f"|d|/max|ref| {worst:.3e} over {len(rel)} steps (limit "
          f"{E2E_BF16_REL:g}); greedy == served token at "
          f"{agree}/{len(rel)} steps (floor {agree_floor})")
    for f in flips:
        print(f"    request {f['rid']} step {f['step']}: top-two gap "
              f"{f['top2_gap']:.4g}, pick - served {f['served_gap']:.4g}, "
              f"max |d| vs plain {f['abs_err']:.4g}, plain picks served "
              f"{f['plain_picks_served']}")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"scheduler {kv_dtype}: logits diverge from "
                             "the plain path")
    if agree < agree_floor * len(rel):
        raise AssertionError(f"scheduler {kv_dtype}: the replay picks the "
                             f"served token at only {agree}/{len(rel)} "
                             "steps")
    del ref
    return rel, agree, flips


def _pressured_stream(torch, eng, cfg, out, paged):
    """The stream again with HELD pages held out of the pool: growth
    must preempt; every request still finishes, the pages come back,
    and the paged kernel carries every decode step and the batch-1
    ``vwr_attention`` every (re-)admission prefill.  Recompute
    re-admission prefills the generated prefix instead of reading the
    decode-written K/V, so a near-tie may pick another token at bf16:
    the streams equal to the unpressured run are counted, not held."""
    from repro_torch.engine import RequestStatus, Scheduler
    from repro_torch.engine.faults import hold_pages
    from repro_torch.kernels import build

    sched = Scheduler(eng)
    release = hold_pages(sched, HELD)
    build.reset_launches()
    res = _drive(sched, _requests(cfg, N_REQ, PROMPT, GEN, seed=4))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    release()
    st = sched.stats
    L = cfg.n_layers
    if st["preempted"] < 1:
        raise AssertionError(f"{HELD} held pages: growth never preempted")
    if (launches[paged] != L * st["steps"]
            or launches["vwr_attention"] != L * st["prefills"]
            or launches["vwr_flash_decode"] != 0):
        raise AssertionError(f"{HELD} held pages: launches {launches}")
    bad = [rid for rid, r in res.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN]
    if len(res) != N_REQ or bad:
        raise AssertionError(f"{HELD} held pages: unfinished {bad}")
    sched.allocator.check()
    if sched.allocator.free_pages != N_PAGES:
        raise AssertionError("pages left allocated after the drain")
    same = sum(bool((res[rid] == out[rid]).all()) for rid in out)
    print(f"  {HELD} pages held: steps {st['steps']}, prefills "
          f"{st['prefills']}, preempted {st['preempted']}, parked "
          f"{st['parked']}, table widths "
          f"{dict(sorted(st['table_widths'].items()))}; {same}/{N_REQ} "
          "streams equal to the unpressured run")
    return {"held": HELD, "steps": st["steps"], "prefills": st["prefills"],
            "preempted": st["preempted"], "parked": st["parked"],
            "streams_equal": same, "launches": launches}


def _replay_streams(torch, eng, ref, reqs, streams, chunk=None):
    """Teacher-force each request's ``streams`` tokens through ``eng`` and
    ``ref`` from fresh pools of their config, as many requests at a time
    as slots and pages allow, in the same slot layout on both paths:
    each prompt whole, or in chunks of ``chunk`` tokens through
    ``lm.prefill_chunk`` (each chunk reading the earlier chunks' pages),
    then one decode step a token.  Idle slots write into a spare page.

    ``ref`` runs each of these steps twice: on a copy of ``eng``'s pools
    just after ``eng``'s step (``"shared"``: it reads the pages ``eng``
    wrote and rewrites only the step's own tokens, on the same int8
    grid), and on pools of its own (``"torch"``).  Returns, per request,
    the logits rows (the prefill's, then each step's) under ``"cuda"``,
    ``"shared"`` and ``"torch"``."""
    import numpy as np

    from repro_torch.engine.paged_cache import write_prefill
    from repro_torch.models import lm

    B, ps, vocab = eng.ecfg.batch, eng.page_size, eng.cfg.vocab
    spare = eng.n_pages - 1
    perm = np.random.default_rng(7).permutation(spare).astype(np.int32)
    groups, group, need = [], [], 0
    for r in reqs:
        n = -(-(len(r.tokens) + len(streams[r.rid]) - 1) // ps)
        if n > spare:
            raise AssertionError(f"request {r.rid} needs {n} pages")
        if len(group) == B or need + n > spare:
            groups.append(group)
            group, need = [], 0
        group.append((r, n))
        need += n
    groups.append(group)
    logits = {r.rid: {"cuda": [], "shared": [], "torch": []} for r in reqs}
    for group in groups:
        table = np.full((B, eng.max_pages), spare, np.int32)
        lens = np.zeros((B,), np.int32)
        at = 0
        for b, (r, n) in enumerate(group):
            table[b, :n] = perm[at:at + n]
            at += n
            lens[b] = len(r.tokens)
        pools = {"cuda": eng.init_paged_cache(),
                 "torch": ref.init_paged_cache()}

        def run(f, rows):
            """One step ``f(engine, cache) -> (logits, cache)`` on the
            three paths; ``rows`` (slot, request id) pairs to keep."""
            out = {}
            out["cuda"], pools["cuda"] = f(eng, pools["cuda"])
            out["shared"], _ = f(ref, lm.map_groups(lambda t: t.clone(),
                                                    pools["cuda"]))
            out["torch"], pools["torch"] = f(ref, pools["torch"])
            for b, rid in rows:
                for path, lg in out.items():
                    logits[rid][path].append(lg[b, :vocab].float())

        for b, (r, _) in enumerate(group):
            toks = torch.from_numpy(r.tokens)[None].cuda()

            def prefill(e, c, row=table[b]):
                lg, caches = e.prefill_fn(e.params, {"tokens": toks})
                write_prefill(e.cfg, c, caches, row[None])
                return lg, c
            if chunk is None:
                run(prefill, [(0, r.rid)])
            for p0 in range(0, len(r.tokens) if chunk else 0, chunk or 1):
                end = min(p0 + chunk, len(r.tokens))
                part = {"tokens": toks[:, p0:end],
                        "pages": table[b, :p0 // ps],
                        "write_pages": table[b, p0 // ps:-(-end // ps)]}
                run(lambda e, c: lm.prefill_chunk(
                    e.params, {**part, "cache": c}, e.cfg),
                    [(0, r.rid)] if end == len(r.tokens) else [])
        gen = max(len(streams[r.rid]) for r, _ in group)
        for i in range(gen - 1):
            tok = np.zeros((B,), np.int32)
            live = [(b, r.rid) for b, (r, _) in enumerate(group)
                    if i + 1 < len(streams[r.rid])]
            for b, rid in live:
                tok[b] = streams[rid][i]
            cur = np.where(lens > 0, lens + i, 0)
            run(lambda e, c: e.decode_step(tok, cur, c, block_table=table),
                live)
    return logits


def _hold_streams(torch, what, eng, ref, reqs, got, want, chunk=None):
    """Greedy Scheduler streams of the kernel path on int8 pools
    (``got``, one token list a request) against the plain path's
    (``want``): equal, or held past the step where they part.

    A pool write quantizes K and V to int8, so a last-bit difference
    between two fp32 products can move a value across a rounding
    boundary (one step of the page's scale); where two candidate tokens
    lie closer than that moves the logits, the picks part.  Every
    request whose streams part is then replayed with the plain path's
    tokens (``_replay_streams``), and at every step, the split and every
    later page included, the kernel path's logits are held at
    E2E_FP32_TOL x max(1, max|logits|) to the plain path's on the same
    int8 pages (``"shared"``).  The plain path on pools of its own is
    reported beside it and not held: there the int8 rounding of the
    whole history differs between the paths, not the kernels alone.
    Returns a summary (empty where the streams are equal)."""
    if got == want:
        return {}
    parted = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if any(len(got[i]) != len(want[i]) for i in parted):
        raise AssertionError(f"{what}: streams of different lengths")
    first = min((next(j for j, (x, y) in enumerate(zip(got[i], want[i]))
                      if x != y), i) for i in parted)
    logits = _replay_streams(torch, eng, ref, [reqs[i] for i in parted],
                             {i: want[i] for i in parted}, chunk)

    def rel(x, y):
        return (x - y).abs().max().item() / max(1.0, y.abs().max().item())
    worst, own, steps, agree, agree_shared = 0.0, 0.0, 0, 0, 0
    for i in parted:
        lg = logits[i]
        for j, (x, y, z) in enumerate(zip(lg["cuda"], lg["shared"],
                                          lg["torch"])):
            err = rel(x, y)
            if not err <= E2E_FP32_TOL:
                raise AssertionError(
                    f"{what}: request {i}, replayed with the plain "
                    f"path's tokens, step {j}: max|d logits| {err:.3e} of "
                    f"scale past {E2E_FP32_TOL:g} on the same int8 pages")
            worst, own = max(worst, err), max(own, rel(x, z))
            steps += 1
            agree += int(x.argmax()) == want[i][j]
            agree_shared += int(y.argmax()) == want[i][j]
    return {"first_split": {"request": first[1], "step": first[0]},
            "parted": parted, "replayed_steps": steps,
            "max_rel_err": worst, "max_rel_err_own_pools": own,
            "kernel_picks_plain_token": agree,
            "plain_on_same_pages_picks_plain_token": agree_shared}


def _stream_note(held):
    if not held:
        return "identical"
    return (f"part at request {held['first_split']['request']} step "
            f"{held['first_split']['step']} ({len(held['parted'])} "
            "streams); replayed with the plain tokens: max|d logits| "
            f"{held['max_rel_err']:.3e} of scale on the same int8 pages "
            f"over {held['replayed_steps']} steps (limit "
            f"{E2E_FP32_TOL:g}; on each path's own pools "
            f"{held['max_rel_err_own_pools']:.3e}, not held); the plain "
            "stream's token is picked by the kernel path at "
            f"{held['kernel_picks_plain_token']}/{held['replayed_steps']} "
            "steps, by the plain path on the same pages at "
            f"{held['plain_on_same_pages_picks_plain_token']}/"
            f"{held['replayed_steps']}")


def scheduler_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: the Scheduler's greedy streams
    on the kernels equal the plain backend's over a stream that
    preempts; on int8 pools a stream that parts is held to its end
    through a replay (``_hold_streams``)."""
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler

    cfg = _reduced(name)
    streams, held = {}, {}
    for kv_dtype in ("bf16", "int8"):
        ecfg = EngineConfig(batch=3, max_len=64, paged=True, page_size=8,
                            n_pages=12, kv_dtype=kv_dtype,
                            kernel_impl="cuda")
        eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=eng.params, device="cuda")
        for e in (eng, ref):
            sched = Scheduler(e)
            reqs = _requests(cfg, 7, (5, 40), 16, seed=6)
            out = _drive(sched, reqs)
            streams[kv_dtype, e.cfg.kernel_impl] = (
                [out[i].tokens.tolist() for i in range(7)],
                sched.stats["preempted"])
        got, want = (streams[kv_dtype, k][0] for k in ("cuda", "torch"))
        if kv_dtype == "int8":
            held[kv_dtype] = _hold_streams(
                torch, f"{name} reduced fp32 int8", eng, ref, reqs, got,
                want)
        elif got != want:
            raise AssertionError(f"{name} reduced fp32 {kv_dtype}: "
                                 "Scheduler streams differ")
        print(f"  {cfg.name} fp32 Scheduler, {kv_dtype} pools: greedy "
              f"streams {_stream_note(held.get(kv_dtype))} "
              f"({streams[kv_dtype, 'cuda'][1]} preemptions)")
    return {"preemptions": {k[0]: v[1] for k, v in streams.items()
                            if k[1] == "cuda"}, "parted": held}


# ----------------------------------------------------------------------
# phase 6: the prefix cache and chunked prefill
# ----------------------------------------------------------------------

# chunked prefill at full width: 64-token chunks (4 pages of 16), the
# default budget of slots + chunk = 72 tokens a step
CHUNK_TOKENS = 64
# the shared-prompt stream: N_SHARED requests open with one SYSTEM-token
# system prompt (8 whole pages) and a unique tail of TAIL tokens; the
# rest have unique prompts of PROMPT tokens; arrivals as in _drive
SYSTEM, TAIL, N_SHARED = 128, (16, 128), 16
# (pool dtype, prefix cache, chunked prefill) of each stream, off/off
# first: the on/on streams are compared with it
PC_MODES = (("bf16", False, False), ("bf16", True, True),
            ("int8", False, False), ("int8", True, True),
            ("bf16", True, False), ("bf16", False, True))


def _shared_requests(cfg, seed=4):
    import numpy as np

    from repro_torch.engine import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, SYSTEM)
    prompts = [np.concatenate([system, rng.integers(
        0, cfg.vocab, int(rng.integers(TAIL[0], TAIL[1] + 1)))])
        for _ in range(N_SHARED)]
    prompts += [rng.integers(0, cfg.vocab, int(rng.integers(
        PROMPT[0], PROMPT[1] + 1))) for _ in range(N_REQ - N_SHARED)]
    order = rng.permutation(N_REQ)
    return [Request(rid=i, tokens=prompts[j].astype(np.int32), gen=GEN)
            for i, j in enumerate(order)]


def _stream_launches(st, n_layers, kv_dtype, prefix, chunked):
    """The launches a stream must count: the paged decode kernel of its
    pool dtype every step (a mixed step too), vwr_attention for every
    whole-prompt prefill (none when chunked; a prefix hit prefills its
    suffix on the blockwise path), the matmuls for every prefill pass
    (a whole or suffix prefill, or a chunk) and decode step, and never
    the chunk-prefix kernels: the engine's chunk path, like the JAX
    package's, does not reach them."""
    paged = "vwr_paged_flash_decode" + ("_q8" if kv_dtype == "int8" else "")
    other = ("vwr_paged_flash_decode" if kv_dtype == "int8"
             else "vwr_paged_flash_decode_q8")
    passes = st["chunks"] if chunked else st["prefills"]
    whole = 0 if chunked else (st["prefix_misses"] if prefix
                               else st["prefills"])
    L = n_layers
    return {paged: L * st["steps"], other: 0, "vwr_flash_decode": 0,
            "vwr_attention": L * whole,
            "vwr_swiglu": L * (passes + st["steps"]),
            "vwr_matmul": L * (5 * passes + st["steps"]),
            "vwr_chunk_prefix_attend": 0, "vwr_chunk_prefix_attend_q8": 0}


def chunk_rows(torch, params):
    """Full-width chunk rows: tinyllama-1.1b's layer 0 (conditioned random
    weights) on a 256-token prompt, q/k/v from the port's ``qkv_proj`` on
    the kernels, K/V written into bf16 and int8 pools by
    ``write_prefill``; for chunks at 64, 128 and 192, the chunk's rows
    through ``chunk_prefill_attend`` (bf16) or
    ``dist.decode.local_chunk_prefix_attend`` with the pools' scales,
    merged with ``chunk_self_attn_partial`` (int8), on the 'cuda'
    backend, against the plain fp32 whole-prompt causal pass (bf16) or
    the same math on the dequantized pools (int8).  The launch counts of
    kernels 6 and 8 are read over this phase."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist import decode as DD
    from repro_torch.engine import paged_cache as PC
    from repro_torch.kernels import build
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import lm

    cfg = get_config("tinyllama-1.1b")
    lp = lm._layer(params["layers"], 0)
    P, C, n_pages = 256, CHUNK_TOKENS, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=g, device="cuda",
                         dtype=torch.int32)
    h = lm._norm(cfg, lp["attn_norm"],
                 LY.embed(params["embed"], toks).to(torch.bfloat16))
    q, k, v = A.qkv_proj(lp["attn"], h, torch.arange(P, device="cuda"),
                         cfg.rope_theta, cfg)
    whole = A.full_attn_ref(q.float(), k.float(), v.float(),
                            causal=True)[0]
    one = cfg.replace(n_layers=1)
    pages = np.random.default_rng(8).permutation(n_pages)[:P // PAGE]
    q, k, v = q[0], k[0], v[0]
    torch.cuda.synchronize()
    build.reset_launches()
    out = {}
    for kv_dtype in ("bf16", "int8"):
        cache = PC.init_paged_cache(one, n_pages, PAGE, kv_dtype=kv_dtype,
                                    device="cuda")
        PC.write_prefill(one, cache, (k[None, None], v[None, None]),
                         pages[None].astype(np.int32))
        kp, vp = cache["k"][0], cache["v"][0]
        rel = []
        for c0 in (64, 128, 192):
            jp = c0 // PAGE
            table = torch.from_numpy(pages[:jp].astype(np.int32)).cuda()
            counts = torch.full((jp,), PAGE, dtype=torch.int32,
                                device="cuda")
            qc, kc, vc = q[c0:c0 + C], k[c0:c0 + C], v[c0:c0 + C]
            if kv_dtype == "bf16":
                got = A.chunk_prefill_attend(qc, kc, vc, kp, vp, table,
                                             counts, backend="cuda")
                want = whole[c0:c0 + C]
            else:
                ks, vs = cache["k_scale"][0], cache["v_scale"][0]
                part = DD.local_chunk_prefix_attend(
                    qc, kp, vp, table, counts, k_scale=ks, v_scale=vs,
                    backend="cuda")
                o_t, _, l = A.merge_partials(
                    part, A.chunk_self_attn_partial(qc, kc, vc))
                got = A.normalize_partial(o_t, l, torch.float32)
                kd = kp.float() * ks[:, None, :, None]
                vd = vp.float() * vs[:, None, :, None]
                o_t, _, l = A.merge_partials(
                    A.chunk_prefix_attend_partial(qc.float(), kd, vd,
                                                  table, counts),
                    A.chunk_self_attn_partial(qc.float(), kc.float(),
                                              vc.float()))
                want = A.normalize_partial(o_t, l, torch.float32)
            torch.cuda.synchronize()
            rel.append(((got.float() - want).abs().max()
                        / want.abs().max()).item())
        limit = E2E_BF16_REL if kv_dtype == "bf16" else CHUNK_Q8_REL
        print(f"  {kv_dtype} pools, chunks at 64/128/192 of a {P}-token "
              f"prompt (layer 0, {cfg.n_heads} heads / {cfg.n_kv_heads} KV,"
              f" D {cfg.d_head}): max |d|/max|ref| "
              + ", ".join(f"{r:.3e}" for r in rel)
              + f" (limit {limit:g})")
        if not max(rel) <= limit:
            raise AssertionError(f"chunk rows, {kv_dtype} pools: off the "
                                 "reference")
        out[kv_dtype] = rel
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in
                ("vwr_chunk_prefix_attend", "vwr_chunk_prefix_attend_q8")}
    print(f"  launches in the chunk phase: {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError("a chunk-prefix kernel was never launched")
    return {"rel_err": out, "launches": launches}


def chunked_prefill_logits(torch, params):
    """Full-width chunked prefill on the engine's chunk path: a 256-token
    prompt through ``lm.prefill_chunk`` 64 tokens at a time on the
    kernels; the final chunk's logits (those that pick a chunked
    request's first token) against the plain path's.  bf16 pools: the
    plain whole-prompt prefill (as the kernels' whole prefill is, shown
    beside it).  int8 pools: the plain chunked prefill over int8 pools
    (a later chunk reads the earlier ones through the quantized pages,
    so against the whole prefill it is shown, not held)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import paged_cache as PC
    from repro_torch.models import lm

    cfg = get_config("tinyllama-1.1b")
    plain = cfg.replace(kernel_impl="torch")
    P, C, n_pages = 256, CHUNK_TOKENS, 32
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=g, device="cuda",
                         dtype=torch.int32)
    pages = np.random.default_rng(9).permutation(n_pages)[:P // PAGE]
    pages = pages.astype(np.int32)
    V = cfg.vocab

    def chunked(c, kv_dtype):
        cache = PC.init_paged_cache(c, n_pages, PAGE, kv_dtype=kv_dtype,
                                    device="cuda")
        for p0 in range(0, P, C):
            logits, cache = lm.prefill_chunk(params, {
                "tokens": toks[:, p0:p0 + C], "pages": pages[:p0 // PAGE],
                "write_pages": pages[p0 // PAGE:(p0 + C) // PAGE],
                "cache": cache}, c)
        return logits[:, :V]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    whole = lm.prefill(params, {"tokens": toks}, plain)[0][:, :V]
    q8 = chunked(cfg, "int8")
    out = {"whole_kernel": rel(lm.prefill(params, {"tokens": toks},
                                          cfg)[0][:, :V], whole),
           "bf16": rel(chunked(cfg, "bf16"), whole),
           "int8": rel(q8, chunked(plain, "int8")),
           "int8_vs_whole": rel(q8, whole)}
    print(f"  a {P}-token prompt in chunks of {C} through lm.prefill_chunk "
          f"(tinyllama-1.1b, 22 layers), final logits, max |d|/max|ref|: "
          f"bf16 pools vs the plain whole prefill {out['bf16']:.3e} (the "
          f"kernels' whole prefill {out['whole_kernel']:.3e}); int8 pools "
          f"vs the plain chunked prefill {out['int8']:.3e} (vs the plain "
          f"whole prefill {out['int8_vs_whole']:.3e}, shown); limit "
          f"{E2E_BF16_REL:g}")
    if not max(out["bf16"], out["int8"]) <= E2E_BF16_REL:
        raise AssertionError("chunked prefill logits off the plain path")
    return out


def serve_prefix_chunked(torch, params):
    """Full-width tinyllama-1.1b through the Scheduler with the prefix
    cache and chunked prefill, on the shared-prompt stream, in each of
    PC_MODES: launch counts checked, every request finished and every
    page back (but the trie's), the on/on streams replayed
    teacher-forced against the plain path (``_replay_slots``) and
    compared with the off/off streams."""
    from repro_torch.configs import get_config
    from repro_torch.engine import (DecodeEngine, EngineConfig,
                                    RequestStatus, Scheduler)
    from repro_torch.kernels import build

    cfg = get_config("tinyllama-1.1b")
    engines = {}
    for kv_dtype in ("bf16", "int8"):
        eng = DecodeEngine(cfg, EngineConfig(
            batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
            page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
            chunk_tokens=CHUNK_TOKENS, kernel_impl="cuda"),
            params=params, device="cuda")
        # warm-up: the first launches of the suffix and chunk paths
        _drive(Scheduler(eng, prefix_cache=True, chunked_prefill=True),
               _requests(cfg, 4, PROMPT, 4, seed=5))
        engines[kv_dtype] = eng
    print(f"Scheduler with the prefix cache and chunked prefill, "
          f"tinyllama-1.1b: {N_REQ} requests ({N_SHARED} open with one "
          f"{SYSTEM}-token system prompt + {TAIL[0]}-{TAIL[1]} tokens, "
          f"{N_REQ - N_SHARED} unique of {PROMPT[0]}-{PROMPT[1]}), gen "
          f"{GEN}, chunk {CHUNK_TOKENS}")
    summaries, outs = [], {}
    for kv_dtype, prefix, chunked in PC_MODES:
        eng = engines[kv_dtype]
        reqs = _shared_requests(cfg)
        sched = Scheduler(eng, prefix_cache=prefix, chunked_prefill=chunked)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = _drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        st = sched.stats
        tag = (f"{kv_dtype} pools, prefix {'on' if prefix else 'off'}, "
               f"chunked {'on' if chunked else 'off'}")
        want = _stream_launches(st, cfg.n_layers, kv_dtype, prefix,
                                chunked)
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"{tag}: {k} launched {launches[k]} "
                                     f"times, expected {n}")
        bad = {rid: r.status for rid, r in out.items()
               if r.status is not RequestStatus.FINISHED or len(r) != GEN}
        if len(out) != N_REQ or bad:
            raise AssertionError(f"{tag}: unfinished {bad}")
        sched.allocator.check()
        cached = sched.prefix.cached_pages if prefix else 0
        if sched.allocator.free_pages != N_PAGES - cached:
            raise AssertionError(f"{tag}: pages left allocated")
        if prefix and chunked and not (st["prefix_hits"] > 0
                                       and st["chunks"] > 0):
            raise AssertionError(f"{tag}: no prefix hit or no chunk")
        n_tok = sum(len(r) for r in out.values())
        lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
        keys = ("steps", "prefills", "preempted", "parked", "peak_pages",
                "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_evictions", "shared_pages", "cow_forks",
                "mixed_steps", "chunks", "chunked_tokens")
        summary = {"kv_dtype": kv_dtype, "prefix": prefix,
                   "chunked": chunked, **{k: st[k] for k in keys},
                   "table_widths": {str(k): v for k, v in
                                    sorted(st["table_widths"].items())},
                   "generated_tokens": n_tok, "wall_s": wall,
                   "gen_tok_s": n_tok / wall,
                   "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
                   "itl_p50_s": itl["p50"], "itl_p99_s": itl["p99"],
                   "launches": launches}
        print(f"  {tag}: steps {st['steps']}, prefills {st['prefills']}, "
              f"preempted {st['preempted']}, peak pages "
              f"{st['peak_pages']}/{N_PAGES}, table widths "
              f"{summary['table_widths']}")
        print("    " + ", ".join(f"{k} {st[k]}" for k in keys[5:]))
        print(f"    {n_tok} tokens in {wall:.4f} s: "
              f"{summary['gen_tok_s']:.1f} generated tok/s; request "
              f"latency p50 {lat['p50']:.4f} s p99 {lat['p99']:.4f} s; "
              f"ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
              f"{itl['p99'] * 1e3:.3f} ms")
        print(f"    launches: {launches}")
        outs[kv_dtype, prefix, chunked] = out
        if prefix and chunked:
            base = outs[kv_dtype, False, False]
            same = sum(bool((out[rid] == base[rid]).all()) for rid in out)
            print(f"    {same}/{N_REQ} streams equal to the off/off run")
            summary["streams_equal_off"] = same
            rel, agree, flips = _replay_slots(
                torch, eng, sched.cache, reqs, out, kv_dtype,
                agree_floor=(REPLAY_AGREE if kv_dtype == "bf16"
                             else REPLAY_AGREE_Q8))
            summary.update(logits_rel_err=rel, replay_agree=agree,
                           replay_flips=flips)
        summaries.append(summary)
        del sched
    del engines
    torch.cuda.empty_cache()
    return summaries


def _dense_mla():
    """The dense family with MLA attention: reduced tinyllama with the JAX
    matrices' ``mla`` block (latent rank 16, rope width 8)."""
    from repro_torch.common.config import MLAConfig

    return _reduced("tinyllama-1.1b").replace(
        name="tinyllama-1.1b-reduced+mla", mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
            nope_head_dim=16, v_head_dim=16))


def scheduler_reduced_prefix_chunked(torch, name, cfg=None):
    """Reduced fp32 config on the card (``cfg``, or ``name``'s), over a
    pool that preempts and requests that share a 16-token system prompt:
    with model-dtype pools the prefix-cache and chunked streams on the
    kernels equal the prefix-off, unchunked streams on the plain
    backend, token for token; with int8 pools (a hit or a later chunk
    reads the prefix through the quantized pages, so a near-tie may pick
    otherwise than the off/off run), and for the moe family (a chunk or
    a suffix is its own MoE group, whose capacity drops differ from the
    whole prompt's), they equal the plain backend's prefix and chunked
    streams, and the streams equal to the off/off run are counted; on
    int8 pools a stream that parts is held to its end through a replay
    with its prompt in chunks (``_hold_streams``)."""
    import numpy as np

    from repro_torch.engine import (DecodeEngine, EngineConfig, Request,
                                    Scheduler)

    cfg = cfg or _reduced(name)
    rng = np.random.default_rng(6)
    system = rng.integers(0, cfg.vocab, 16)
    prompts = ([np.concatenate([system, rng.integers(0, cfg.vocab, int(n))])
                for n in rng.integers(1, 20, 4)]
               + [rng.integers(0, cfg.vocab, int(n))
                  for n in rng.integers(5, 40, 3)])

    def run(eng, **kw):
        sched = Scheduler(eng, **kw)
        out = _drive(sched, [Request(rid=i, tokens=p.astype(np.int32),
                                     gen=16) for i, p in enumerate(prompts)])
        return ([out[i].tokens.tolist() for i in range(len(prompts))],
                sched)

    summary = {}
    for kv_dtype in ("bf16", "int8"):
        ecfg = EngineConfig(batch=3, max_len=64, paged=True, page_size=8,
                            n_pages=12, kv_dtype=kv_dtype,
                            chunk_tokens=8, kernel_impl="cuda")
        eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=eng.params, device="cuda")
        on = dict(prefix_cache=True, chunked_prefill=True)
        got, sched = run(eng, **on)
        off, _ = run(ref)
        same_modes = kv_dtype == "int8" or cfg.family == "moe"
        want = run(ref, **on)[0] if same_modes else off
        st = sched.stats
        if not (st["prefix_hits"] > 0 and st["chunks"] > 0):
            raise AssertionError(f"{name} reduced fp32 {kv_dtype}: no "
                                 "prefix hit or no chunk")
        held = {}
        if kv_dtype == "int8":
            reqs = [Request(rid=i, tokens=p.astype(np.int32), gen=16)
                    for i, p in enumerate(prompts)]
            held = _hold_streams(
                torch, f"{cfg.name} reduced fp32 int8 prefix + chunked",
                eng, ref, reqs, got, want, chunk=ecfg.chunk_tokens)
        elif got != want:
            raise AssertionError(
                f"{name} reduced fp32 {kv_dtype}: prefix and chunked "
                "streams on the kernels differ from the plain backend's")
        same = sum(a == b for a, b in zip(got, off))
        print(f"  {cfg.name} fp32 Scheduler, {kv_dtype} pools, prefix + "
              f"chunked on the kernels: {st['prefix_hits']} hits, "
              f"{st['chunks']} chunks, {st['preempted']} preemptions; "
              f"{_stream_note(held)} to the plain "
              f"{'prefix + chunked' if same_modes else 'off/off'}"
              f" streams; {same}/{len(prompts)} equal to the plain off/off")
        summary[kv_dtype] = {k: st[k] for k in (
            "prefix_hits", "chunks", "preempted", "prefix_evictions")}
        summary[kv_dtype].update(streams_equal_off=same, parted=held)
    return summary


# ----------------------------------------------------------------------
# phase 7: DeepSeek-V3, the moe family with MLA
# ----------------------------------------------------------------------

# DeepSeek-V3 at its published widths, cut in depth only: its 3 dense
# layers (d_ff 18,432) and 1 MoE layer (256 experts of 2,048, top-8,
# 1 shared, sigmoid scores, routed scale 2.5): 15.1 G parameters
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_DEPTH = 4


class _Routes:
    """Records every MoE FFN call's top-k expert sets (sorted ids, one
    row a token) under the current ``tag``, to count the (token, layer)
    sets that differ between the kernel and the plain path."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.top_k_gates
        self.tag, self.log = None, {}

    def __enter__(self):
        def top_k_gates(probs, sel, cfg):
            gates, idx = self.orig(probs, sel, cfg)
            if self.tag is not None:
                self.log.setdefault(self.tag, []).append(
                    idx.sort(-1).values.reshape(-1, idx.shape[-1]))
            return gates, idx
        self.moe.top_k_gates = top_k_gates
        return self

    def __exit__(self, *exc):
        self.moe.top_k_gates = self.orig

    def take(self, tag):
        return self.log.pop(tag, [])


def _differ(a, b):
    """Rows (tokens) whose expert sets differ between two calls' logs."""
    return (a != b).any(-1)


def _hold_with_flips(what, rel, flipped):
    """Hold every (step, row) relative logits error to E2E_BF16_REL,
    except rows whose MoE group saw an expert set differ between the
    two paths, which are counted and printed with their errors.  Random
    routers put near-ties in the top-8 of 256 sigmoid scores, which the
    two paths' bf16 roundings break apart; a flip moves that token's
    output and, through the capacity drops, its group's (a prefill's
    sequence, a decode step's slots).  The one MoE layer is the last
    layer at depth 4, so a flip reaches no other row.  Returns the
    summary."""
    rel = [float(x) for x in rel]
    held = [x for x, f in zip(rel, flipped) if not f]
    flips = [x for x, f in zip(rel, flipped) if f]
    worst = max(held) if held else 0.0
    print(f"  {what}: logits vs the plain path max |d|/max|ref| "
          f"{max(rel):.3e} over {len(rel)} rows (limit {E2E_BF16_REL:g}); "
          f"{len(flips)} rows with a routing flip between the paths"
          + (f", their max {max(flips):.3e}; without them {worst:.3e}"
             if flips else ""))
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"{what}: logits diverge from the plain path "
                             "where the routing agrees")
    return {"max_rel": max(rel), "max_rel_routing_agrees": worst,
            "rows": len(rel), "flipped_rows": len(flips),
            "flipped_max_rel": max(flips) if flips else None}


def deepseek_generate(torch, eng, ref, routes, gen=32):
    """``generate`` on the kernels (launches counted: kernel 10 four
    times a decode step), then the stream teacher-forced through both
    paths with their routing compared.  Returns the summary and the
    kernel path's dense latent cache after the stream."""
    from repro_torch.kernels import build

    cfg, vocab = eng.cfg, eng.cfg.vocab
    B, P, L = eng.ecfg.batch, 128, cfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, vocab, (B, P), generator=g, device="cuda",
                            dtype=torch.int32)
    eng.generate({"tokens": prompts}, gen=gen)          # warm-up
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": prompts}, gen=gen)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(vwr_mla_flash_decode=L * (gen - 1), vwr_swiglu=L * gen,
                vwr_matmul=L * gen)
    print(f"  generate batch {B}, prompt {P}, gen {gen}: launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"deepseek generate: launches {launches}, "
                             f"expected {want}")
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"deepseek: bad tokens {tokens.shape}")
    print(f"  prefill_tok_s {stats['prefill_tok_s']:.1f}  decode_tok_s "
          f"{stats['decode_tok_s']:.1f}  (t_prefill {stats['t_prefill_s']:.4f}"
          f" s, t_decode {stats['t_decode_s']:.4f} s)")

    rel, flipped, n_moe = [], [], L - cfg.moe.first_k_dense
    diff_rows = [0] * n_moe
    routes.tag = "cuda"
    lc, cc = eng.prefill({"tokens": prompts})
    routes.tag = "torch"
    lr, cr = ref.prefill({"tokens": prompts})
    for i in range(gen):
        if not bool((lc.argmax(-1).to(torch.int32) == tokens[:, i]).all()):
            raise AssertionError(f"step {i}: the kernel path is not "
                                 "deterministic (replay != generate)")
        d = [_differ(a, b) for a, b in zip(routes.take("cuda"),
                                            routes.take("torch"))]
        for j, x in enumerate(d):
            diff_rows[j] += int(x.sum())
        # a prefill groups each sequence's tokens, a decode step all B
        # rows: a flip anywhere in the group can move capacity drops
        flip = torch.stack(d).any(0).reshape(B, -1).any(-1)
        if i:
            flip[:] = flip.any()
        err = (lc - lr)[:, :vocab].abs().amax(-1)
        scale = lr[:, :vocab].abs().max()
        for b in range(B):
            rel.append((err[b] / scale).item())
            flipped.append(bool(flip[b]))
        if i + 1 < gen:
            tok = tokens[:, i]
            routes.tag = "cuda"
            lc, cc = _decode(eng, tok, P + i, cc)
            routes.tag = "torch"
            lr, cr = _decode(ref, tok, P + i, cr)
    routes.tag = None
    summary = _hold_with_flips("generate, teacher-forced", rel, flipped)
    print(f"  expert sets (token, MoE layer) differing between the paths: "
          f"{diff_rows} of {B * P + B * (gen - 1)} a layer (prefill "
          "tokens and decode rows)")
    del cr
    return {"batch": B, "prompt": P, "gen": gen, "launches": launches,
            "expert_sets_differ": diff_rows, **summary, **stats}, cc


def deepseek_kernel14(torch, cfg, cache, cur_len):
    """Kernel 14 through ``dist.decode.local_mla_decode_attend`` with
    per-sequence int8 scales over the latent cache ``generate`` left
    behind, quantized one scale a sequence (latent and rope apart),
    held to the plain dequantize-then-attend op; launches counted."""
    from repro_torch.dist import decode as DD
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import int8_scale

    g = torch.Generator(device="cuda").manual_seed(11)
    atol, rtol = TOL["float32"]
    m = cfg.mla
    scale = 1.0 / (m.nope_head_dim + m.rope_head_dim) ** 0.5
    work = []
    for grp in (cache["dense"], cache["moe"]):
        for i in range(grp["ckv"].shape[0]):
            q8, sc = [], []
            for x in (grp["ckv"][i], grp["krope"][i]):
                s = int8_scale(x.float().abs().amax(dim=(1, 2)))   # (B,)
                q8.append(torch.clamp(torch.round(x.float() / s[:, None,
                                                               None]),
                                      -127, 127).to(torch.int8))
                sc.append(s)
            B = q8[0].shape[0]
            q = (torch.randn(B, cfg.n_heads, m.kv_lora_rank, generator=g,
                             device="cuda"),
                 torch.randn(B, cfg.n_heads, m.rope_head_dim, generator=g,
                             device="cuda"))
            work.append((q, q8, sc))
    build.reset_launches()
    got = [DD.local_mla_decode_attend(*q, *q8, cur_len, scale=scale,
                                      ckv_scale=sc[0], krope_scale=sc[1],
                                      backend="cuda")
           for q, q8, sc in work]
    torch.cuda.synchronize()
    launches = build.LAUNCHES["vwr_mla_flash_decode_q8"]
    err = 0.0
    for (q, q8, sc), x in zip(work, got):
        want = DD.local_mla_decode_attend(*q, *q8, cur_len, scale=scale,
                                          ckv_scale=sc[0],
                                          krope_scale=sc[1],
                                          backend="torch")
        d = (x - want).abs()
        err = max(err, d.max().item())
        if not bool((d <= atol + rtol * want.abs()).all()):
            raise AssertionError("kernel 14 disagrees with "
                                 "dequantize-then-attend")
    print(f"  kernel 14 over the int8 latent cache of generate ({len(work)}"
          f" layers, cur_len {cur_len}): max|err| {err:.3e} (atol {atol:g},"
          f" rtol {rtol:g}), {launches} launches")
    if launches != len(work):
        raise AssertionError(f"kernel 14 launched {launches} times")
    return {"layers": len(work), "max_abs_err": err, "launches": launches}


def deepseek_scheduler(torch, params, cfg, kv_dtype, routes,
                       prefix_chunked=False):
    """Full-width DeepSeek-V3 through the Scheduler on the kernels, launch
    counts checked (kernel 11 or 13 four times a decode or mixed step),
    then 8 finished requests replayed teacher-forced in the 8 live slots
    through both paths.  The stream of ``serve_scheduler`` (8 slots, 128
    pages of 16, 24 requests, prompts 32-256, gen 32); with
    ``prefix_chunked`` the shared-prompt stream of
    ``serve_prefix_chunked`` with the prefix cache and chunked prefill
    (chunks of CHUNK_TOKENS) on, replayed through chunked prefills, and
    kernels 12 and 15 run on the prefix pages it left in its pools
    (``deepseek_chunk_prefix``)."""
    from repro_torch.engine import (DecodeEngine, EngineConfig,
                                    RequestStatus, Scheduler)
    from repro_torch.kernels import build

    ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
                        page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
                        chunk_tokens=CHUNK_TOKENS, kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, params=params, device="cuda")
    modes = dict(prefix_cache=prefix_chunked, chunked_prefill=prefix_chunked)
    tag = f"{kv_dtype} pools" + (", prefix cache + chunked prefill"
                                 if prefix_chunked else "")
    print(f"  Scheduler, {tag}: {SLOTS} slots, {N_PAGES} pages of {PAGE}, "
          f"{N_REQ} requests, " + (
              f"{N_SHARED} open with one {SYSTEM}-token system prompt, "
              f"chunk {CHUNK_TOKENS}, " if prefix_chunked else
              f"prompts {PROMPT[0]}-{PROMPT[1]}, ") + f"gen {GEN}")
    _drive(Scheduler(eng, **modes), _requests(cfg, 4, PROMPT, 4, seed=5))
    reqs = (_shared_requests(cfg) if prefix_chunked
            else _requests(cfg, N_REQ, PROMPT, GEN, seed=4))
    sched = Scheduler(eng, **modes)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    st = sched.stats
    L = cfg.n_layers
    paged = "vwr_mla_paged_flash_decode" + ("_q8" if kv_dtype == "int8"
                                            else "")
    # a prefill pass: a whole prompt, a suffix, or a chunk
    passes = st["chunks"] if prefix_chunked else st["prefills"]
    want = {k: 0 for k in launches}
    want.update({paged: L * st["steps"],
                 "vwr_swiglu": L * (passes + st["steps"]),
                 "vwr_matmul": L * (passes + st["steps"])})
    print(f"    launches: { {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"deepseek scheduler {tag}: launches "
                             f"{launches}, expected {want}")
    bad = {rid: r.status for rid, r in out.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN}
    if len(out) != N_REQ or bad:
        raise AssertionError(f"deepseek scheduler {tag}: unfinished {bad}")
    sched.allocator.check()
    cached = sched.prefix.cached_pages if prefix_chunked else 0
    if sched.allocator.free_pages != N_PAGES - cached:
        raise AssertionError(f"{tag}: pages left allocated after the "
                             "drain")
    if prefix_chunked and not (st["prefix_hits"] > 0 and st["chunks"] > 0):
        raise AssertionError(f"{tag}: no prefix hit or no chunk")
    n_tok = sum(len(r) for r in out.values())
    lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
    keys = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_evictions", "shared_pages", "cow_forks", "mixed_steps",
            "chunks", "chunked_tokens")
    summary = {
        "kv_dtype": kv_dtype, "prefix_chunked": prefix_chunked,
        "steps": st["steps"], "prefills": st["prefills"],
        "preempted": st["preempted"], "peak_pages": st["peak_pages"],
        **({k: st[k] for k in keys} if prefix_chunked else {}),
        "table_widths": {str(k): v for k, v in
                         sorted(st["table_widths"].items())},
        "generated_tokens": n_tok, "wall_s": wall,
        "gen_tok_s": n_tok / wall, "latency_p50_s": lat["p50"],
        "latency_p99_s": lat["p99"], "itl_p50_s": itl["p50"],
        "itl_p99_s": itl["p99"], "launches": launches}
    print(f"    steps {st['steps']}, prefills {st['prefills']}, preempted "
          f"{st['preempted']}, peak pages {st['peak_pages']}/{N_PAGES}, "
          f"table widths {summary['table_widths']}")
    if prefix_chunked:
        print("    " + ", ".join(f"{k} {st[k]}" for k in keys))
    print(f"    {n_tok} tokens in {wall:.4f} s: {summary['gen_tok_s']:.1f} "
          f"generated tok/s; request latency p50 {lat['p50']:.4f} s p99 "
          f"{lat['p99']:.4f} s; ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
          f"{itl['p99'] * 1e3:.3f} ms")
    if prefix_chunked:
        summary["chunk_prefix"] = deepseek_chunk_prefix(
            torch, eng.params, cfg, sched, reqs)
        sched.prefix.clear()
        sched.allocator.check()
        if sched.allocator.free_pages != N_PAGES:
            raise AssertionError(f"{tag}: pages left allocated after the "
                                 "trie was cleared")
        print(f"    all {N_PAGES} pages free once the trie's "
              f"{cached} are released")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=params, device="cuda")
    summary["replay"] = _replay_both(
        torch, eng, ref, sched.cache, reqs, out, routes,
        chunk=CHUNK_TOKENS if prefix_chunked else None)
    del eng, ref, sched
    torch.cuda.empty_cache()
    return summary


def deepseek_chunk_prefix(torch, params, cfg, sched, reqs):
    """Kernels 12 and 15 on the stream's own data: the shared system
    prompt's pages, found in the drained Scheduler's prefix trie, and the
    absorbed queries of the next CHUNK_TOKENS tokens of a request that
    opens with it, each layer's from its true input (the suffix prefill
    of those tokens over those pages, on the plain path, run layer by
    layer).  ``chunk_prefix_mla_paged`` (bf16 pools) or its q8 op (int8,
    with the pools' page scales) on the 'cuda' backend against the
    'torch' op; launches counted, one a layer."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels import dispatch as D
    from repro_torch.models import layers as LY
    from repro_torch.models import lm
    from repro_torch.models import mla as MLA

    req = next(r for r in reqs if len(r.tokens) >= SYSTEM + CHUNK_TOKENS
               and len(sched.prefix.match(r.tokens)) * PAGE >= SYSTEM)
    pages = np.asarray(sched.prefix.match(req.tokens)[:SYSTEM // PAGE],
                       np.int32)
    M, C = len(pages) * PAGE, CHUNK_TOKENS
    plain = cfg.replace(kernel_impl="torch")
    cache = sched.cache
    toks = torch.from_numpy(req.tokens[M:M + C]).cuda()[None]
    q_pos = torch.arange(C, device="cuda") + M
    kv_pos = torch.arange(M + C, device="cuda")
    pages_d = torch.from_numpy(pages).cuda()
    x = LY.embed(params["embed"], toks).to(torch.bfloat16)
    table = pages_d.to(torch.int32)
    counts = torch.full((len(pages),), PAGE, dtype=torch.int32,
                        device="cuda")
    work = []
    for stacked, key, moe in lm._groups(cfg, params):
        group = lm._cache_group(cache, key)
        prefix = lm._gather_prefix_kv(group, ("ckv", "krope"),
                                      pages_d.long())
        for i in range(lm._depth(stacked)):
            lp = lm._layer(stacked, i)
            h = lm._norm(cfg, lp["attn_norm"], x)
            q_nope, q_rope = MLA.mla_queries(lp["attn"], h, q_pos, cfg)
            q_abs, q_rope, scale = MLA.mla_absorbed_queries(
                lp["attn"], q_nope[0], q_rope[0], cfg)
            pools = [group[n][i] for n in ("ckv", "krope")]
            scales = [group[n][i] for n in ("ckv_scale", "krope_scale")
                      if n in group]
            work.append((q_abs, q_rope, pools, scales, scale))
            body = lm._moe_suffix_body if moe else lm._dense_suffix_body
            x, _ = body(plain, q_pos, kv_pos, x, lp,
                        tuple(t[i] for t in prefix))
    op = "chunk_prefix_mla_paged" + ("_q8" if work[0][3] else "")
    torch.cuda.synchronize()
    build.reset_launches()
    got = [D.dispatch(op, "cuda", qa, qr, *pools, *scales, table, counts,
                      scale=scale)
           for qa, qr, pools, scales, scale in work]
    torch.cuda.synchronize()
    kernel = "vwr_mla_chunk_prefix_attend" + ("_q8" if work[0][3] else "")
    launches = build.LAUNCHES[kernel]
    atol, rtol = TOL["float32"]
    err = 0.0
    for (qa, qr, pools, scales, scale), part in zip(work, got):
        want = D.dispatch(op, "torch", qa, qr, *pools, *scales, table,
                          counts, scale=scale)
        for a, b in zip(part, want):
            d = (a - b).abs()
            err = max(err, d.max().item())
            if not bool((d <= atol + rtol * b.abs()).all()):
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     "op on the stream's prefix pages")
    print(f"    {kernel} on the stream's {len(pages)} system-prompt pages, "
          f"a {C}-token chunk at position {M}, {len(work)} layers: "
          f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}), "
          f"{launches} launches")
    if launches != len(work):
        raise AssertionError(f"{kernel} launched {launches} times")
    return {"kernel": kernel, "pages": len(pages), "chunk": C,
            "layers": len(work), "max_abs_err": err, "launches": launches}


def _replay_both(torch, eng, ref, cache, reqs, out, routes, chunk=None):
    """Replay the first 8 finished requests that fit the pool together,
    one a slot, teacher-forced with their served tokens, through the
    kernel engine on the drained stream's pools (stale pages and scales
    included) and through the plain engine on a copy of them, in the
    same slot layout: the MoE FFN's decode group (and so its capacity
    drops) is then the same on both paths, which a batch-1 reference
    would not share.  Each prompt goes in whole, or with ``chunk`` in
    chunks of that many tokens through ``lm.prefill_chunk`` (each chunk
    its own MoE group, as in the stream).  Logits are held where the
    routing agrees; the served token's agreement is counted for both
    paths (the served stream had other slot mates, so other capacity
    drops)."""
    import numpy as np

    from repro_torch.engine.paged_cache import write_prefill
    from repro_torch.models import lm

    cfg, vocab = eng.cfg, eng.cfg.vocab
    picked, need = [], 0
    for r in reqs:
        n = -(-(len(r.tokens) + GEN - 1) // PAGE)
        if len(picked) < SLOTS and need + n <= N_PAGES:
            picked.append((r, n))
            need += n
    if len(picked) < SLOTS:
        raise AssertionError(f"only {len(picked)} requests fit the pool")
    perm = np.random.default_rng(7).permutation(N_PAGES).astype(np.int32)
    table = np.zeros((SLOTS, eng.max_pages), np.int32)
    lens = np.zeros((SLOTS,), np.int32)
    served = np.zeros((SLOTS, GEN), np.int32)
    at = 0
    for b, (r, n) in enumerate(picked):
        table[b, :n] = perm[at:at + n]
        at += n
        lens[b] = len(r.tokens)
        served[b] = out[r.rid].tokens
    logits = {}
    pools = {"cuda": cache, "torch": lm.map_groups(lambda t: t.clone(),
                                                   cache)}
    for path, e in (("cuda", eng), ("torch", ref)):
        c = pools[path]
        got = [[] for _ in picked]
        for b, (r, _) in enumerate(picked):
            routes.tag = (path, "prefill", b)
            toks = torch.from_numpy(r.tokens)[None].cuda()
            if chunk is None:
                lg, caches = e.prefill_fn(e.params, {"tokens": toks})
                write_prefill(cfg, c, caches, table[b][None])
            for p0 in range(0, len(r.tokens) if chunk else 0, chunk or 1):
                end = min(p0 + chunk, len(r.tokens))
                lg, c = lm.prefill_chunk(e.params, {
                    "tokens": toks[:, p0:end],
                    "pages": table[b, :p0 // PAGE],
                    "write_pages": table[b, p0 // PAGE:-(-end // PAGE)],
                    "cache": c}, e.cfg)
            got[b].append(lg[0, :vocab].float())
        for i in range(GEN - 1):
            routes.tag = (path, "step", i)
            lg, c = e.decode_step(served[:, i], lens + i, c,
                                  block_table=table)
            for b in range(SLOTS):
                got[b].append(lg[b, :vocab].float())
        logits[path] = got
    routes.tag = None
    n_moe = cfg.n_layers - cfg.moe.first_k_dense

    def differ(tag):
        """Per call under ``tag`` (a prefill pass a MoE layer, in order),
        the rows whose expert sets differ between the paths."""
        return [_differ(a, c) for a, c in
                zip(routes.take(("cuda", *tag)), routes.take(("torch",
                                                              *tag)))]

    diff_rows = [0] * n_moe
    rel, flipped, agree = [], [], {"cuda": 0, "torch": 0}
    first_flip, step_flip = [], []
    for b in range(SLOTS):
        d = differ(("prefill", b))
        for k, x in enumerate(d):
            diff_rows[k % n_moe] += int(x.sum())
        # the first logits row comes out of the last pass (the prompt,
        # or its final chunk), which is its own MoE group
        first_flip.append(any(bool(x.any()) for x in d[-n_moe:]))
    for i in range(GEN - 1):
        d = differ(("step", i))
        for j, x in enumerate(d):
            diff_rows[j] += int(x.sum())
        step_flip.append(any(bool(x.any()) for x in d))
    for i in range(GEN):
        for b in range(SLOTS):
            x, want = logits["cuda"][b][i], logits["torch"][b][i]
            rel.append(((x - want).abs().max() / want.abs().max()).item())
            flipped.append(first_flip[b] if i == 0 else step_flip[i - 1])
            for path in agree:
                agree[path] += int(logits[path][b][i].argmax()) == int(
                    served[b, i])
    what = (f"{SLOTS} requests replayed in the live slots" + (
        f" (prompts in chunks of {chunk})" if chunk else "")
        + ", kernel vs plain")
    summary = _hold_with_flips(what, rel, flipped)
    print(f"    served token picked by the replay at {agree['cuda']}/"
          f"{len(rel)} steps (plain replay: {agree['torch']}/{len(rel)}); "
          f"expert sets differing between the paths per MoE layer "
          f"{diff_rows}")
    return {**summary, "agree_served": agree, "expert_sets_differ":
            diff_rows}


def serve_deepseek(torch):
    """Phases 7-8 at full width: DeepSeek-V3 cut to 4 layers, bf16, random
    weights from a seed (conditioned), through ``generate`` (kernel 10),
    kernel 14 over generate's latent cache, the Scheduler with bf16
    (kernel 11) and int8 (kernel 13) latent pools, and the shared-prompt
    stream with the prefix cache and chunked prefill on both pools
    (kernels 12 and 15 on its prefix pages)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    cfg = get_config(DEEPSEEK)
    print(f"{DEEPSEEK}: full width (d {cfg.d_model}, {cfg.n_heads} heads, "
          f"MLA r {cfg.mla.kv_lora_rank} rope {cfg.mla.rope_head_dim}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab}, {cfg.dtype})")
    print(f"reduced: n_layers {cfg.n_layers} -> {DEEPSEEK_DEPTH}")
    cfg = cfg.replace(n_layers=DEEPSEEK_DEPTH)
    gen = 32
    ecfg = EngineConfig(batch=4, max_len=128 + gen, kernel_impl="cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    n_bytes = sum(t.numel() * t.element_size() for _, t in
                  leaves(eng.params))
    print(f"  {cfg.moe.first_k_dense} dense + "
          f"{cfg.n_layers - cfg.moe.first_k_dense} MoE layers, "
          f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.1f} GB "
          f"({time.perf_counter() - t0:.1f} s to init, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB)")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    with _Routes() as routes:
        gen_summary, cache = deepseek_generate(torch, eng, ref, routes,
                                               gen=gen)
        k14 = deepseek_kernel14(torch, cfg, cache, 128 + gen - 1)
        del cache, ref
        params = eng.params
        del eng
        torch.cuda.empty_cache()
        streams = [deepseek_scheduler(torch, params, cfg, kv, routes)
                   for kv in ("bf16", "int8")]
        pc_streams = [deepseek_scheduler(torch, params, cfg, kv, routes,
                                         prefix_chunked=True)
                      for kv in ("bf16", "int8")]
    del params
    torch.cuda.empty_cache()
    return {"arch": DEEPSEEK, "n_layers": DEEPSEEK_DEPTH,
            "n_params": n_params, "generate": gen_summary,
            "kernel14": k14, "scheduler": streams,
            "prefix_chunked": pc_streams}


# ----------------------------------------------------------------------
# phase 9: the paper's CNN path
# ----------------------------------------------------------------------

def serve_cnn(torch):
    """The CNN path at full width, through its user entry points: every
    stride-1 layer of the provet_cnn suite at its published shape, N 1
    and 32, bf16 and fp32, through ``ops.vwr_conv2d`` (bias + relu) and
    ``ops.vwr_depthwise``, and the section 6.1 demo on the card, with
    every launch counter set to 0 just before and read just after; then
    each output held against its plain version (shape, finite, TOL), and
    the fused bias + relu conv timed against the conv followed by the
    bias and the relu as separate passes."""
    from repro_torch.examples import provet_conv_demo
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.vwr_conv2d import vwr_conv2d_ref
    from repro_torch.kernels.vwr_depthwise import vwr_depthwise_ref

    covered, skipped = _cnn_layers()
    for layer in skipped:
        print(f"  {layer.name}: stride {layer.stride}, outside both "
              "kernels' stride-1 contract (as in JAX): not covered")
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = [(layer, n, dt, _conv_operands(
        torch, gen, n, layer.H_in, layer.W_in, layer.C_in, layer.C_out,
        layer.K, layer.K, dt, depthwise=layer.depthwise))
        for layer in covered for n in CNN_BATCHES
        for dt in (torch.bfloat16, torch.float32)]
    torch.cuda.synchronize()
    build.reset_launches()
    outs = [ops.vwr_depthwise(x, w) if layer.depthwise
            else ops.vwr_conv2d(x, w, b, activation="relu")
            for layer, _, _, (x, w, b) in cases]
    demo = provet_conv_demo.main("cuda")
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("vwr_conv2d",
                                               "vwr_depthwise")}
    n_dw = sum(layer.depthwise for layer, *_ in cases)
    # the demo's last section launches the conv kernel twice
    want = {"vwr_conv2d": len(cases) - n_dw + 2, "vwr_depthwise": n_dw}
    print(f"  launches over the suite and the demo: {launches}")
    if launches != want:
        raise AssertionError(f"CNN path launches {launches}, expected "
                             f"{want}")
    if max(demo["6.1_err"], demo["6.2.1_err"], demo["6.2.2_err"],
           demo["fused_err"]) > 1e-4:
        raise AssertionError(f"provet_conv_demo errors {demo}")
    rows = []
    for (layer, n, dt, (x, w, b)), out in zip(cases, outs):
        want_out = (vwr_depthwise_ref(x, w) if layer.depthwise
                    else vwr_conv2d_ref(x, w, b, activation="relu"))
        atol, rtol = TOL[str(dt)[6:]]
        d = (out.float() - want_out.float()).abs()
        ok = (out.shape == want_out.shape and bool(out.isfinite().all())
              and bool((d <= atol + rtol * want_out.float().abs()).all()))
        rows.append({"layer": layer.name, "N": n, "dtype": str(dt)[6:],
                     "shape": list(out.shape),
                     "max_abs_err": d.max().item()})
        print(f"  {layer.name:11s} N{n:<3d} {str(dt)[6:]:9s} out "
              f"{tuple(out.shape)} max|err| {d.max().item():.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{layer.name} N{n} {dt}: the CNN path's "
                                 "output is off its plain version")
    layer, n, dt, (x, w, b) = next(
        c for c in cases if (c[0].name, c[1], str(c[2])[6:])
        == CNN_HEADLINE["vwr_conv2d"])
    fused = time_ms(torch, lambda: ops.vwr_conv2d(x, w, b,
                                                  activation="relu"))
    unfused = time_ms(torch, lambda: torch.relu(ops.vwr_conv2d(x, w) + b))
    print(f"  {layer.name} N{n} bf16 conv + bias + relu: fused "
          f"{fused:.4f} ms, conv then bias and relu passes {unfused:.4f} ms")
    return {"launches": launches, "outputs": rows,
            "not_covered": [l.name for l in skipped],
            "fused_ms": fused, "unfused_ms": unfused,
            "demo_errors": {k: v for k, v in demo.items()
                            if k.endswith("_err")}}


# ----------------------------------------------------------------------

def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    OUT.mkdir(exist_ok=True)
    secs = build.timed_build(ptxas_verbose=True, log_dir=OUT)
    print(f"build: {secs:.1f} s ({', '.join(build.SOURCES)})")

    results = check_kernels(torch, F)

    print("end to end")
    per_step = {  # launches per layer: prefill, decode step
        "vwr_matmul": (5, 1), "vwr_swiglu": (1, 1),
        "vwr_attention": (1, 0), "vwr_flash_decode": (0, 1)}

    def expected(cfg_layers, gen):
        return {k: cfg_layers * (p + d * (gen - 1))
                for k, (p, d) in per_step.items()}

    fp32 = {n: serve_reduced_fp32(torch, n)
            for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
    tiny = serve(torch, "tinyllama-1.1b", 32, expected(22, 32),
                 kernel9=True)
    qwen = serve(torch, "qwen1.5-0.5b", 8, expected(24, 8))

    print("continuous batching")
    sched_fp32 = {n: scheduler_reduced_fp32(torch, n)
                  for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
    sched_bf16, params = serve_scheduler(torch, "bf16")
    sched_int8, _ = serve_scheduler(torch, "int8", params=params)

    print("prefix cache and chunked prefill")
    pc_fp32 = {n: scheduler_reduced_prefix_chunked(torch, n)
               for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
    rows = chunk_rows(torch, params)
    chunk_logits = chunked_prefill_logits(torch, params)
    pc_streams = serve_prefix_chunked(torch, params)
    del params
    torch.cuda.empty_cache()

    print("the moe family: DeepSeek-V3 (MLA) and OLMoE (GQA)")
    moe_fp32 = {n: serve_reduced_fp32(torch, n)
                for n in (DEEPSEEK, "olmoe-1b-7b")}
    moe_sched_fp32 = {n: scheduler_reduced_fp32(torch, n)
                      for n in (DEEPSEEK, "olmoe-1b-7b")}
    print("prefix cache and chunked prefill of the MLA and moe families")
    mla_pc_fp32 = {n: scheduler_reduced_prefix_chunked(torch, n)
                   for n in (DEEPSEEK, "olmoe-1b-7b")}
    dense_mla = _dense_mla()
    mla_pc_fp32[dense_mla.name] = scheduler_reduced_prefix_chunked(
        torch, None, cfg=dense_mla)
    deepseek = serve_deepseek(torch)
    pc = deepseek["prefix_chunked"]

    print("the paper's CNN path: provet_cnn suite on kernels 16 and 17")
    cnn = serve_cnn(torch)
    launches = {**tiny["launches"],
                "vwr_paged_flash_decode":
                    sched_bf16["launches"]["vwr_paged_flash_decode"],
                "vwr_paged_flash_decode_q8":
                    sched_int8["launches"]["vwr_paged_flash_decode_q8"],
                **rows["launches"],
                "vwr_mla_flash_decode":
                    deepseek["generate"]["launches"]["vwr_mla_flash_decode"],
                "vwr_mla_paged_flash_decode": deepseek["scheduler"][0][
                    "launches"]["vwr_mla_paged_flash_decode"],
                "vwr_mla_paged_flash_decode_q8": deepseek["scheduler"][1][
                    "launches"]["vwr_mla_paged_flash_decode_q8"],
                "vwr_mla_flash_decode_q8": deepseek["kernel14"]["launches"],
                "vwr_flash_decode_q8": tiny["kernel9"]["launches"],
                "vwr_mla_chunk_prefix_attend":
                    pc[0]["chunk_prefix"]["launches"],
                "vwr_mla_chunk_prefix_attend_q8":
                    pc[1]["chunk_prefix"]["launches"],
                **cnn["launches"]}

    kernels = []
    sources = {"vwr_matmul": "vwr_matmul", "vwr_swiglu": "vwr_matmul",
               "vwr_attention": "vwr_attention",
               "vwr_flash_decode": "vwr_decode",
               "vwr_paged_flash_decode": "vwr_paged_decode",
               "vwr_paged_flash_decode_q8": "vwr_paged_decode",
               "vwr_chunk_prefix_attend": "vwr_chunk_prefix",
               "vwr_chunk_prefix_attend_q8": "vwr_chunk_prefix",
               "vwr_mla_flash_decode": "vwr_mla_decode",
               "vwr_mla_paged_flash_decode": "vwr_mla_decode",
               "vwr_mla_paged_flash_decode_q8": "vwr_mla_decode",
               "vwr_mla_flash_decode_q8": "vwr_mla_decode",
               "vwr_flash_decode_q8": "vwr_decode",
               "vwr_mla_chunk_prefix_attend": "vwr_mla_decode",
               "vwr_mla_chunk_prefix_attend_q8": "vwr_mla_decode",
               "vwr_conv2d": "vwr_conv2d", "vwr_depthwise": "vwr_depthwise"}
    replaces = {
        "vwr_matmul": "src/repro/kernels/vwr_matmul.py:120",
        "vwr_swiglu": "src/repro/kernels/vwr_matmul.py:84",
        "vwr_attention": "src/repro/kernels/vwr_attention.py:81",
        "vwr_flash_decode": "src/repro/kernels/vwr_decode.py:1222",
        "vwr_paged_flash_decode": "src/repro/kernels/vwr_decode.py:327",
        "vwr_paged_flash_decode_q8": "src/repro/kernels/vwr_decode.py:542",
        "vwr_chunk_prefix_attend": "src/repro/kernels/vwr_decode.py:870",
        "vwr_chunk_prefix_attend_q8": "src/repro/kernels/vwr_decode.py:967",
        "vwr_mla_flash_decode": "src/repro/kernels/vwr_decode.py:164",
        "vwr_mla_paged_flash_decode": "src/repro/kernels/vwr_decode.py:265",
        "vwr_mla_paged_flash_decode_q8":
            "src/repro/kernels/vwr_decode.py:747",
        "vwr_mla_flash_decode_q8": "src/repro/kernels/vwr_decode.py:649",
        "vwr_flash_decode_q8": "src/repro/kernels/vwr_decode.py:451",
        "vwr_mla_chunk_prefix_attend":
            "src/repro/kernels/vwr_decode.py:1064",
        "vwr_mla_chunk_prefix_attend_q8":
            "src/repro/kernels/vwr_decode.py:1162",
        "vwr_conv2d": "src/repro/kernels/vwr_conv2d.py:57",
        "vwr_depthwise": "src/repro/kernels/vwr_depthwise.py:35"}
    for name in sources:
        head = next(r for r in results if r["kernel"] == name
                    and r["headline"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"]})
    detail = {"card": card, "torch": torch.__version__,
              "build_s": secs, "kernel_cases": results,
              "reduced_fp32_max_abs": fp32, "serve": [tiny, qwen],
              "scheduler": [sched_bf16, sched_int8],
              "scheduler_reduced_fp32": sched_fp32,
              "prefix_chunked_reduced_fp32": pc_fp32,
              "chunk_rows": rows, "chunked_prefill_logits": chunk_logits,
              "prefix_chunked": pc_streams,
              "moe_reduced_fp32_max_abs": moe_fp32,
              "moe_scheduler_reduced_fp32": moe_sched_fp32,
              "mla_moe_prefix_chunked_reduced_fp32": mla_pc_fp32,
              "deepseek": deepseek, "cnn": cnn,
              "wall_s": time.perf_counter() - t_start}
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"wall {detail['wall_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
