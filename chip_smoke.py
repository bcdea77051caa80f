#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, the exit is non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/csrc`` (into ``build/repro_torch``);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus ragged edges, bias, G = 1, bf16 and fp32;
   for the paged kernels permuted block tables, slots of length 0, 1,
   16, 17 and 255, int8 pools with random scales) and time kernel, plain
   version and one PyTorch library call;
3. serve tinyllama-1.1b at full width (22 layers, d 2048, vocab 32000,
   bf16, random weights from a seed) through ``DecodeEngine.generate``
   on the kernels (after one warm-up generate), with every launch counter
   set to 0 just before the timed generate and read just after; then replay the same token stream teacher-forced
   through the plain 'torch' backend and hold each step's logits to it
   (the random weights are rescaled to a well-conditioned model first);
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
6. print ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

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
               flops, nbytes, headline=False):
        ms = time_ms(torch, fn)
        row = {"kernel": kernel, "case": label, "shape": shape,
               "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": time_ms(torch, plain),
               "library_ms": (None if library is None
                              else time_ms(torch, library)),
               "bound_ms": bound_ms(flops, nbytes, str(dtype)[6:]),
               "bound_by": ("operations" if flops / PEAK_FLOPS[str(dtype)[6:]]
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
    return results


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

def serve(torch, name, gen, expected_launches):
    """Full-width generate on the kernels (launches counted), then the
    same token stream teacher-forced through the plain backend."""
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
    rel = _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                          check_greedy=True)
    worst = max(rel)
    print(f"  teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{worst:.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g})")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"{name}: logits diverge from the plain path")
    del eng, ref
    torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt": P, "gen": gen,
            "n_params": n_params, "launches": launches,
            "logits_rel_err": rel, **stats}


def _condition(torch, params):
    """Rescale random weights to a well-conditioned model, in place.

    The JAX package's fan-in init (mirrored by ``init_params``) takes
    ``shape[-2]`` as the fan-in, which for ``wq``/``wk``/``wv``
    ``(d, H, Dh)`` is the head count: q and k come out with stds of
    ~8-20, attention is close to a hard argmax and the residual stream
    grows layer by layer, so 1-ulp bf16 differences flip attention
    choices and no two rounding orders agree after 22 layers.  Every
    projection is rescaled to std 0.02 (HF Llama's initializer_range)
    and the QKV biases drawn at std 0.02, so the fused bias is not a
    sum of zeros."""
    from repro_torch.common.module import leaves

    g = torch.Generator(device="cuda").manual_seed(3)
    for path, t in leaves(params):
        if path[-1] in ("wq", "wk", "wv", "wo", "wi", "wg", "w"):
            t.mul_(0.02 / t.float().std())
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
    past ``atol`` times the logits' scale (max|ref|, at least 1)."""
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
    return out


def serve_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: kernel path against the plain
    path at the Pallas-vs-XLA tolerance, greedy streams identical."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import DecodeEngine, EngineConfig

    # the kernels take D in {32, 64, 128}: widen the reduced head dim
    cfg = reduced(get_config(name)).replace(d_head=32)
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
    err = _teacher_forced(torch, eng, ref, prompts, tok_c, 31, 9,
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
            "vwr_matmul": L * (5 * st["prefills"] + st["steps"])}
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

    rel, agree = _replay_slots(torch, eng, sched.cache, reqs, out,
                               kv_dtype)
    summary.update(logits_rel_err=rel, replay_agree=agree,
                   n_params=sum(t.numel() for _, t in leaves(eng.params)))
    params = eng.params
    del eng, sched
    torch.cuda.empty_cache()
    return summary, params


def _replay_slots(torch, eng, cache, reqs, out, kv_dtype):
    """Teacher-force finished requests through the serving engine's
    slots, all of them live in one decode batch, on the drained stream's
    pools (stale pages and int8 scales included), and hold each
    request's logits at every step against a batch-1 plain engine: dense
    for model-dtype pools, paged int8 for int8 pools, which reads the
    same quantized pages.  A wrong table or counts row, a write into
    another slot's page or a stale scale shows here.  Returns the
    per-step relative errors and the steps whose greedy pick equals the
    served token, which must be at least REPLAY_AGREE of them."""
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
    rel, agree = [], 0
    for b, (r, _) in enumerate(picked):
        P = len(r.tokens)
        lr, cr = ref.prefill({"tokens": torch.from_numpy(r.tokens)[None]
                              .cuda()})
        for i in range(GEN):
            want = lr[0, :vocab]
            rel.append(((got[b][i] - want).abs().max()
                        / want.abs().max()).item())
            agree += int(got[b][i].argmax()) == int(served[b, i])
            if i + 1 < GEN:
                lr, cr = _decode(ref, served[b, i:i + 1], P + i, cr)
    worst = max(rel)
    print(f"  {len(picked)} requests replayed in {SLOTS} live slots, "
          f"teacher-forced: logits vs the plain "
          f"{'dense' if kv_dtype == 'bf16' else 'paged int8'} path max "
          f"|d|/max|ref| {worst:.3e} over {len(rel)} steps (limit "
          f"{E2E_BF16_REL:g}); greedy == served token at "
          f"{agree}/{len(rel)} steps (floor {REPLAY_AGREE:g})")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"scheduler {kv_dtype}: logits diverge from "
                             "the plain path")
    if agree < REPLAY_AGREE * len(rel):
        raise AssertionError(f"scheduler {kv_dtype}: the replay picks the "
                             f"served token at only {agree}/{len(rel)} "
                             "steps")
    del ref
    return rel, agree


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


def scheduler_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: the Scheduler's greedy streams
    on the kernels equal the plain backend's, for both pool dtypes,
    over a stream that preempts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler

    cfg = reduced(get_config(name)).replace(d_head=32)
    streams = {}
    for kv_dtype in ("bf16", "int8"):
        ecfg = EngineConfig(batch=3, max_len=64, paged=True, page_size=8,
                            n_pages=12, kv_dtype=kv_dtype,
                            kernel_impl="cuda")
        eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=eng.params, device="cuda")
        for e in (eng, ref):
            sched = Scheduler(e)
            out = _drive(sched, _requests(cfg, 7, (5, 40), 16, seed=6))
            streams[kv_dtype, e.cfg.kernel_impl] = (
                [out[i].tokens.tolist() for i in range(7)],
                sched.stats["preempted"])
        if streams[kv_dtype, "cuda"] != streams[kv_dtype, "torch"]:
            raise AssertionError(f"{name} reduced fp32 {kv_dtype}: "
                                 "Scheduler streams differ")
        print(f"  {cfg.name} fp32 Scheduler, {kv_dtype} pools: greedy "
              f"streams identical ({streams[kv_dtype, 'cuda'][1]} "
              "preemptions)")
    return {k: v[1] for k, v in streams.items() if k[1] == "cuda"}


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
    tiny = serve(torch, "tinyllama-1.1b", 32, expected(22, 32))
    qwen = serve(torch, "qwen1.5-0.5b", 8, expected(24, 8))

    print("continuous batching")
    sched_fp32 = {n: scheduler_reduced_fp32(torch, n)
                  for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
    sched_bf16, params = serve_scheduler(torch, "bf16")
    sched_int8, _ = serve_scheduler(torch, "int8", params=params)
    del params
    launches = {**tiny["launches"],
                "vwr_paged_flash_decode":
                    sched_bf16["launches"]["vwr_paged_flash_decode"],
                "vwr_paged_flash_decode_q8":
                    sched_int8["launches"]["vwr_paged_flash_decode_q8"]}

    kernels = []
    sources = {"vwr_matmul": "vwr_matmul", "vwr_swiglu": "vwr_matmul",
               "vwr_attention": "vwr_attention",
               "vwr_flash_decode": "vwr_decode",
               "vwr_paged_flash_decode": "vwr_paged_decode",
               "vwr_paged_flash_decode_q8": "vwr_paged_decode"}
    replaces = {
        "vwr_matmul": "src/repro/kernels/vwr_matmul.py:120",
        "vwr_swiglu": "src/repro/kernels/vwr_matmul.py:84",
        "vwr_attention": "src/repro/kernels/vwr_attention.py:81",
        "vwr_flash_decode": "src/repro/kernels/vwr_decode.py:1222",
        "vwr_paged_flash_decode": "src/repro/kernels/vwr_decode.py:327",
        "vwr_paged_flash_decode_q8": "src/repro/kernels/vwr_decode.py:542"}
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
              "scheduler_reduced_fp32_preemptions": {
                  n: {k[0]: v for k, v in d.items()}
                  for n, d in sched_fp32.items()},
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
