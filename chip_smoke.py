#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, the exit is non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/csrc`` (into ``build/repro_torch``);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus ragged edges, bias, G = 1, bf16 and fp32) and
   time kernel, plain version and one PyTorch library call;
3. serve tinyllama-1.1b at full width (22 layers, d 2048, vocab 32000,
   bf16, random weights from a seed) through ``DecodeEngine.generate``
   on the kernels (after one warm-up generate), with every launch counter
   set to 0 just before the timed generate and read just after; then replay the same token stream teacher-forced
   through the plain 'torch' backend and hold each step's logits to it
   (the random weights are rescaled to a well-conditioned model first);
   the same for reduced fp32 configs, at a tight tolerance;
4. the same for qwen1.5-0.5b at full width (QKV bias, MHA, tied vocab);
5. print ``{"kernels": [...]}``, then the last line
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
    return results


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
            lc, cc = eng.decode_step(tok, P + i, cc)
            lr, cr = ref.decode_step(tok, P + i, cr)
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

    kernels = []
    sources = {"vwr_matmul": "vwr_matmul", "vwr_swiglu": "vwr_matmul",
               "vwr_attention": "vwr_attention",
               "vwr_flash_decode": "vwr_decode"}
    replaces = {
        "vwr_matmul": "src/repro/kernels/vwr_matmul.py:120",
        "vwr_swiglu": "src/repro/kernels/vwr_matmul.py:84",
        "vwr_attention": "src/repro/kernels/vwr_attention.py:81",
        "vwr_flash_decode": "src/repro/kernels/vwr_decode.py:1222"}
    for name in per_step:
        head = next(r for r in results if r["kernel"] == name
                    and r["headline"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name],
            "launches": tiny["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"]})
    detail = {"card": card, "torch": torch.__version__,
              "build_s": secs, "kernel_cases": results,
              "reduced_fp32_max_abs": fp32, "serve": [tiny, qwen],
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
