"""Serving driver: prefill a batch of prompts, decode with a KV cache.

Counterpart of ``repro.launch.serve``: a thin CLI over
``repro_torch.engine.DecodeEngine``, with the same flags plus
``--device``.  ``--kernel-impl`` picks the dispatch-registry backend per
op: ``cuda`` (the default, the hand-written Hopper kernels), ``torch``
(plain PyTorch) or ``auto`` (per op and shape, the backend the
autotuner's cache measured faster).  The run is on the card unless
``--device cpu`` is given.

Sharded serving: ``--data-model D M`` with D * M > 1 spawns a world of
D * M ranks itself (``launch.mesh.run_ranks``; the kernels are built
once, in this process, before it), one engine a rank: the dense cache's
batch split over 'data' and, with ``--shard seq``, the KV cache
sequence-sharded over 'model' (distributed FlashDecoding,
``dist.decode``), the weights whole on every rank; without it
tensor-parallel, each rank its blocks of the weights over 'model' (and
of the experts over every axis) and its kv heads of the cache.  Ranks
sharing one GPU talk over ``gloo`` (through the host), ranks with a GPU
each over ``nccl`` (``launch.mesh.transport``).  Rank 0 prints the same
lines as ``--data-model 1 1``.  Durable serving (``--snapshot-dir``)
under a mesh is not ported (ROADMAP queue 1 item 14).

On the card (a ~100M-class shrink of the model, batched requests):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen1.5-0.5b --reduce width --batch 4 --prompt-len 64 \\
        --gen 32
On the CPU (the reduced config, the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --reduce smoke --device cpu --stream 8
Sequence-sharded over two ranks on one card:
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --data-model 1 2 --shard seq
Tensor-parallel over two ranks on one card (half the weights a rank):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --data-model 1 2
"""
from __future__ import annotations

import argparse
import contextlib
import io

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.engine import DecodeEngine, EngineConfig
from repro_torch.engine.engine import ITEM_14
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train import width_reduce


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", choices=["smoke", "width"], default="width")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--data-model", type=int, nargs=2, default=(1, 1),
                    help="mesh shape (data, model): D * M ranks, spawned "
                         "by this command")
    ap.add_argument("--shard", choices=["none", "seq"], default="none",
                    help="'seq' = sequence-shard the KV cache over "
                         "'model' (distributed FlashDecoding)")
    ap.add_argument("--kernel-impl", choices=list(dispatch.BACKENDS),
                    default="cuda")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: page pool + per-slot block "
                         "tables instead of the dense (B, max_len) "
                         "cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="positions per page (with --paged)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size; default sizes a full "
                         "dense-equivalent batch")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8"],
                    default="bf16",
                    help="page-pool storage dtype (with --paged): "
                         "'int8' quantizes pages with fp32 per-page "
                         "scale sidecars, dequantized in-kernel")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="request-stream mode: continuously batch N "
                         "staggered requests of varying lengths "
                         "through the scheduler (implies --paged; "
                         "--batch is the slot count)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="with --stream: chunked prefill + unified "
                         "mixed prefill/decode steps — each step packs "
                         "decode slots plus up to --chunk-tokens of the "
                         "head prompt under a token budget")
    ap.add_argument("--chunk-tokens", type=int, default=32,
                    help="prompt tokens per mixed-step chunk (with "
                         "--chunked-prefill); must be a multiple of "
                         "--page-size")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="with --stream: prefix-sharing radix cache "
                         "over the page pool — admission aliases the "
                         "longest cached whole-page prefix and prefills "
                         "only the suffix; half the stream's prompts "
                         "share a common system prefix")
    ap.add_argument("--inject", action="store_true",
                    help="with --stream: run a deterministic chaos "
                         "schedule (engine.faults) through the stream "
                         "— NaN logits, a transient step exception, "
                         "pool pressure and a slow step — and report "
                         "the lifecycle counters (the stream must "
                         "still complete)")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for the injected chaos schedule")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="with --stream: touch PATH each decode step "
                         "(runtime.resilience.Heartbeat) so an "
                         "external supervisor can detect a hang")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="with --stream: durable serving — every "
                         "request event write-ahead journaled and the "
                         "full serving state snapshotted under DIR, "
                         "the drain supervised by runtime.resilience."
                         "serve_with_recovery (a crash resumes from the "
                         "latest snapshot + journal replay)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    metavar="N",
                    help="with --snapshot-dir: snapshot the serving "
                         "state every N steps (written async, off the "
                         "step path); 0 = journal-only durability")
    ap.add_argument("--crash-at", type=int, default=0, metavar="K",
                    help="with --snapshot-dir: inject engine.faults."
                         "CrashFault at step K of the first attempt — "
                         "deterministic simulated process death the "
                         "restart loop must recover from")
    return ap


def engine_config_from_args(args, cfg=None) -> EngineConfig:
    """CLI namespace -> EngineConfig (the mapping tests pin).

    ``cfg`` (when given) corrects the cache budget for families whose
    prefill occupies more positions than --prompt-len: the vlm frontend
    prefix counts against max_len too."""
    extra = (cfg.frontend_tokens
             if cfg is not None and cfg.family == "vlm" else 0)
    return EngineConfig(
        batch=args.batch,
        max_len=args.prompt_len + extra + args.gen,
        mesh_shape=tuple(args.data_model),
        decode_shard=args.shard,
        kernel_impl=args.kernel_impl,
        paged=bool(args.paged or args.stream),
        page_size=args.page_size,
        n_pages=args.n_pages,
        kv_dtype=args.kv_dtype,
        prefix_cache=args.prefix_cache,
        chunked_prefill=args.chunked_prefill,
        chunk_tokens=args.chunk_tokens,
    )


def _stream_requests(engine, args):
    """The stream workload both modes share: n requests of varying
    prompt/gen lengths, half of them opening with a common whole-page
    "system prompt" when --prefix-cache is on.  Deterministic in the
    args (seeded rng): the JAX package's requests, value for value."""
    from repro_torch.engine import Request

    cfg = engine.cfg
    rng = np.random.default_rng(0)
    n, P, G = args.stream, args.prompt_len, args.gen
    shared = None
    if args.prefix_cache:
        sys_pages = max(1, (P // 2) // engine.page_size)
        shared = rng.integers(
            2, cfg.vocab, (sys_pages * engine.page_size,)
        ).astype(np.int32)

    def _prompt(i):
        body = rng.integers(
            2, cfg.vocab,
            (int(rng.integers(max(P // 2, 1), P + 1)),)).astype(np.int32)
        if shared is not None and i % 2 == 0:
            return np.concatenate([shared, body])[:P].astype(np.int32)
        return body

    return [Request(rid=i, tokens=_prompt(i),
                    gen=int(rng.integers(max(G // 2, 1), G + 1)),
                    temperature=args.temperature, seed=i)
            for i in range(n)]


def _serve_durable(engine, args):
    """Durable request-stream mode (--snapshot-dir): the whole stream
    submitted up front into a journaled, snapshot-cadenced scheduler
    drained under ``serve_with_recovery``.  With --crash-at K the first
    attempt dies deterministically at step K (CrashFault); the restart
    loop restores the latest snapshot, replays the journal and finishes
    the stream — results the crashed process already produced are
    recovered verbatim, never recomputed."""
    import time

    from repro_torch.engine import faults
    from repro_torch.runtime.resilience import (RestartPolicy,
                                                serve_with_recovery)

    n = args.stream
    reqs = _stream_requests(engine, args)
    attempts = []

    def on_start(sched, fresh):
        attempts.append(fresh)
        if fresh and args.crash_at:
            faults.inject(sched, decode_faults=[
                faults.CrashFault(step=args.crash_at)])

    def submit(sched):
        for r in reqs:
            sched.submit(r)

    t0 = time.time()
    sched = serve_with_recovery(
        engine, args.snapshot_dir, submit,
        snapshot_every=args.snapshot_every,
        policy=RestartPolicy(max_restarts=5, backoff_s=0.0),
        on_start=on_start)
    dt = time.time() - t0
    assert len(sched.finished) == n, "durable stream lost results"

    st = sched.stats
    toks = sum(len(v) for v in sched.finished.values())
    print(f"[serve] {engine.cfg.name} durable stream: {n} requests, "
          f"{toks} tokens in {dt:.2f}s; attempts "
          f"{len(attempts)} (crash-at {args.crash_at or '-'}), "
          f"snapshots {sched.snapshotter.saved} "
          f"(every {args.snapshot_every or '-'} steps), journal "
          f"{sched.journal.appended} events appended this process")
    print(f"[serve] lifecycle: finished "
          f"{sum(1 for v in sched.finished.values() if v.ok)}, "
          f"failed {st['failed']}, cancelled {st['cancelled']}, "
          f"timed_out {st['timed_out']}, rejected {st['rejected']}; "
          f"steps {st['steps']} (post-recovery process)")
    for i in range(min(n, 3)):
        res = sched.finished[i]
        print(f"    req {i} ({len(reqs[i].tokens)} prompt -> "
              f"{reqs[i].gen} gen, {res.status.value}):", res[:12])
    return sched.finished


def _serve_stream(engine, args):
    """Request-stream mode: N staggered requests of varying prompt/gen
    lengths continuously batched through ``engine.Scheduler`` — short
    requests retire and free pages mid-stream while long ones keep
    decoding, and freed slots admit pending requests without touching
    (or re-prefilling) the survivors.

    With ``--inject`` a deterministic chaos schedule rides along (NaN
    logits in one slot, a transient decode exception, a slow step, and
    artificial page-pool pressure plus one mid-flight cancel): the
    stream must still complete, with only the poisoned request FAILED
    and every fault accounted for in the lifecycle counters."""
    import time

    from repro_torch.engine import Scheduler
    from repro_torch.runtime.resilience import Heartbeat, StragglerMonitor

    cfg = engine.cfg
    n = args.stream
    straggler = StragglerMonitor(window=32, threshold=4.0, warmup=3)
    heartbeat = (Heartbeat(args.heartbeat, interval_s=0.0)
                 if args.heartbeat else None)
    sched = Scheduler(engine, straggler=straggler, heartbeat=heartbeat)
    release = None
    if args.inject:
        from repro_torch.engine import faults
        s0 = args.inject_seed
        plan = [faults.NonFiniteLogits(step=3 + s0 % 3, slot=0),
                faults.TransientError(step=6 + s0 % 3),
                faults.SlowStep(step=9 + s0 % 3, delay_s=0.05)]
        faults.inject(sched, decode_faults=plan)
        release = faults.hold_pages(sched, max(1, engine.n_pages // 8))
    # varying lengths: prompts in [P/2, P], gens in [G/2, G].  With
    # --prefix-cache, half the stream shares a common "system prompt"
    # prefix (a whole number of pages) so the radix cache actually hits.
    reqs = _stream_requests(engine, args)
    # staggered arrival: one new request every 2 decode steps
    t0 = time.time()
    arrivals = {i: 2 * i for i in range(n)}
    step = 0
    while len(sched.finished) < n:
        for i, at in arrivals.items():
            if at <= step:
                sched.submit(reqs[i])
        arrivals = {i: a for i, a in arrivals.items() if a > step}
        if args.inject and step == 5 and n > 1:
            sched.cancel(1)  # arrived at step 2 — a mid-flight cancel
        if release is not None and step == 8:
            release()
            release = None
        sched.admit()
        if sched.n_active:
            sched.step()
        step += 1
        if not sched.n_active and not sched.pending and not arrivals:
            # everything terminal (parked requests drain via run())
            sched.run()
    if release is not None:
        release()
    dt = time.time() - t0
    toks = sum(len(v) for v in sched.finished.values())
    print(f"[serve] {cfg.name} request-stream: {n} requests, "
          f"{sched.stats['steps']} decode steps, {toks} tokens in "
          f"{dt:.2f}s; peak pages {sched.stats['peak_pages']}/"
          f"{engine.n_pages} (page_size {engine.page_size}); "
          f"prefills {sched.stats['prefills']} (one per request — "
          "survivors never re-prefill)")
    st = sched.stats
    lat = sched.latency_percentiles()
    print(f"[serve] lifecycle: finished "
          f"{sum(1 for v in sched.finished.values() if v.ok)}, "
          f"failed {st['failed']}, cancelled {st['cancelled']}, "
          f"timed_out {st['timed_out']}, rejected {st['rejected']}; "
          f"retries: step {st['step_retries']} / prefill "
          f"{st['prefill_retries']}; preempted {st['preempted']}, "
          f"parked {st['parked']}, straggler flags "
          f"{st['straggler_flags']}")
    if lat:
        print(f"[serve] request latency: p50 {lat['p50']:.3f}s "
              f"p90 {lat['p90']:.3f}s p99 {lat['p99']:.3f}s")
    itl = sched.itl_percentiles()
    if itl:
        print(f"[serve] inter-token latency: p50 {itl['p50']*1e3:.1f}ms "
              f"p90 {itl['p90']*1e3:.1f}ms p99 {itl['p99']*1e3:.1f}ms")
    if sched.chunked:
        print(f"[serve] chunked prefill: {st['chunks']} chunks / "
              f"{st['chunked_tokens']} prompt tokens over "
              f"{st['mixed_steps']} mixed steps (chunk_tokens "
              f"{sched.chunk_tokens}, token budget "
              f"{sched.token_budget})")
    if sched.prefix is not None:
        print(f"[serve] prefix cache: hits {st['prefix_hits']} / "
              f"misses {st['prefix_misses']}, "
              f"{st['prefix_hit_tokens']} prompt tokens served from "
              f"cache; evictions {st['prefix_evictions']}, peak shared "
              f"pages {st['shared_pages']}, cow forks "
              f"{st['cow_forks']}; {sched.prefix.cached_pages} pages "
              "still cached")
    if args.inject:
        bad = {i: v for i, v in sched.finished.items() if not v.ok}
        for i, v in sorted(bad.items()):
            print(f"    req {i} {v.status.value}: {v.error}")
        assert len(sched.finished) == n, "injected stream lost results"
    for i in range(min(n, 3)):
        res = sched.finished[i]
        print(f"    req {i} ({len(reqs[i].tokens)} prompt -> "
              f"{reqs[i].gen} gen, {res.status.value}):", res[:12])
    return sched.finished


def main(argv=None):
    args = build_parser().parse_args(argv)
    data, model = args.data_model
    if data * model == 1:
        return _serve(args)
    if args.snapshot_dir:
        raise NotImplementedError(
            "durable serving (--snapshot-dir) under a mesh is not ported "
            f"to repro_torch yet: {ITEM_14}")
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    return run_ranks(_serve_rank, data, model, args=(args,),
                     device=args.device)


def _serve_rank(mesh, args):
    """One rank of a sharded run: rank 0 prints, and its results come
    back to the parent on the host."""
    rank0 = mesh.coord("data") == 0 and mesh.coord("model") == 0
    with (contextlib.nullcontext() if rank0
          else contextlib.redirect_stdout(io.StringIO())):
        out = _serve(args, mesh)
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return out.cpu()


def _serve(args, mesh=None):
    cfg = get_config(args.arch)
    cfg = reduced(cfg) if args.reduce == "smoke" else width_reduce(cfg)
    if cfg.mamba2 is not None or cfg.xlstm is not None:
        chunk = (cfg.mamba2 or cfg.xlstm).chunk
        assert args.prompt_len % chunk == 0

    engine = DecodeEngine(cfg, engine_config_from_args(args, cfg),
                          device=args.device, mesh=mesh)
    cfg = engine.cfg

    if args.stream:
        if args.snapshot_dir:
            return _serve_durable(engine, args)
        return _serve_stream(engine, args)

    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab, (B, P)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["frontend_emb"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frontend_emb"] = rng.standard_normal(
            (B, P, cfg.frontend_dim)).astype(np.float32)

    gen, stats = engine.generate(batch, G, temperature=args.temperature)

    print(f"[serve] {cfg.name}: prefill {B}x{P} in "
          f"{stats['t_prefill_s']:.2f}s ({stats['prefill_tok_s']:.0f} "
          f"tok/s); decode {G-1} steps in {stats['t_decode_s']:.2f}s "
          f"({stats['decode_tok_s']:.0f} tok/s)")
    print("[serve] sample generations (token ids):")
    for b in range(min(B, 2)):
        print("   ", gen[b].cpu().numpy()[:16])
    return gen


if __name__ == "__main__":
    main()
