"""Serving example: batch decode and continuous batching through the
DecodeEngine.

Counterpart of ``examples/serve_batch.py``, with the same flags and the
same assertions, on the card unless ``--device cpu`` is given (the
kernels' plain versions); with no GPU the default raises rather than
fall back.  The engines run the port's default backend ('cuda').

    PYTHONPATH=src python -m repro_torch.examples.serve_batch   # batch decode
    ... serve_batch --stream              # continuous batching
    ... serve_batch --stream --inject     # + chaos leg: injected NaN /
                                          # transient fault / pool
                                          # pressure; survivors must be
                                          # bit-identical
    ... serve_batch --stream --prefix-cache
                                          # + radix prefix cache leg:
                                          # shared system prompt, hit
                                          # rate > 0, streams identical
                                          # to the cache-off scheduler
                                          # (add --inject for the chaos
                                          # + no-leak pass)
    ... serve_batch --stream --chunked-prefill
                                          # + mixed-traffic leg: one long
                                          # prompt chunk-prefills INSIDE
                                          # the decode steps of short
                                          # requests, no decoding slot
                                          # ever stalls (add --inject
                                          # for the mid-chunk transient
                                          # fault retry pass)
    ... serve_batch --stream --arrival-rate 0.7
                                          # seeded Poisson arrivals
                                          # (requests per decode step)
    ... serve_batch --stream --crash-at 6 --snapshot-every 2
                                          # + crash-recovery leg: killed
                                          # at step 6, restored from the
                                          # latest snapshot + journal
                                          # replay, bit-identical to the
                                          # crash-free run
    ... serve_batch --stream --model deepseek-v3-671b
                                          # any paged-family text arch
                                          # (dense / vlm / moe), e.g.
                                          # the MLA config

Like the JAX demos, the mixed and prefix legs hold a chunked or cached
stream bit-identical to the plain scheduler's: on the CPU both paths
are the same plain math, on the card they run different kernels (kernel
6 against kernel 3), whose fp32 sums can part at a near-tie.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.engine import (DecodeEngine, EngineConfig, Request,
                                RequestStatus, Scheduler)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--inject", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--arrival-rate", type=float, default=None)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--snapshot-every", type=int, default=2)
    ap.add_argument("--model", default="qwen1.5-0.5b")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def _engine(args, **kw):
    cfg = reduced(get_config(args.model))
    ekw = dict(batch=2, max_len=48, paged=True, page_size=8,
               kv_dtype=args.kv_dtype)
    ekw.update(kw)
    return cfg, DecodeEngine(cfg, EngineConfig(**ekw), device=args.device)


def stream_demo(args):
    """Continuous batching on the paged engine: staggered request
    arrival and retirement over 2 slots and a shared page pool —
    request 2 is only admitted once a short request retires and frees
    its slot + pages, and the surviving request keeps decoding without
    being re-prefilled.  Decode steps run with bucketed block tables."""
    cfg, engine = _engine(args)
    sched = Scheduler(engine)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=f"req{i}", tokens=rng.integers(
                2, cfg.vocab, (p,)).astype(np.int32), gen=g)
            for i, (p, g) in enumerate([(24, 4), (16, 12), (8, 6)])]

    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.admit()                           # both slots fill
    assert sched.n_active == 2
    while "req0" not in sched.finished:     # short request retires first
        sched.step()
    sched.submit(reqs[2])                   # late arrival...
    sched.admit()                           # ...takes the freed slot
    assert sched.n_active == 2
    out = sched.run()
    assert set(out) == {"req0", "req1", "req2"}
    assert all(len(out[r.rid]) == r.gen for r in reqs)
    # one prefill per request: survivors were never re-prefilled when
    # slots turned over around them
    assert sched.stats["prefills"] == 3
    widths = dict(sorted(sched.stats["table_widths"].items()))
    print(f"[stream] {cfg.name}: 3 staggered requests over 2 slots, "
          f"{sched.stats['steps']} steps, peak pages "
          f"{sched.stats['peak_pages']}/{engine.n_pages}, table-width "
          f"buckets {widths} (max_pages {engine.max_pages})")
    for r in reqs:
        print(f"    {r.rid}: {len(r.tokens)} prompt -> {out[r.rid]}")
    print("stream example OK")


def inject_demo(args):
    """Chaos leg: the same staggered stream with a NaN-poisoned slot, a
    transient decode exception and artificial page-pool pressure
    injected (``engine.faults``).  Only the poisoned request ends FAILED
    (keeping its pre-fault token prefix), the transient fault heals
    through one bounded retry, and every surviving stream is
    bit-identical to the fault-free run."""
    from repro_torch.engine import faults

    cfg, engine = _engine(args)
    rng = np.random.default_rng(0)
    specs = [(24, 4), (16, 12), (8, 6)]
    prompts = [rng.integers(2, cfg.vocab, (p,)).astype(np.int32)
               for p, _ in specs]

    def run(with_faults):
        sched = Scheduler(engine)
        release = None
        if with_faults:
            faults.inject(sched, decode_faults=[
                faults.NonFiniteLogits(step=1, slot=0),
                faults.TransientError(step=4)])
            release = faults.hold_pages(sched, 1)
        for i, (_, g) in enumerate(specs):
            sched.submit(Request(rid=f"req{i}", tokens=prompts[i],
                                 gen=g))
        out = sched.run()
        if release is not None:
            release()
        return sched, out

    _, clean = run(False)
    sched, out = run(True)
    assert set(out) == set(clean)
    # the poisoned slot held req0: it fails with its pre-fault prefix
    assert out["req0"].status is RequestStatus.FAILED
    assert "non-finite" in out["req0"].error
    assert np.array_equal(out["req0"],
                          np.asarray(clean["req0"])[:len(out["req0"])])
    # the transient fault healed through one bounded retry, and the
    # survivors' streams never diverged
    assert sched.stats["step_retries"] == 1
    for rid in ("req1", "req2"):
        assert out[rid].ok
        assert np.array_equal(out[rid], clean[rid])
    assert sched.allocator.free_pages == engine.n_pages
    print(f"[inject] {cfg.name}: req0 FAILED at the injected NaN "
          f"(kept {len(out['req0'])} pre-fault tokens), 1 step retry, "
          "survivors bit-identical to the fault-free stream")
    print("inject example OK")


def poisson_demo(args, rate):
    """Seeded Poisson arrivals at ``rate`` requests per decode step
    (exponential gaps from a fixed-seed rng — same rate, same trace)
    instead of the scripted stagger; every request finishes with its
    full generation."""
    cfg, engine = _engine(args)
    sched = Scheduler(engine)
    rng = np.random.default_rng(0)
    n = 6
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    reqs = [Request(rid=f"req{i}",
                    tokens=rng.integers(
                        2, cfg.vocab,
                        (int(rng.integers(4, 20)),)).astype(np.int32),
                    gen=int(rng.integers(3, 9)))
            for i in range(n)]

    t, i = 0, 0
    while i < n or sched.n_active or sched.pending:
        while i < n and arrivals[i] <= t:
            sched.submit(reqs[i])
            i += 1
        sched.admit()
        if sched.n_active:
            sched.step()
        t += 1
        assert t < 10_000, "poisson stream failed to drain"
    out = sched.results()
    assert len(out) == n and all(out[r.rid].ok for r in reqs)
    assert all(len(out[r.rid]) == r.gen for r in reqs)
    itl = sched.itl_percentiles()
    print(f"[poisson] {cfg.name}: {n} requests, rate {rate:g}/step "
          f"(arrival steps {[round(float(a), 1) for a in arrivals]}), "
          f"{sched.stats['steps']} steps, "
          f"ITL p50/p99 {itl['p50'] * 1e3:.1f}/{itl['p99'] * 1e3:.1f} ms")
    print("poisson example OK")


def mixed_demo(args):
    """Mixed-traffic leg (chunked prefill): three short requests decode
    while a 40-token prompt arrives and chunk-prefills INSIDE their
    decode steps.  Asserted: during the whole prefill window every
    RUNNING slot emits a token on every step (zero stall steps), and the
    final streams equal the non-chunked scheduler's on the same engine
    (with int8 pools the long request's chunks re-read the quantized
    prefix, so its identity is relaxed)."""
    cfg, engine = _engine(args, batch=4, max_len=64,
                          chunked_prefill=True, chunk_tokens=8)
    rng = np.random.default_rng(3)
    shorts = [rng.integers(2, cfg.vocab, (6,)).astype(np.int32)
              for _ in range(3)]
    long_prompt = rng.integers(2, cfg.vocab, (40,)).astype(np.int32)

    def reqs():
        rs = [Request(rid=f"short{i}", tokens=t, gen=14)
              for i, t in enumerate(shorts)]
        rs.append(Request(rid="long", tokens=long_prompt, gen=4))
        return rs

    def prefilling(sched):
        return any(s is not None
                   and s.req.status is RequestStatus.PREFILLING
                   for s in sched.slots)

    def running(sched):
        return {s.req.rid: len(s.out) for s in sched.slots
                if s is not None and s.req.status is RequestStatus.RUNNING}

    sched = Scheduler(engine)
    rs = reqs()
    for r in rs[:3]:
        sched.submit(r)
    sched.admit()
    while prefilling(sched):
        sched.step()                        # drain the shorts' chunks
    sched.submit(rs[3])
    sched.admit()                           # long enters PREFILLING

    stall_steps, window = 0, 0
    while prefilling(sched):
        before = running(sched)
        sched.step()
        window += 1
        after = running(sched)
        stall_steps += sum(1 for rid in before
                           if rid in after and after[rid] <= before[rid])
    # 40 tokens / 8-token chunks = 5 mixed steps, zero decode stalls
    assert window == 5 and stall_steps == 0, (window, stall_steps)
    out = sched.run()
    assert all(out[r.rid].ok and len(out[r.rid]) == r.gen for r in rs)

    base = Scheduler(engine, chunked_prefill=False)
    for r in reqs():
        base.submit(r)
    ref = base.run()
    for r in rs:
        if args.kv_dtype == "bf16" or r.rid != "long":
            assert np.array_equal(out[r.rid], ref[r.rid]), r.rid
    st = sched.stats
    itl = sched.itl_percentiles()
    ident = ("streams bit-identical to the non-chunked scheduler"
             if args.kv_dtype == "bf16" else
             "short streams bit-identical (the int8 long prompt's "
             "chunks re-read the quantized prefix: near-ties may flip)")
    print(f"[mixed] {cfg.name}: 40-token prompt prefilled in "
          f"{st['chunks']} chunks across {st['mixed_steps']} mixed "
          f"steps while 3 short requests decoded — {stall_steps} stall "
          f"steps, ITL p99 {itl['p99'] * 1e3:.1f} ms — {ident}")
    print("mixed example OK")


def chunk_chaos_demo(args):
    """Chaos over a chunking stream: a transient fault lands on step 5,
    mid-way through the long prompt's chunks.  The bounded retry redoes
    that chunk only — the successful-chunk count matches the clean run —
    and every stream equals the fault-free chunked run's."""
    from repro_torch.engine import faults

    cfg, engine = _engine(args, batch=4, max_len=64,
                          chunked_prefill=True, chunk_tokens=8)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab, (6,)).astype(np.int32)
               for _ in range(3)]
    prompts.append(rng.integers(2, cfg.vocab, (40,)).astype(np.int32))
    gens = [14, 14, 14, 4]

    def run(with_fault):
        sched = Scheduler(engine)
        proxy = None
        if with_fault:
            # steps 0-2 chunk the three short prompts; steps 3-7 are
            # the long prompt's five chunks -> step 5 is mid-sequence
            proxy = faults.inject(sched, decode_faults=[
                faults.TransientError(step=5)])
        for i, (p, g) in enumerate(zip(prompts, gens)):
            sched.submit(Request(rid=f"req{i}", tokens=p, gen=g))
        return sched, proxy, sched.run()

    _, _, clean_out = run(False)
    sched, proxy, out = run(True)
    assert sched.stats["step_retries"] == 1
    assert proxy.mixed_fn.injected == 1      # it hit a MIXED step
    clean_chunks = 3 + 5                     # 3 shorts + 40/8 chunks
    assert sched.stats["chunks"] == clean_chunks  # only 1 chunk redone
    for rid in out:
        assert out[rid].ok
        assert np.array_equal(out[rid], clean_out[rid]), rid
    assert sched.allocator.free_pages == engine.n_pages
    print(f"[chunk-chaos] {cfg.name}: transient fault on mixed step 5 "
          f"(chunk 3/5 of the long prompt) healed with 1 retry of that "
          f"chunk only ({sched.stats['chunks']} chunks total, same as "
          "clean); streams bit-identical, pool fully drained")
    print("chunk-chaos example OK")


def _shared_prompts(cfg, rng, last):
    sys_toks = rng.integers(2, cfg.vocab, (16,)).astype(np.int32)
    return [np.concatenate([sys_toks, rng.integers(
                2, cfg.vocab, (8,)).astype(np.int32)]),
            np.concatenate([sys_toks, rng.integers(
                2, cfg.vocab, (4,)).astype(np.int32)]),
            rng.integers(2, cfg.vocab, (last,)).astype(np.int32)]


def prefix_demo(args):
    """Prefix-cache leg: three requests, two sharing a 2-page system
    prompt, through the radix-cached scheduler: every stream equals the
    cache-off scheduler's (int8 pools: the cache-miss requests only),
    with a nonzero hit rate.  With ``--inject`` a chaos pass rides on
    top with shared prefix pages live, and after the trie is cleared
    the pool must drain back to fully free (no page leak)."""
    cfg, engine = _engine(args, prefix_cache=True)
    prompts = _shared_prompts(cfg, np.random.default_rng(0), 8)
    gens = [6, 8, 5]

    def run(prefix_cache):
        sched = Scheduler(engine, prefix_cache=prefix_cache)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            sched.submit(Request(rid=f"req{i}", tokens=p, gen=g))
        return sched, sched.run()

    _, clean = run(False)
    sched, out = run(True)
    # req1 is the cache hit (req0 inserts the system pages first);
    # req0/req2 prefill cold either way and must match exactly always
    hit_rids = {"req1"}
    for rid in out:
        assert out[rid].ok
        if args.kv_dtype == "bf16" or rid not in hit_rids:
            assert np.array_equal(out[rid], clean[rid]), rid
    st = sched.stats
    assert st["prefix_hits"] >= 1 and st["prefix_hit_tokens"] >= 16
    hit_rate = st["prefix_hits"] / (st["prefix_hits"]
                                    + st["prefix_misses"])
    assert hit_rate > 0
    ident = ("streams bit-identical to the cache-off scheduler"
             if args.kv_dtype == "bf16" else
             "miss streams bit-identical (int8 hits read the "
             "dequantized prefix: near-ties may flip)")
    print(f"[prefix] {cfg.name}: 3 requests (2 share a 16-token system "
          f"prompt): hit rate {hit_rate:.2f}, "
          f"{st['prefix_hit_tokens']} prompt tokens from cache, peak "
          f"shared pages {st['shared_pages']} — {ident}")

    if args.inject:
        from repro_torch.engine import faults
        chaos = Scheduler(engine)
        faults.inject(chaos, decode_faults=[
            faults.NonFiniteLogits(step=1, slot=0),
            faults.TransientError(step=4)])
        release = faults.hold_pages(chaos, 1)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            chaos.submit(Request(rid=f"req{i}", tokens=p, gen=g))
        cout = chaos.run()
        release()
        assert set(cout) == set(out)
        assert chaos.stats["step_retries"] >= 1
        # no leak under faults: only the trie still holds pages, and
        # clearing it drains the pool completely
        chaos.allocator.check()
        chaos.prefix.check()
        assert chaos.allocator.free_pages == \
            engine.n_pages - chaos.prefix.cached_pages
        chaos.prefix.clear()
        assert chaos.allocator.free_pages == engine.n_pages
        print(f"[prefix+inject] chaos stream completed "
              f"({sum(1 for v in cout.values() if v.ok)}/{len(cout)} "
              "ok) with shared pages live; pool fully drained after "
              "trie clear — no page leak")
    print("prefix example OK")


def crash_recovery_demo(args, crash_at, snapshot_every):
    """Crash-recovery leg: the stream runs journaled and
    snapshot-cadenced under ``serve_with_recovery``, and a ``CrashFault``
    kills the first attempt at step ``crash_at``.  The restart loop
    restores the latest complete snapshot, replays the write-ahead
    journal and finishes the drain.  Asserted: every stream equals the
    crash-free reference, no result is lost, no page leaks.  Composes
    with --prefix-cache / --chunked-prefill / --kv-dtype."""
    from repro_torch.engine import faults
    from repro_torch.runtime.resilience import (RestartPolicy,
                                                serve_with_recovery)

    cfg, engine = _engine(args, prefix_cache=args.prefix_cache,
                          chunked_prefill=args.chunked_prefill,
                          chunk_tokens=8)
    prompts = _shared_prompts(cfg, np.random.default_rng(0), 24)
    gens = [6, 8, 5]

    def submit(sched):
        for i, (p, g) in enumerate(zip(prompts, gens)):
            sched.submit(Request(rid=f"req{i}", tokens=p, gen=g))

    ref = Scheduler(engine)
    submit(ref)
    want = ref.run()

    attempts = []

    def on_start(sched, fresh):
        attempts.append(fresh)
        if fresh:       # the crash hits only the pre-recovery process
            faults.inject(sched, decode_faults=[
                faults.CrashFault(step=crash_at)])

    with tempfile.TemporaryDirectory() as d:
        sched = serve_with_recovery(
            engine, d, submit, snapshot_every=snapshot_every,
            policy=RestartPolicy(max_restarts=3, backoff_s=0.0),
            on_start=on_start)
        saved = sched.snapshotter.saved

    assert attempts[0] is True and False in attempts[1:], \
        "the crash never fired (raise --crash-at past the drain?)"
    assert set(sched.finished) == set(want), "a result was lost"
    for rid, res in want.items():
        got = sched.finished[rid]
        assert got.status is res.status, rid
        assert np.array_equal(np.asarray(got), np.asarray(res)), rid
    sched.allocator.check()
    cached = sched.prefix.cached_pages if sched.prefix is not None else 0
    assert sched.allocator.free_pages == engine.n_pages - cached, \
        "page leaked across the crash"
    print(f"[crash] {cfg.name}: killed at step {crash_at}, "
          f"{len(attempts)} attempts, {saved} snapshots (cadence "
          f"{snapshot_every or 'journal-only'}); all "
          f"{len(want)} streams bit-identical to the crash-free run, "
          "no page leaked")
    print("crash-recovery example OK")


def batch_demo(args):
    """Batch decode: ``generate`` on the dense cache, then the raw step
    API (prefill, one decode step) that continuous batching builds on."""
    B, P, G = 4, 32, 16
    cfg = reduced(get_config(args.model))
    engine = DecodeEngine(cfg, EngineConfig(batch=B, max_len=P + G),
                          device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab, (B, P)).astype(np.int32)
    tokens, stats = engine.generate({"tokens": prompts}, gen=G)
    print(f"[engine] {engine.cfg.name} on {engine.device} "
          f"(kernel_impl {engine.cfg.kernel_impl!r}): prefill "
          f"{stats['prefill_tok_s']:.0f} tok/s, decode "
          f"{stats['decode_tok_s']:.0f} tok/s")
    for b in range(2):
        print("   gen:", tokens[b].cpu().numpy())
    assert tokens.shape == (B, G)

    # the same engine also exposes the raw step API (continuous batching
    # and speculative decoding build on these)
    logits, cache = engine.prefill({"tokens": prompts})
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits2, cache = engine.decode_step(tok, P, cache)
    assert logits2.shape[0] == B
    print("engine example OK")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.stream:
        batch_demo(args)
        return
    if args.arrival_rate is not None:
        poisson_demo(args, args.arrival_rate)
    else:
        stream_demo(args)
    if args.inject:
        inject_demo(args)
    if args.prefix_cache:
        prefix_demo(args)
    if args.chunked_prefill:
        mixed_demo(args)
        if args.inject:
            chunk_chaos_demo(args)
    if args.crash_at is not None:
        crash_recovery_demo(args, args.crash_at, args.snapshot_every)


if __name__ == "__main__":
    main()
