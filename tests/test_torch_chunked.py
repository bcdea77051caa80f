"""Chunked prefill in the port, against the JAX package.

The ``pack_chunk`` token-budget rule's boundary cases (and JAX's rule on
the same cases); the plain chunk-prefix partials against JAX's
``chunk_prefix_paged`` 'xla' and 'pallas' (interpret) backends, int8
pools included; the masked-prefix identity; chunk rows against the
whole prompt's rows, in the attention and through ``lm.prefill_chunk``;
greedy Scheduler streams of the chunked mixed step against the JAX
chunked Scheduler's and the port's unchunked ones; the page-boundary,
one-token-final-chunk and prefix-hit-all-but-one admission edges;
preemption in mid-prefill; a transient fault on a mixed step; a
non-finite final chunk; the config checks; the ITL percentiles; and the
'cuda' attention op refusing a suffix-shaped call.  ``prefill_chunk``
and the Scheduler streams run the three configs of the JAX matrix
(``tests/test_chunked.py``): gqa, mla (the dense family with MLA) and
moe-mla (one dense and one MoE layer, capacity factor 4 so that no token
drops), on bf16 and int8 pools.  Shapes are those of
``tests/test_chunked.py`` (2 layers, d 64, page 4, chunk 8, fp32).  The
JAX engines run on an explicit (1, 1) mesh with Auto axes (its default
mesh fails under JAX 0.9, ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.common import config as jconfig  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import Scheduler as JScheduler  # noqa: E402
from repro.engine.scheduler import pack_chunk as jpack_chunk  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common import config as tconfig  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                Request, RequestStatus, Scheduler, faults)
from repro_torch.engine.scheduler import pack_chunk  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402

PS = 4          # page_size used throughout
CT = 8          # chunk_tokens (2 pages) used throughout
TOL = dict(rtol=2e-5, atol=2e-5)

_BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
             remat="none", attn_block_q=32, attn_block_kv=32)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfg(**kw):
    return ModelConfig(**{**_BASE, **kw})


# the JAX matrix's configs (tests/test_chunked.py): GQA, the dense family
# with MLA, and the moe family with MLA
_MLA = dict(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
            nope_head_dim=16, v_head_dim=16)
_MOE = dict(n_experts=4, top_k=2, d_expert=32, first_k_dense=1,
            d_ff_dense=128, capacity_factor=4.0)
KINDS = ("gqa", "mla", "moe-mla")


def _kind_cfgs(kind):
    """(JAX ModelConfig, port ModelConfig) of one of ``KINDS``."""
    out = []
    for mod in (jconfig, tconfig):
        kw = dict(_BASE)
        if kind != "gqa":
            kw["mla"] = mod.MLAConfig(**_MLA)
        if kind == "moe-mla":
            kw.update(family="moe", moe=mod.MoEConfig(**_MOE))
        out.append(mod.ModelConfig(**kw))
    return tuple(out)


def _kind_id(kind, rest):
    """The gqa cases keep the ids they had before the MLA configs."""
    return rest if kind == "gqa" else f"{kind}-{rest}"


def _engine(cfg=None, B=2, max_len=32, n_pages=24, impl="torch",
            params=None, **kw):
    return DecodeEngine(cfg or _cfg(), EngineConfig(
        batch=B, max_len=max_len, paged=True, page_size=PS,
        n_pages=n_pages, chunked_prefill=True, chunk_tokens=CT,
        kernel_impl=impl, **kw), params=params, device="cpu", seed=0)


def _run(eng, reqs, **sched_kw):
    sched = Scheduler(eng, **sched_kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


# ------------------------------------------------- pack_chunk boundaries

@pytest.mark.parametrize("remaining,n_decode,budget,want", [
    (40, 2, 2 + CT, CT),       # full chunk fits beside the decodes
    (40, 10, 10, 0),           # decode fills the budget: no chunk
    (40, 7, 10, 0),            # room 3 < page: floored away
    (40, 6, 10, PS),           # room 4: one whole page
    (40, 2, 2 + CT - 1, PS),   # room 7 floors to one page, not two
    (5, 2, 2 + CT, 5),         # final chunk: exact, unaligned
    (1, 2, 2 + CT, 1),         # 1-token final chunk
    (CT, 2, 2 + CT, CT),       # final chunk landing ON the boundary
    (40, 0, 1, 0),             # budget 1, room < page
    (3, 0, 1, 0),              # would be final but room 1 < remaining 3
    (1, 0, 1, 1),              # empty batch still prefills
], ids=["full", "starved", "floored-0", "floored-1page", "floored-7",
        "final-unaligned", "final-1tok", "final-aligned", "tiny-budget",
        "tiny-budget-nonfinal", "empty-batch"])
def test_pack_chunk_boundaries(remaining, n_decode, budget, want):
    got = pack_chunk(remaining, n_decode, budget, CT, PS)
    assert got == want == jpack_chunk(remaining, n_decode, budget, CT, PS)
    assert got <= remaining and got <= CT
    if got:
        assert n_decode + got <= budget
    if 0 < got < remaining:
        assert got % PS == 0   # non-final chunks end page-aligned


# ------------------------------------------------- the chunk-prefix partials

def _pools(rng, n_pages=6, KV=2, Dh=16):
    return (rng.standard_normal((n_pages, PS, KV, Dh)).astype(np.float32),
            rng.standard_normal((n_pages, PS, KV, Dh)).astype(np.float32))


def _close_partials(got, want):
    for g, w, name in zip(got, want, ("o_tilde", "m", "l")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("counts", [(PS, PS, PS), (PS, 3, 0), (PS, 1, 1)],
                         ids=["full-pages", "partial-tail", "sparse"])
def test_chunk_prefix_op_matches_jax(counts, rng):
    """The port's 'torch' and 'cuda' (on the CPU: the kernel's plain
    version) ops against JAX's 'xla' gather and its 'pallas' kernel in
    interpret mode, on the same numpy inputs."""
    from repro.kernels import dispatch as JD
    C, H, Dh = 8, 4, 16
    kp, vp = _pools(rng)
    q = rng.standard_normal((C, H, Dh)).astype(np.float32)
    table = np.asarray([4, 1, 3], np.int32)
    cnt = np.asarray(counts, np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, cnt)]
    targs = [_t(a) for a in (q, kp, vp, table, cnt)]
    for jimpl in ("xla", "pallas"):
        want = JD.dispatch("chunk_prefix_paged", jimpl, *jargs,
                           page_size=PS, max_pages=3)
        for timpl in ("torch", "cuda"):
            _close_partials(D.dispatch("chunk_prefix_paged", timpl,
                                       *targs), want)


def test_chunk_prefix_q8_op_matches_jax(rng):
    from repro.kernels import dispatch as JD
    C, H, KV, Dh = 8, 4, 2, 16
    kq = rng.integers(-127, 128, (6, PS, KV, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (6, PS, KV, Dh)).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (6, KV)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (6, KV)).astype(np.float32)
    q = rng.standard_normal((C, H, Dh)).astype(np.float32)
    table = np.asarray([0, 5, 2], np.int32)
    cnt = np.asarray([PS, PS, 2], np.int32)
    args = (q, kq, vq, ks, vs, table, cnt)
    for jimpl in ("xla", "pallas"):
        want = JD.dispatch("chunk_prefix_paged_q8", jimpl,
                           *map(jnp.asarray, args), page_size=PS,
                           max_pages=3)
        for timpl in ("torch", "cuda"):
            _close_partials(D.dispatch("chunk_prefix_paged_q8", timpl,
                                       *map(_t, args)), want)


def test_chunk_prefix_table_is_clamped(rng):
    """Entries past the pool read its last page, as the JAX wrappers
    clamp them (a permuted table may hold ids of pages not handed out)."""
    C, H, Dh = 4, 4, 16
    kp, vp = map(_t, _pools(rng))
    q = _t(rng.standard_normal((C, H, Dh)).astype(np.float32))
    cnt = torch.tensor([PS, 2], dtype=torch.int32)
    got = A.chunk_prefix_attend_partial(
        q, kp, vp, torch.tensor([9, -3], dtype=torch.int32), cnt)
    want = A.chunk_prefix_attend_partial(
        q, kp, vp, torch.tensor([5, 0], dtype=torch.int32), cnt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_masked_prefix_partial_is_identity(rng):
    """A fully masked prefix partial (counts all zero — the FIRST chunk of
    a prompt) merges into the self partial as an exact no-op, in the port
    and in the JAX package."""
    C, H, KV, Dh = 8, 4, 2, 16
    kp, vp = _pools(rng)
    q = rng.standard_normal((C, H, Dh)).astype(np.float32)
    ck = rng.standard_normal((C, KV, Dh)).astype(np.float32)
    cv = rng.standard_normal((C, KV, Dh)).astype(np.float32)
    table = np.zeros((3,), np.int32)
    cnt = np.zeros((3,), np.int32)
    for impl in ("torch", "cuda"):
        got = A.chunk_prefill_attend(*map(_t, (q, ck, cv, kp, vp, table,
                                               cnt)), backend=impl)
        o_t, _, l = A.chunk_self_attn_partial(*map(_t, (q, ck, cv)))
        torch.testing.assert_close(got, A.normalize_partial(o_t, l,
                                                            torch.float32),
                                   rtol=0, atol=0)
    jgot = JA.chunk_prefill_attend(*map(jnp.asarray, (q, ck, cv, kp, vp,
                                                      table, cnt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)


def test_merge_partials_matches_jax(rng):
    C, H, Dh = 6, 4, 16
    parts = []
    for masked in (False, True):
        o = rng.standard_normal((C, H, Dh)).astype(np.float32)
        m = rng.standard_normal((C, H)).astype(np.float32)
        l = rng.uniform(0.5, 2.0, (C, H)).astype(np.float32)
        if masked:        # a fully masked row merges as a no-op
            m[0], l[0], o[0] = -1e30, 0.0, 0.0
        parts.append((o, m, l))
    want = JA.merge_partials(*[tuple(map(jnp.asarray, p)) for p in parts])
    got = A.merge_partials(*[tuple(map(_t, p)) for p in parts])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        A.normalize_partial(got[0], got[2], torch.float32).numpy(),
        np.asarray(JA.normalize_partial(want[0], want[2], jnp.float32)),
        **TOL)


def test_chunk_rows_match_whole_prefill_rows(rng):
    """Prefix partial over the earlier chunks' pooled K/V merged with the
    chunk's self partial reproduces the rows of one causal pass over the
    whole prompt, for both backends, as in the JAX package."""
    S, C, H, KV, Dh = 16, CT, 4, 2, 16
    k = rng.standard_normal((S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((S, KV, Dh)).astype(np.float32)
    q = rng.standard_normal((S, H, Dh)).astype(np.float32)
    o_t, _, l = A.chunk_self_attn_partial(_t(q), _t(k), _t(v))
    whole = A.normalize_partial(o_t, l, torch.float32).numpy()
    jo, _, jl = JA.chunk_self_attn_partial(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(
        whole, np.asarray(JA.normalize_partial(jo, jl, jnp.float32)),
        **TOL)
    kp = _t(k.reshape(S // PS, PS, KV, Dh))
    vp = _t(v.reshape(S // PS, PS, KV, Dh))
    for c0 in range(C, S, C):
        jp = c0 // PS
        table = torch.arange(jp, dtype=torch.int32)
        cnt = torch.full((jp,), PS, dtype=torch.int32)
        for impl in ("torch", "cuda"):
            got = A.chunk_prefill_attend(
                _t(q[c0:c0 + C]), _t(k[c0:c0 + C]), _t(v[c0:c0 + C]),
                kp, vp, table, cnt, backend=impl)
            np.testing.assert_allclose(got.numpy(), whole[c0:c0 + C],
                                       **TOL, err_msg=f"chunk at {c0}")


@pytest.mark.parametrize("kind,kv_dtype", [
    pytest.param(k, kv, id=_kind_id(k, kv))
    for k in KINDS for kv in ("bf16", "int8")])
def test_prefill_chunk_matches_whole_prefill_and_jax(kind, kv_dtype, rng):
    """Chunk by chunk through ``lm.prefill_chunk`` (the engine's chunk
    path), against JAX's ``lm.prefill_chunk`` on the same parameters and
    pages (1e-4 of the logits' scale).  For model-dtype pools each
    chunk's last-token logits are also the whole prompt's at that
    position, bit for bit (the blockwise pass sees the same kv block
    boundaries; no MoE token drops at capacity factor 4), and the pools
    end up holding the whole prefill's cache.  int8 pools read the
    earlier chunks through the quantized pages; their first-layer pages,
    which do not depend on the prefix, are the whole prefill's."""
    from repro.engine import paged_cache as jpc
    from repro.models import lm as jlm
    from repro_torch.engine import paged_cache as tpc
    jc, tc = _kind_cfgs(kind)
    jparams = jlm.init(jc, jax.random.PRNGKey(0))
    eng = _engine(tc, kv_dtype=kv_dtype, params=bridge.from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    cfg, params = eng.cfg, eng.params
    P = 19
    toks = rng.integers(2, cfg.vocab, (P,)).astype(np.int32)
    pages = np.asarray([7, 2, 11, 5, 0], np.int32)
    want_cache = eng.init_paged_cache()
    _, caches = lm.prefill(params, {"tokens": _t(toks)[None]}, cfg)
    tpc.write_prefill(cfg, want_cache, caches, pages[None])
    cache = eng.init_paged_cache()
    jcache = jpc.init_paged_cache(jc, eng.n_pages, PS, 2, kv_dtype=kv_dtype)
    for p0 in range(0, P, CT):
        C = min(CT, P - p0)
        chunk = {"tokens": toks[p0:p0 + C][None],
                 "pages": pages[:p0 // PS],
                 "write_pages": pages[p0 // PS:-(-(p0 + C) // PS)]}
        got, cache = lm.prefill_chunk(params, {**chunk, "cache": cache},
                                      cfg)
        jgot, jcache = jlm.prefill_chunk(
            jparams, {**{k: jnp.asarray(v) for k, v in chunk.items()},
                      "cache": jcache}, jc)
        scale = float(jnp.abs(jgot).max())
        assert (got.numpy() - np.asarray(jgot)).__abs__().max() \
            <= 1e-4 * scale, f"chunk at {p0}"
        if kv_dtype == "bf16":
            whole, _ = lm.prefill(
                params, {"tokens": _t(toks[:p0 + C])[None]}, cfg)
            torch.testing.assert_close(got, whole, rtol=0, atol=0)
    layers = slice(None) if kv_dtype == "bf16" else slice(0, 1)
    # the first layer group: the whole cache, or the moe family's dense
    # layers (which come first)
    first = (lambda c: c["dense"]) if kind == "moe-mla" else (lambda c: c)
    groups = ([(cache["dense"], want_cache["dense"]),
               (cache["moe"], want_cache["moe"])] if kind == "moe-mla"
              else [(cache, want_cache)])
    if kv_dtype == "int8":
        groups = [(first(cache), first(want_cache))]
    for got_g, want_g in groups:
        for name in got_g:
            torch.testing.assert_close(got_g[name][layers, pages],
                                       want_g[name][layers, pages],
                                       rtol=0, atol=0)


def test_cuda_attention_refuses_a_suffix_shaped_call():
    """The 'cuda' attention op's kernel has no positional offset: queries
    at [M, M+S) over keys [0, M+S) raise rather than give wrong rows (the
    suffix path calls blockwise_attn itself)."""
    q = torch.zeros(1, 3, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="suffix-shaped"):
        D.dispatch("attention", "cuda", q, kv, kv, causal=True,
                   q_positions=torch.arange(5, 8),
                   kv_positions=torch.arange(8))
    # the plain op takes it, and so does the non-causal blockwise path
    D.dispatch("attention", "torch", q, kv, kv, causal=True,
               q_positions=torch.arange(5, 8), kv_positions=torch.arange(8))
    D.dispatch("attention", "cuda", q, kv, kv, causal=False)


# ------------------------------------------------- Scheduler streams

_SPECS = [(19, 6), (5, 4), (11, 5)]
_MESH = None


def _jax_engine(ekw, jc=None):
    global _MESH
    if _MESH is None:
        _MESH = jax.make_mesh((1, 1), ("data", "model"),
                              axis_types=(AxisType.Auto, AxisType.Auto))
    return JEngine(jc or JModelConfig(**_BASE), JEngineConfig(**ekw),
                   mesh=_MESH)


@pytest.mark.parametrize("kind,prefix,kv_dtype", [
    pytest.param(k, p, kv, id=_kind_id(
        k, f"{'prefix' if p else 'no-prefix'}-{kv}"))
    for k in KINDS for p in (False, True) for kv in ("bf16", "int8")])
def test_chunked_scheduler_matches_jax_and_unchunked(kind, prefix,
                                                     kv_dtype):
    """config x pool dtype x prefix cache: the port's chunked streams
    equal the JAX chunked Scheduler's (same parameters, same requests),
    with the same chunk counters; for model-dtype pools they also equal
    the port's unchunked streams.  On int8 pools a later chunk reads the
    earlier ones through the quantized pages, so the first token of the
    19-token gqa prompt differs from the unchunked stream here — in the
    JAX Scheduler exactly as in the port, which is what is held."""
    ekw = dict(batch=2, max_len=32, paged=True, page_size=PS, n_pages=24,
               chunked_prefill=True, chunk_tokens=CT, kv_dtype=kv_dtype,
               prefix_cache=prefix)
    jc, tc = _kind_cfgs(kind)
    jeng = _jax_engine(ekw, jc)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="torch"),
                       params=params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 256, (p,)).astype(np.int32)
               for p, _ in _SPECS]

    def run(sched_cls, req_cls, e, **kw):
        sched = sched_cls(e, **kw)
        for i, (_, g) in enumerate(_SPECS):
            sched.submit(req_cls(rid=i, tokens=prompts[i], gen=g, seed=i))
        return sched, sched.run()

    jon, jwant = run(JScheduler, JRequest, jeng)
    on, got = run(Scheduler, Request, eng)
    off, unchunked = run(Scheduler, Request, eng, chunked_prefill=False)
    for i in range(len(_SPECS)):
        assert got[i].status is RequestStatus.FINISHED
        np.testing.assert_array_equal(got[i], np.asarray(jwant[i]),
                                      err_msg=f"req {i} vs JAX")
        if kv_dtype == "bf16":
            np.testing.assert_array_equal(got[i], unchunked[i],
                                          err_msg=f"req {i} vs unchunked")
    for key in ("chunks", "mixed_steps", "chunked_tokens", "steps",
                "prefills", "prefix_hits", "prefix_misses"):
        assert on.stats[key] == jon.stats[key], key
    assert on.stats["chunks"] >= 3 and on.stats["mixed_steps"] >= 3
    assert on.stats["chunked_tokens"] == sum(p for p, _ in _SPECS)
    assert off.stats["chunks"] == 0 and off.stats["mixed_steps"] == 0
    assert on.allocator.free_pages == eng.n_pages - (
        on.prefix.cached_pages if on.prefix is not None else 0)
    on.allocator.check()


def test_chunked_streams_on_the_kernel_backend():
    """The 'cuda' backend (on the CPU: each kernel's plain version, the
    prefill through vwr_attention's) serves the same chunked streams as
    the plain backend's unchunked ones."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 256, (p,)).astype(np.int32)
               for p, _ in _SPECS]

    def reqs():
        return [Request(rid=i, tokens=prompts[i], gen=g, seed=i)
                for i, (_, g) in enumerate(_SPECS)]

    eng = _engine(impl="cuda", prefix_cache=True)
    plain = _engine(impl="torch", params=eng.params)
    _, got = _run(eng, reqs())
    _, want = _run(plain, reqs(), chunked_prefill=False)
    for i in range(len(_SPECS)):
        np.testing.assert_array_equal(got[i], want[i])


# ------------------------------------------------- admission edges

def _identity_case(prompt_len, gen, want_chunks, rng):
    eng = _engine(max_len=40, n_pages=32)
    toks = rng.integers(2, eng.cfg.vocab, (prompt_len,)).astype(np.int32)
    _, want = _run(eng, [Request(rid=0, tokens=toks, gen=gen, seed=0)],
                   chunked_prefill=False)
    on, got = _run(eng, [Request(rid=0, tokens=toks, gen=gen, seed=0)])
    np.testing.assert_array_equal(got[0], want[0])
    assert on.stats["chunks"] == want_chunks
    assert on.allocator.free_pages == eng.n_pages


def test_chunk_ends_exactly_on_page_boundary(rng):
    """Prompt = 2 full chunks: the final chunk lands on a page boundary."""
    _identity_case(2 * CT, 5, 2, rng)


def test_one_token_final_chunk(rng):
    """Prompt = 2 chunks + 1: the final chunk is one token (the first
    token comes from a C = 1 chunk's logits)."""
    _identity_case(2 * CT + 1, 5, 3, rng)


def test_prefix_hit_consuming_all_but_one_token(rng):
    """A cached prefix covering every whole page of the prompt leaves a
    1-token suffix: chunked admission enqueues exactly one 1-token final
    chunk over the aliased pages."""
    eng = _engine(max_len=32, n_pages=24, prefix_cache=True)
    toks = rng.integers(2, eng.cfg.vocab, (2 * PS + 1,)).astype(np.int32)
    _, want = _run(eng, [Request(rid=0, tokens=toks, gen=5, seed=0)],
                   chunked_prefill=False, prefix_cache=False)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, tokens=toks, gen=5, seed=0))
    out0 = sched.run()                      # cold: inserts 2 pages
    np.testing.assert_array_equal(out0[0], want[0])
    chunks_cold = sched.stats["chunks"]
    sched.submit(Request(rid=1, tokens=toks, gen=5, seed=1))
    out = sched.run()                       # hit: 8 of 9 tokens cached
    assert sched.stats["prefix_hits"] == 1
    assert sched.stats["prefix_hit_tokens"] == 2 * PS
    assert sched.stats["chunks"] == chunks_cold + 1   # one 1-token chunk
    np.testing.assert_array_equal(out[1], want[0])
    sched.prefix.check()
    sched.allocator.check()


# ------------------------------------------------- preemption mid-prefill

def test_preempt_mid_prefill_keeps_completed_pages(rng):
    """Preempting a PREFILLING slot drops only the in-flight chunk: the
    whole pages its completed chunks wrote travel with the queued slot,
    re-admission grants the missing tail, chunking resumes where it left
    off, and the stream equals the unchunked scheduler's."""
    eng = _engine(B=1, max_len=32, n_pages=16)
    toks = rng.integers(2, eng.cfg.vocab, (19,)).astype(np.int32)
    _, want = _run(eng, [Request(rid=0, tokens=toks, gen=6, seed=0)],
                   chunked_prefill=False)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, tokens=toks, gen=6, seed=0))
    assert sched.admit() == 1
    slot = sched.slots[0]
    assert slot.req.status is RequestStatus.PREFILLING
    granted = len(slot.pages)
    sched.step()                            # chunk 1: prefilled 8
    sched.step()                            # chunk 2: prefilled 16
    assert slot.prefilled == 2 * CT
    sched._preempt(0)
    item = sched.pending[0]
    assert len(item.pages) == 2 * CT // PS
    assert item.prefilled == 2 * CT
    assert sched.allocator.free_pages == eng.n_pages - len(item.pages)
    assert granted > len(item.pages)
    sched.allocator.check()
    out = sched.run()                       # re-admit: 1 chunk remains
    np.testing.assert_array_equal(out[0], want[0])
    assert sched.stats["preempted"] == 1
    assert sched.stats["chunks"] == 3
    assert sched.stats["chunked_tokens"] == 19
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()


def test_cancel_of_a_chunk_preempted_slot_releases_its_pages(rng):
    """A chunk-preempted slot holds its completed pages while queued; a
    cancel there gives them back."""
    eng = _engine(B=1, max_len=32, n_pages=16)
    toks = rng.integers(2, eng.cfg.vocab, (19,)).astype(np.int32)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, tokens=toks, gen=6, seed=0))
    sched.admit()
    sched.step()
    sched._preempt(0)
    assert sched.allocator.free_pages == eng.n_pages - CT // PS
    assert sched.cancel(0)
    assert sched.finished[0].status is RequestStatus.CANCELLED
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()


# ------------------------------------------------- mixed-step faults

def test_transient_fault_mid_chunk_retries_that_chunk_only(rng):
    """A transient fault on a mixed step redoes the in-flight chunk and
    nothing else: one step retry, the clean run's chunk count, the same
    stream."""
    eng = _engine(B=1, max_len=32, n_pages=16)
    toks = rng.integers(2, eng.cfg.vocab, (19,)).astype(np.int32)

    def run(with_fault):
        sched = Scheduler(eng)
        proxy = None
        if with_fault:
            proxy = faults.inject(sched, decode_faults=[
                faults.TransientError(step=1)])   # the 2nd chunk
        sched.submit(Request(rid=0, tokens=toks, gen=6, seed=0))
        return sched, proxy, sched.run()

    _, _, clean = run(False)
    sched, proxy, out = run(True)
    assert sched.stats["step_retries"] == 1
    assert proxy.mixed_fn.injected == 1     # it hit a MIXED step
    assert sched.stats["chunks"] == 3       # no completed chunk redone
    assert out[0].ok
    np.testing.assert_array_equal(out[0], clean[0])
    assert sched.allocator.free_pages == eng.n_pages


def test_nonfinite_final_chunk_quarantines_alone(rng):
    """NaN logits of a final chunk fail that request alone (the finite
    flag read back with the step's picks); the slot and its pages free,
    the other request's stream is untouched, and a later request on the
    same scheduler runs clean."""
    eng = _engine(B=2, max_len=32, n_pages=16)
    toks = rng.integers(2, eng.cfg.vocab, (19,)).astype(np.int32)
    other = rng.integers(2, eng.cfg.vocab, (5,)).astype(np.int32)
    _, clean = _run(eng, [Request(rid=1, tokens=other, gen=6, seed=1)])

    def poisoned(params, batch):
        logits, chunk_logits, cache = eng.mixed_fn(params, batch)
        if np.array_equal(batch["chunk_tokens"], toks[2 * CT:]):
            chunk_logits = chunk_logits.fill_(float("nan"))  # rid 0's last
        return logits, chunk_logits, cache

    sched = Scheduler(eng)
    sched.eng = faults.FaultyEngine(eng)
    sched.eng.mixed_fn = poisoned
    sched.submit(Request(rid=1, tokens=other, gen=6, seed=1))
    sched.submit(Request(rid=0, tokens=toks, gen=6, seed=0))
    out = sched.run()
    assert out[0].status is RequestStatus.FAILED
    assert "chunked prefill" in out[0].error and len(out[0]) == 0
    np.testing.assert_array_equal(out[1], clean[1])
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()
    sched.eng = eng
    sched.submit(Request(rid=2, tokens=toks[:9], gen=4, seed=2))
    out = sched.run()
    assert out[2].ok and len(out[2]) == 4
    assert sched.allocator.free_pages == eng.n_pages


# ------------------------------------------------- config and metrics

def test_chunk_tokens_must_be_page_multiple():
    # a Scheduler that turns chunking on over a config that left it off
    # checks the config's chunk_tokens too
    eng = DecodeEngine(_cfg(), EngineConfig(
        batch=1, max_len=16, paged=True, page_size=PS,
        chunk_tokens=PS + 1), device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        Scheduler(eng, chunked_prefill=True)
    with pytest.raises(ValueError, match="positive multiple"):
        DecodeEngine(_cfg(), EngineConfig(
            batch=1, max_len=16, paged=True, page_size=PS,
            chunked_prefill=True, chunk_tokens=PS + 1), device="cpu")


def test_itl_percentiles_populated(rng):
    eng = _engine()
    reqs = [Request(rid=i, tokens=rng.integers(2, eng.cfg.vocab, (p,))
                    .astype(np.int32), gen=g, seed=i)
            for i, (p, g) in enumerate(_SPECS)]
    sched, out = _run(eng, reqs)
    assert all(v.ok for v in out.values())
    itl = sched.itl_percentiles()
    assert set(itl) == {"p50", "p90", "p99"}
    assert all(v >= 0 for v in itl.values())
    for i, (_, g) in enumerate(_SPECS):
        assert out[i].token_times is not None
        assert len(out[i].token_times) == g
