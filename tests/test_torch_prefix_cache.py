"""The port's prefix cache, against the JAX package.

The radix trie (``engine.prefix_cache``) driven side by side with JAX's
over the same allocator operations: the refcounted allocator, the
whole-page boundaries, longest prefix-ordered matches, dedup, LRU
eviction that never drops a held page, and a random interleaving that
pins the refcount partition.  ``fork_page`` copies every pool leaf
(int8 scales included, the nested latent pools of the moe family too)
as JAX's does and refuses the audio family.  ``lm.prefill_suffix``
against JAX's on the same pools; then the Scheduler: prefix on == off
(bucketed and fixed-width tables) and equal to the JAX Scheduler's
streams, for the three configs of the JAX matrix (gqa, mla: the dense
family with MLA, moe-mla: one dense and one MoE layer at capacity factor
4), multi-turn reuse of generated tokens,
no double free when a sharing slot is preempted, the copy-on-write
guard, eviction before preemption, and ``clear`` draining the pool.
Shapes are those of ``tests/test_prefix_cache.py`` (2 layers, d 64,
page 4, fp32); the JAX engines run on an explicit (1, 1) mesh with Auto
axes (ROADMAP queue 3).
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
from repro.engine import PageAllocator as JPageAllocator  # noqa: E402
from repro.engine import PrefixCache as JPrefixCache  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import Scheduler as JScheduler  # noqa: E402
from repro.engine import paged_cache as jpc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common import config as tconfig  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                PageAllocator, Request, Scheduler,
                                fork_page)
from repro_torch.engine import paged_cache as tpc  # noqa: E402
from repro_torch.engine.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.models import lm  # noqa: E402

PS = 4          # page_size used throughout

_BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
             remat="none", attn_block_q=32, attn_block_kv=32)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfg(**kw):
    return ModelConfig(**{**_BASE, **kw})


# the JAX matrix's configs (tests/test_prefix_cache.py): GQA, the dense
# family with MLA, and the moe family with MLA
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


def _leaves(tree, path=()):
    """(path, tensor or array) of every leaf of a nested cache, None
    groups skipped."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        elif v is not None:
            yield path + (k,), v


def _engine(B=2, P=8, G=5, n_pages=16, params=None, **kw):
    return DecodeEngine(_cfg(), EngineConfig(
        batch=B, max_len=P + G, paged=True, page_size=PS, n_pages=n_pages,
        prefix_cache=True, kernel_impl="torch", **kw), params=params,
        device="cpu", seed=0)


def _run(eng, reqs, *, prefix_cache=None, **sched_kw):
    sched = Scheduler(eng, prefix_cache=prefix_cache, **sched_kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


def _reqs(prompts, gen=5, cls=Request):
    return [cls(rid=i, tokens=np.asarray(p, np.int32), gen=gen, seed=i)
            for i, p in enumerate(prompts)]


class _Both:
    """The port's allocator + trie and JAX's, driven by the same calls;
    every call returns both results, asserted equal."""

    def __init__(self, n_pages):
        self.al = (PageAllocator(n_pages), JPageAllocator(n_pages))
        self.pc = (PrefixCache(PS, self.al[0]), JPrefixCache(PS, self.al[1]))

    def __getattr__(self, name):
        obj, what = name.split("_", 1)

        def call(*args):
            pair = self.al if obj == "al" else self.pc
            got = [getattr(o, what) for o in pair]
            if callable(got[0]):
                got = [f(*args) for f in got]
            assert got[0] == got[1], (name, got)
            return got[0]
        return call

    def check(self):
        for o in (*self.al, *self.pc):
            o.check()
        assert self.pc[0].to_state() == self.pc[1].to_state()


# ------------------------------------------------- refcounted allocator

def test_allocator_refcounts():
    b = _Both(4)
    (p,) = b.al_alloc(1)
    assert b.al_refcount(p) == 1 and b.al_shared_pages() == 0
    b.al_incref([p])
    assert b.al_refcount(p) == 2 and b.al_shared_pages() == 1
    b.al_decref([p])
    assert b.al_refcount(p) == 1 and b.al_used_pages() == 1
    b.al_decref([p])                    # last ref: page returns
    assert b.al_free_pages() == 4 and b.al_refcount(p) == 0
    b.check()


def test_allocator_free_of_shared_page_raises_and_duplicates_decref():
    for al in (PageAllocator(4), JPageAllocator(4)):
        pages = al.alloc(2)
        al.incref(pages)
        with pytest.raises(ValueError, match="shared page"):
            al.free(pages)
        al.decref(pages)
        al.free(pages)                  # sole ref: plain free still works
        (p,) = al.alloc(1)
        al.incref([p])
        al.decref([p, p])               # two refs released in one call
        assert al.free_pages == 4
        al.check()


# ------------------------------------------------- trie boundaries

def _insert(b, tokens):
    """Retiring-slot idiom: alloc the whole pages, insert, drop the slot
    refs (the trie keeps what it indexed, the rest frees)."""
    pages = b.al_alloc(len(tokens) // PS)
    b.pc_insert(tokens, pages)
    if pages:
        b.al_decref(pages)
    return pages


@pytest.mark.parametrize("P,want_cached,want_match", [
    (1, 0, 0),           # 1-token prompt: nothing whole to share
    (PS - 1, 0, 0),      # under a page
    (PS, 1, 0),          # one page cached, but the SAME prompt must keep
                         # >= 1 suffix token
    (PS + 1, 1, 1),      # one whole page + partial tail
    (2 * PS, 2, 1),      # two whole pages; match capped at len - 1
    (2 * PS + 1, 2, 2),
], ids=["one-token", "ps-1", "ps", "ps+1", "2ps", "2ps+1"])
def test_trie_whole_page_boundaries(P, want_cached, want_match):
    b = _Both(16)
    tokens = np.arange(P, dtype=np.int32)
    _insert(b, tokens)
    assert b.pc_cached_pages() == want_cached
    assert len(b.pc_match(tokens)) == want_match
    assert b.al_used_pages() == want_cached     # partial tail pages freed
    b.check()


def test_trie_match_is_prefix_ordered_and_longest():
    b = _Both(16)
    tokens = np.arange(3 * PS, dtype=np.int32)
    pages = b.al_alloc(3)
    b.pc_insert(tokens, pages)
    b.al_decref(pages)
    assert b.pc_match(np.concatenate([tokens, [99]])) == pages
    q2 = np.concatenate([tokens[:2 * PS], [7] * PS, [99]])
    assert b.pc_match(q2) == pages[:2]
    assert b.pc_match(np.asarray([5, 6, 7])) == []
    b.check()


def test_trie_dedup_keeps_canonical_page():
    b = _Both(16)
    tokens = np.arange(PS, dtype=np.int32)
    (a,) = b.al_alloc(1)
    assert b.pc_insert(tokens, [a]) == 1
    (c,) = b.al_alloc(1)
    assert b.pc_insert(tokens, [c]) == 0    # duplicate: no new node
    assert b.pc_match(np.concatenate([tokens, [0]])) == [a]
    assert b.al_refcount(c) == 1            # duplicate stays caller-owned
    b.al_decref([a, c])
    b.check()


def test_trie_evict_lru_and_refcount_safety():
    """Eviction is LRU over refcount-1 leaves and never drops a page a
    slot still holds; emptying a branch cascades to its parent."""
    b = _Both(16)
    old = np.asarray([1] * (2 * PS), np.int32)
    new = np.asarray([2] * PS, np.int32)
    old_pages = b.al_alloc(2)
    b.pc_insert(old, old_pages)
    b.al_decref(old_pages)
    new_pages = b.al_alloc(1)
    b.pc_insert(new, new_pages)
    b.al_decref(new_pages)
    b.al_incref(new_pages)                  # pinned like a slot would
    assert b.pc_evict(10) == 2              # both old pages, cascading
    assert b.al_refcount(new_pages[0]) == 2
    assert b.pc_cached_pages() == 1
    b.al_decref(new_pages)
    assert b.pc_evict(10) == 1              # unpinned: now evictable
    assert b.al_free_pages() == 16
    b.check()


def test_trie_state_round_trip():
    b = _Both(16)
    _insert(b, np.arange(3 * PS + 1, dtype=np.int32))
    _insert(b, np.concatenate([np.arange(PS), [9] * PS]).astype(np.int32))
    state = b.pc[0].to_state()
    pc, jpc_ = PrefixCache(PS, b.al[0]), JPrefixCache(PS, b.al[1])
    pc.load_state(state)
    jpc_.load_state(state)

    def canon(st):          # node order may change across a round trip
        nodes, out = st["nodes"], []
        for nd in nodes:
            path, at = [], nd
            while True:
                path.insert(0, tuple(at["key"]))
                if at["parent"] < 0:
                    break
                at = nodes[at["parent"]]
            out.append((tuple(path), nd["page"], nd["last_used"]))
        return sorted(out), st["clock"], st["stats"]

    assert canon(pc.to_state()) == canon(state) == canon(jpc_.to_state())
    assert pc.cached_pages == 4
    assert pc.match(np.arange(3 * PS + 1)) == b.pc[0].match(
        np.arange(3 * PS + 1))


def test_refcount_partition_under_random_interleaving():
    """Random insert / match+hold / release / evict interleavings keep
    the refcount partition exact — every owned page's refcount equals
    (trie nodes owning it) + (outstanding holds on it) — eviction never
    frees a held page, and JAX's trie makes every same decision."""
    rng = np.random.default_rng(0)
    b = _Both(12)
    holds = []

    def partition():
        counts = {}
        stack = list(b.pc[0]._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            counts[nd.page] = counts.get(nd.page, 0) + 1
        for pages in holds:
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        al = b.al[0]
        assert set(counts) == {p for p in range(al.n_pages)
                               if al.refcount(p) > 0}
        for p, want in counts.items():
            assert al.refcount(p) == want, f"page {p}"
        b.check()

    for _ in range(400):
        op = rng.integers(0, 4)
        toks = rng.integers(0, 2, (int(rng.integers(1, 3 * PS + 2)),))
        if op == 0:                                  # retiring insert
            if len(toks) // PS <= b.al_free_pages():
                _insert(b, toks)
        elif op == 1:                                # match + hold
            pages = b.pc_match(toks)
            if pages:
                b.al_incref(pages)
                holds.append(pages)
        elif op == 2 and holds:                      # release a hold
            b.al_decref(holds.pop(int(rng.integers(len(holds)))))
        elif op == 3:                                # evict
            held = {p for hold in holds for p in hold}
            b.pc_evict(int(rng.integers(1, 4)))
            for p in held:
                assert b.al_refcount(p) >= 1, "evicted a held page"
        partition()
    for pages in holds:
        b.al_decref(pages)
    b.pc_clear()
    assert b.al_free_pages() == 12


# ------------------------------------------------- copy-on-write fork

@pytest.mark.parametrize("kind,kv_dtype", [
    ("gqa", "bf16"), ("gqa", "int8"), ("mla", "int8"), ("moe-mla", "int8"),
    ("moe-mla", "bf16")], ids=["bf16", "int8", "mla-int8", "moe-mla-int8",
                               "moe-mla-bf16"])
def test_fork_page_copies_every_leaf(kind, kv_dtype, rng):
    """``fork_page`` duplicates one physical page across every pool leaf
    — the fp32 scale rows of int8 pools included, the latent and rope
    pools of MLA and both groups of the moe family's nested tree — in
    place, leaving every other page alone, as JAX's functional fork
    does."""
    jc, tc = _kind_cfgs(kind)
    eng = DecodeEngine(tc, EngineConfig(
        batch=2, max_len=13, paged=True, page_size=PS, n_pages=16,
        kv_dtype=kv_dtype, kernel_impl="torch"), device="cpu", seed=0)
    cache = eng.init_paged_cache()
    for _, leaf in _leaves(cache):
        src = (rng.standard_normal(leaf.shape) if leaf.is_floating_point()
               else rng.integers(-5, 5, leaf.shape))
        leaf.copy_(torch.from_numpy(np.asarray(src)).to(leaf.dtype))
    before = {p: v.numpy().copy() for p, v in _leaves(cache)}
    jcache = lm.map_groups(lambda t: jnp.asarray(t.numpy().copy()), cache)
    src, dst, other = 1, 3, 0
    fork_page(eng.cfg, cache, src, dst)
    jforked = dict(_leaves(jpc.fork_page(jc, jcache, src, dst)))
    assert set(before) == set(jforked)
    if kind == "moe-mla" and kv_dtype == "int8":
        assert ("moe", "ckv_scale") in before
    for path, leaf in _leaves(cache):
        got, was, name = leaf.numpy(), before[path], "/".join(path)
        np.testing.assert_array_equal(got[:, dst], was[:, src], name)
        np.testing.assert_array_equal(got[:, other], was[:, other], name)
        np.testing.assert_array_equal(got[:, src], was[:, src], name)
        np.testing.assert_array_equal(got, np.asarray(jforked[path]), name)


def test_fork_page_rejects_audio():
    eng = _engine()
    with pytest.raises(ValueError, match="audio"):
        fork_page(_cfg(family="audio"), eng.init_paged_cache(), 0, 1)


# ------------------------------------------------- suffix prefill

@pytest.mark.parametrize("kind,kv_dtype", [
    pytest.param(k, kv, id=_kind_id(k, kv))
    for k in KINDS for kv in ("bf16", "int8")])
def test_prefill_suffix_matches_jax(kind, kv_dtype, rng):
    """A prompt's first two pages prefilled into the pools, then its
    suffix through ``lm.prefill_suffix`` over those pages: logits and
    the suffix's cache stacks (K/V, or MLA's latent and rope rows; both
    layer groups of the moe family) against JAX's ``lm.prefill_suffix``
    on the same pools, at 1e-4 of their scale (int8 pools dequantized
    through their scales by both)."""
    jc, tc = _kind_cfgs(kind)
    jparams = jlm.init(jc, jax.random.PRNGKey(0))
    params = bridge.from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    P, M = 11, 2 * PS
    toks = rng.integers(2, tc.vocab, (P,)).astype(np.int32)
    pages = np.asarray([5, 2], np.int32)
    _, jkv = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:M])[None]},
                         jc)
    jcache = jpc.write_prefill(
        jc, jpc.init_paged_cache(jc, 8, PS, 1, kv_dtype=kv_dtype), jkv,
        jnp.asarray(pages)[None])
    cache = tpc.init_paged_cache(tc, 8, PS, kv_dtype=kv_dtype,
                                 device="cpu")
    _, kv = lm.prefill(params, {"tokens": torch.from_numpy(toks[:M])[None]},
                       tc)
    tpc.write_prefill(tc, cache, kv, pages[None])
    want, jstacks = jlm.prefill_suffix(
        jparams, {"tokens": jnp.asarray(toks[M:])[None],
                  "pages": jnp.asarray(pages), "cache": jcache}, jc)
    got, stacks = lm.prefill_suffix(
        params, {"tokens": torch.from_numpy(toks[M:])[None], "pages": pages,
                 "cache": cache}, tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    pairs = [(got, want)]
    if kind == "moe-mla":       # (dense layers' stacks, MoE layers')
        stacks, jstacks = (*stacks[0], *stacks[1]), (*jstacks[0],
                                                     *jstacks[1])
    pairs += list(zip(stacks, jstacks))
    assert len(pairs) == (5 if kind == "moe-mla" else 3)
    for g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_prefill_suffix_refuses_frontend_families():
    with pytest.raises(ValueError, match="token-only"):
        lm.prefill_suffix({}, {"tokens": None, "pages": [], "cache": {}},
                          _cfg(family="vlm"))


# ------------------------------------------------- Scheduler

_MESH = None


def _jax_stream(ekw, prompts, gen, jc=None, **sched_kw):
    global _MESH
    if _MESH is None:
        _MESH = jax.make_mesh((1, 1), ("data", "model"),
                              axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JEngine(jc or JModelConfig(**_BASE), JEngineConfig(**ekw),
                   mesh=_MESH)
    sched = JScheduler(jeng, **sched_kw)
    for r in _reqs(prompts, gen, cls=JRequest):
        sched.submit(r)
    out = sched.run()
    return jeng, sched, out


@pytest.mark.parametrize("kind,bucket,kv_dtype", [
    pytest.param(k, b, kv, id=_kind_id(
        k, f"{'bucketed' if b else 'fixed-width'}-{kv}"))
    for k in KINDS for b in (True, False) for kv in ("bf16", "int8")
    if b or k == "gqa"])
def test_prefix_scheduler_matches_off_and_jax(kind, bucket, kv_dtype, rng):
    """Shared-prompt requests run suffix-only prefill over aliased pages:
    the streams with the cache ON equal the cache-off ones and the JAX
    Scheduler's (same parameters), with the same hit counters, for both
    table widths (gqa) and for the dense and moe families with MLA."""
    jc, tc = _kind_cfgs(kind)
    P, G = 9, 5
    ekw = dict(batch=2, max_len=P + 3 + G, paged=True, page_size=PS,
               n_pages=16, prefix_cache=True, kv_dtype=kv_dtype)
    shared = rng.integers(2, 256, (P,)).astype(np.int32)
    prompts = [shared, shared,                      # exact repeat
               np.concatenate([shared, [7, 8, 9]]),  # extension
               rng.integers(2, 256, (P,))]           # unrelated
    jeng, jsched, jwant = _jax_stream(ekw, prompts, G, jc,
                                      bucket_tables=bucket)
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="torch"),
                       params=bridge.from_jax(jax.tree.map(
                           np.asarray, jeng.params), "cpu"), device="cpu")
    off, want = _run(eng, _reqs(prompts, G), prefix_cache=False,
                     bucket_tables=bucket)
    on, got = _run(eng, _reqs(prompts, G), bucket_tables=bucket)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], np.asarray(jwant[i]),
                                      err_msg=f"req {i} vs JAX")
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"req {i} vs off")
    for key in ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "shared_pages", "prefills", "steps", "table_widths"):
        assert on.stats[key] == jsched.stats[key], key
    assert on.stats["prefix_hits"] >= 2
    assert on.stats["prefix_hit_tokens"] >= 2 * PS
    assert on.stats["shared_pages"] >= 1
    assert off.stats["prefix_hits"] == 0
    on.prefix.check()
    on.allocator.check()


def test_multi_turn_retirement_indexes_generated_tokens(rng):
    """A follow-up prompt extending a finished conversation (prompt +
    generated tokens) hits pages covering the GENERATED history too, and
    its stream equals a cold scheduler's."""
    P, G = 8, 6
    eng = _engine(B=2, P=P + G + 4, G=G, n_pages=24)
    prompt = rng.integers(2, eng.cfg.vocab, (P,)).astype(np.int32)
    s1, out1 = _run(eng, [Request(rid=0, tokens=prompt, gen=G, seed=0)])
    follow = np.concatenate([prompt, np.asarray(out1[0], np.int32),
                             rng.integers(2, eng.cfg.vocab, (3,))
                             .astype(np.int32)])
    s1.submit(Request(rid=1, tokens=follow, gen=3, seed=1))
    out2 = s1.run()
    assert out2[1].ok
    assert s1.stats["prefix_hit_tokens"] >= ((P + G - 1) // PS) * PS
    _, want = _run(eng, [Request(rid=1, tokens=follow, gen=3, seed=1)],
                   prefix_cache=False)
    np.testing.assert_array_equal(out2[1], want[1])


def test_preempting_shared_slot_no_double_free(rng):
    """Two slots alias the same prefix pages; preempting one decrefs,
    leaving the survivor's prefix intact and the allocator coherent."""
    P, G = 9, 6
    eng = _engine(B=2, P=P, G=G, n_pages=24)
    shared = rng.integers(2, eng.cfg.vocab, (P,)).astype(np.int32)
    _, want = _run(eng, _reqs([shared, shared], G), prefix_cache=False)
    sched = Scheduler(eng)
    for r in _reqs([shared, shared], G):
        sched.submit(r)
    assert sched.admit() == 2
    assert sched.allocator.shared_pages >= 1
    sched._preempt(1)               # mid-flight eviction of the sharer
    sched.allocator.check()
    sched.prefix.check()
    out = sched.run()               # the victim re-admits and finishes
    for i in range(2):
        np.testing.assert_array_equal(out[i], want[i], f"req {i}")
    sched.allocator.check()


def test_cow_guard_forks_shared_write_page(rng):
    """An externally shared WRITE page (a snapshot-style incref) is
    forked before the next decode write: the stream is unchanged and the
    pinned page is never written through."""
    P, G = 9, 6
    eng = _engine(B=1, P=P, G=G, n_pages=16)
    prompt = rng.integers(2, eng.cfg.vocab, (P,)).astype(np.int32)
    _, want = _run(eng, [Request(rid=0, tokens=prompt, gen=G, seed=0)],
                   prefix_cache=False)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, tokens=prompt, gen=G, seed=0))
    assert sched.admit() == 1
    slot = sched.slots[0]
    pinned = slot.pages[slot.length // sched.page_size]
    sched.allocator.incref([pinned])        # outside snapshot ref
    snap = sched.cache["k"][:, pinned].clone()
    out = sched.run()
    np.testing.assert_array_equal(out[0], want[0])
    assert sched.stats["cow_forks"] >= 1
    torch.testing.assert_close(sched.cache["k"][:, pinned], snap,
                               rtol=0, atol=0)
    assert sched.allocator.refcount(pinned) == 1
    sched.allocator.decref([pinned])
    sched.allocator.check()


def test_eviction_precedes_preemption(rng):
    """Pool pressure reclaims refcount-1 trie leaves before any active
    slot is preempted."""
    P, G = 8, 6
    eng = _engine(B=1, P=P, G=G, n_pages=4)
    reqs = [Request(rid=i, tokens=rng.integers(2, eng.cfg.vocab, (P,))
                    .astype(np.int32), gen=G, seed=i) for i in range(2)]
    sched, out = _run(eng, reqs)
    assert out[0].ok and out[1].ok
    assert sched.stats["prefix_evictions"] >= 1
    assert sched.stats["preempted"] == 0
    sched.allocator.check()


def test_clear_drains_pool(rng):
    """After the drain the only pages still held are the trie's;
    ``clear()`` hands every one back."""
    eng = _engine(P=9, G=5)
    shared = rng.integers(2, eng.cfg.vocab, (9,)).astype(np.int32)
    sched, out = _run(eng, _reqs([shared, shared, shared]))
    assert all(v.ok for v in out.values())
    assert sched.allocator.free_pages == \
        eng.n_pages - sched.prefix.cached_pages
    sched.prefix.clear()
    assert sched.allocator.free_pages == eng.n_pages
    sched.allocator.check()
