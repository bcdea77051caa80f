"""Paged KV cache: a shared page pool + per-slot block tables.

Counterpart of ``repro.engine.paged_cache`` for the KV-cache families:
dense and moe (each GQA or MLA), vlm and audio.  The cache is ``{"k",
"v"}`` pools of shape ``(L, n_pages, page_size, KV, Dh)``, or for MLA
the latent and rope pools ``{"ckv", "krope"}`` of shape ``(L, n_pages,
page_size, r)`` / ``(L, n_pages, page_size, rope)``; the moe family
nests either as ``{"dense": ... or None, "moe": ...}`` per layer group.
These are the layouts of the JAX package, so a pool copies across as it
is; a ``(B_slots, max_pages)`` int32 block table maps each slot's
logical page j to a physical page id handed out by ``PageAllocator``.

The audio family's cache is its self-attention pools ``self_k`` /
``self_v`` (L, n_pages, page_size, KV, Dh) plus the slot-dense cross
cache ``cross_k`` / ``cross_v`` (L, B_slots, enc_p, KV, Dh): written once
at admission, sized by the encoder budget padded up to whole pages, and
viewed as an identity-paged pool at attend time (``models.lm``).  The
vlm family's pools are the dense family's.

With ``kv_dtype='int8'`` the pools hold symmetric int8 pages with fp32
scale sidecars: ``k_scale``/``v_scale`` of shape ``(L, n_pages, KV)`` —
one scale per page and KV head — or ``ckv_scale``/``krope_scale`` of
shape ``(L, n_pages)`` — one per whole latent (rope) page — that the q8
decode kernels apply.

The JAX package writes pools functionally (``.at[].set`` on a donated
buffer); here every write is in place into the engine-owned pools
(``write_prefill``, ``quantized_page_write`` and the decode step), as
the port's dense cache already is; ``fork_page`` (the prefix cache's
copy-on-write) copies a page in place, across every leaf of the nested
tree.

On an engine whose pools are sequence-sharded over a mesh's 'model'
axis (``dist.sharding.paged_cache_pspecs``), each rank holds the slab of
pages [p0, p0 + pp) (``DecodeEngine.page_slab``) and every pool write
keeps only the rows bound for its pages, at their local ids; the
allocator and the block tables stay global and know nothing of the
mesh, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.kernels.quant import int8_scale, quantize_int8
from repro_torch.models import lm
from repro_torch.models.layers import dt

PAGED_FAMILIES = ("dense", "vlm", "moe", "audio")


def check_family(cfg) -> None:
    """Paged KV covers the KV-cache families (``ValueError`` for the
    recurrent ones, as in the JAX package)."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged KV cache supports the KV-cache families "
            f"{PAGED_FAMILIES}; family {cfg.family!r} carries O(1) "
            "recurrent state per slot (nothing to page) — serve it "
            "with the dense engine")


def max_pages(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def bucket_table_width(live_pages: int, max_pages: int) -> int:
    """Block-table width bucket covering ``live_pages`` columns: the
    next power of two, capped at ``max_pages``.  JAX compiles one step
    per bucket; here a bucket only sets J of the kernel launch, so a
    step stages at most the bucket width of pages per slot."""
    if live_pages >= max_pages:
        return max_pages
    w = 1
    while w < max(live_pages, 1):
        w *= 2
    return min(w, max_pages)


def enc_padded(enc_len: int, page_size: int) -> int:
    """The cross cache's positions a slot: ``enc_len`` (at least 1)
    padded up to whole pages."""
    return max_pages(max(enc_len, 1), page_size) * page_size


def paged_cache_spec(cfg, n_pages: int, page_size: int,
                     batch_slots: int = 1, enc_len: int = 0,
                     kv_dtype: str = None):
    """{name: (shape, dtype)} of the paged decode cache (nested per layer
    group for the moe family).  The audio family's cross pair is
    slot-dense, (L, batch_slots, enc_padded(enc_len), KV, Dh) at the
    model dtype.

    ``kv_dtype``: None/'bf16' keeps the pools at the model dtype;
    'int8' stores int8 pools plus fp32 scales, (L, n_pages, KV) for K/V
    pools and (L, n_pages) for the latent and rope pools.  The audio
    family takes no int8 pools (``ValueError``, as in the JAX package)."""
    check_family(cfg)
    if kv_dtype not in (None, "bf16", "int8"):
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                         f"{kv_dtype!r}")
    q8 = kv_dtype == "int8"
    if q8 and cfg.family == "audio":
        raise ValueError(
            "kv_dtype='int8' is unsupported for the audio family: the "
            "slot-dense cross cache is written once at admission and "
            "stays at the model dtype — serve audio with kv_dtype="
            "'bf16'")
    pool_dt = torch.int8 if q8 else dt(cfg)

    def group(shapes):
        spec = {name: (sh, pool_dt) for name, sh in shapes.items()}
        if q8:
            for name, sh in shapes.items():
                # one scale a page and KV head, or a whole latent page
                spec[name + "_scale"] = (sh[:2] + sh[3:-1], torch.float32)
        return spec

    tree = lm.group_specs(cfg, (n_pages, page_size))
    if cfg.family == "moe":
        return {k: None if g is None else group(g) for k, g in tree.items()}
    spec = group(tree)
    if cfg.family == "audio":
        xh = lm.cross_shape(cfg, batch_slots,
                            enc_padded(enc_len, page_size))
        spec.update(cross_k=(xh, dt(cfg)), cross_v=(xh, dt(cfg)))
    return spec


def _layer_aligned_zeros(shape, dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` (L, ...) whose every layer starts on a 16-byte
    boundary, as the kernels take their operands: the layer stride is
    padded up to a multiple of 16 bytes (an (n_pages, KV) fp32 scale
    layer need not be one), so each layer is a contiguous view."""
    L, n = shape[0], math.prod(shape[1:])
    per = 16 // torch.empty((), dtype=dtype).element_size()
    stride = -(-n // per) * per
    return torch.zeros((L, stride), dtype=dtype,
                       device=device)[:, :n].view(shape)


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     batch_slots: int = 1, enc_len: int = 0,
                     kv_dtype: str = None, device="cuda"):
    return lm.map_groups(
        lambda sd: _layer_aligned_zeros(sd[0], sd[1], device),
        paged_cache_spec(cfg, n_pages, page_size, batch_slots, enc_len,
                         kv_dtype))


# ----------------------------------------------------------------------
# prefill -> pages
# ----------------------------------------------------------------------

def _page_rows(kv, table, ps, slab=None):
    """kv (L, B', S, KV, Dh) -> (L, B'*J, ps, KV, Dh) pages, S padded up
    to a page multiple with zeros (the pad scrubs stale bytes from a
    reused page), and the (B'*J,) physical ids they go to.  With ``slab``
    (p0, pp), a rank's share of a pool sharded over 'model', only the
    pages in [p0, p0 + pp) are kept, at their local ids."""
    L, Bp, S = kv.shape[:3]
    pad = (-S) % ps
    if pad:
        kv = torch.cat([kv, kv.new_zeros((L, Bp, pad, *kv.shape[3:]))], 2)
    J = kv.shape[2] // ps
    ids = torch.as_tensor(table, device=kv.device)[:, :J].reshape(-1).long()
    rows = kv.reshape(L, Bp * J, ps, *kv.shape[3:])
    if slab is not None:
        p0, pp = slab
        keep = ((ids >= p0) & (ids < p0 + pp)).nonzero()[:, 0]
        rows, ids = rows[:, keep], ids[keep] - p0
    return rows, ids


def _scatter_pages(pool, kv, table, slab=None):
    """pool (L, n_pages, ps, ...) <- kv (L, B', S, ...) at the pages of
    ``table`` (B', max_pages), in place (this rank's pages of them under
    ``slab``)."""
    rows, ids = _page_rows(kv, table, pool.shape[2], slab)
    pool[:, ids] = rows.to(pool.dtype)


def _scatter_pages_q8(pool, scales, kv, table, slab=None):
    """Quantize-on-write prefill scatter into an int8 pool and its scales,
    in place: one symmetric int8 scale per (page, KV head) over the
    page's (page_size, Dh) values for a K/V pool ((L, n_pages, KV)
    scales), one per whole page for a flat latent or rope pool (L,
    n_pages, ps, r) ((L, n_pages) scales).  The zero pad of a partial
    last page stays inside the group, so it scrubs stale bytes and
    leaves the amax alone.  The scales shard with their pages."""
    rows, ids = _page_rows(kv, table, pool.shape[2], slab)
    if pool.ndim == 5:
        q, s = quantize_int8(rows, axis=(2, 4))  # s: (L, B'*J, 1, KV, 1)
        s = s[:, :, 0, :, 0]
    else:
        q, s = quantize_int8(rows, axis=(2, 3))  # s: (L, B'*J, 1, 1)
        s = s[:, :, 0, 0]
    pool[:, ids] = q
    scales[:, ids] = s


def quantized_page_write(pool, scales, pages, offs, x):
    """One decode token per active slot into one layer's int8 pool
    (n_pages, ps, KV, Dh) with scales (n_pages, KV), or a flat latent
    pool (n_pages, ps, r) with one scale a page (n_pages,), in place.

    pages, offs: (A,) physical page and offset of each active slot's
    write (inactive slots are left out by the caller, where the JAX
    function sends them to page ``n_pages`` and drops the write);
    x: (A, KV, Dh) or (A, r) the new token's values.

    A write at offset 0 resets the page's scale to the token's own amax
    and zeroes the rest of the page (the scrub of a reused page); a
    later write takes ``max(s_old, s_tok)`` and requantizes the page's
    resident rows onto the new grid before inserting the token, so a
    page's scale only grows while it fills."""
    A = x.shape[0]
    if A == 0:
        return
    xf = x.float()
    s_tok = int8_scale(xf.abs().amax(-1))             # (A, KV) or (A,)
    s_old = scales[pages]
    per_head = pool.ndim == 4
    fresh = (offs == 0)[:, None] if per_head else offs == 0
    s_new = torch.where(fresh, s_tok, torch.maximum(s_old, s_tok))

    def ex(t):                          # per-page values -> page shape
        return t[:, None, :, None] if per_head else t[:, None, None]

    page_f = pool[pages].float() * ex(s_old)
    page_f = torch.where(ex(fresh), 0.0, page_f)
    qpage = torch.clamp(torch.round(page_f / ex(s_new)),
                        -127, 127).to(torch.int8)
    qtok = torch.clamp(torch.round(xf / s_new[..., None]),
                       -127, 127).to(torch.int8)
    qpage[torch.arange(A, device=x.device), offs] = qtok
    pool[pages] = qpage
    scales[pages] = s_new


def _scatter_group(group, stacks, table, slab) -> None:
    """One layer group's prefill stacks into its pools ({"k", "v"} or
    {"ckv", "krope"}, in that order), quantize-on-write when the group
    carries scales."""
    for name, kv in zip(("ckv", "krope") if "ckv" in group else ("k", "v"),
                        stacks):
        if name + "_scale" in group:
            _scatter_pages_q8(group[name], group[name + "_scale"], kv,
                              table, slab)
        else:
            _scatter_pages(group[name], kv, table, slab)


def _write_cross(cache, cross, slots) -> None:
    """The audio prefill's cross stacks (xk, xv) (L, B', S_enc, KV, Dh)
    into rows ``slots`` of the slot-dense cross cache, zero-padded up to
    its enc_p positions (the pad scrubs a reused slot's tail).  An
    encoder longer than the cache raises ``ValueError`` (the Scheduler
    rejects such a request before its prefill)."""
    enc_p = cache["cross_k"].shape[2]
    S = cross[0].shape[2]
    if S > enc_p:
        raise ValueError(f"{S} encoder positions exceed the cross cache's "
                         f"{enc_p} a slot")
    ids = torch.as_tensor(slots, device=cross[0].device).long()
    for name, xkv in zip(("cross_k", "cross_v"), cross):
        buf = cache[name]
        buf[:, ids, S:] = 0
        buf[:, ids, :S] = xkv.to(buf.dtype)


def write_prefill(cfg, cache, caches, table, enc_slots=None,
                  slab=None) -> None:
    """Scatter prefill KV material into the page pools, in place.

    ``caches`` is ``lm.prefill``'s cache stacks for B' requests (the
    whole batch, or 1 for the scheduler's admission): (k, v) (L, B', S,
    KV, Dh), or for the moe family the pair (dense layers' stacks or
    None, MoE layers'), each (k, v) or MLA's (c_kv, k_rope), or for the
    audio family the pair (self (k, v), cross (xk, xv)), whose cross
    stacks go to the slot-dense cross cache's rows ``enc_slots`` (B',)
    (default 0 .. B' - 1);
    ``table`` holds the rows (B', >= ceil(S / page_size)) of the pages
    they land in, host ints or a device tensor: a whole prompt's row, or
    for a suffix or a chunk (``lm.prefill_suffix`` / ``prefill_chunk``,
    which start page-aligned) the row of pages from its first position
    on — never a shared prefix page.  ``slab`` (p0, pp): the pools are a
    rank's pages [p0, p0 + pp) of a pool sharded over 'model' (``engine.
    DecodeEngine.page_slab``), and only the rows bound for them are
    written, at their local ids (the audio family is not served
    sharded)."""
    check_family(cfg)
    if cfg.family == "moe":
        kv_d, kv_m = caches
        if kv_d is not None:
            _scatter_group(cache["dense"], kv_d, table, slab)
        _scatter_group(cache["moe"], kv_m, table, slab)
    elif cfg.family == "audio":
        (k, v), cross = caches
        _scatter_pages(cache["self_k"], k, table)
        _scatter_pages(cache["self_v"], v, table)
        _write_cross(cache, cross, range(k.shape[1]) if enc_slots is None
                     else enc_slots)
    else:
        _scatter_group(cache, caches, table, slab)


def fork_page(cfg, cache, src: int, dst: int) -> None:
    """Copy physical page ``src`` onto ``dst`` across every pool leaf of
    the (nested) cache, in place (the JAX function maps the tree and
    returns a new cache): the K/V or latent and rope pools and, for int8
    pools, the fp32 scale rows, which are part of the page (a forked
    page must dequantize exactly like its original until the diverging
    write lands).  A None group (the moe family without dense layers) is
    skipped.  Every leaf of these paged caches has the page axis at 1
    (pools ``(L, n_pages, ps, ...)``, scales ``(L, n_pages[, KV])``);
    the audio family's slot-dense cross cache does not, and is
    refused."""
    if cfg.family == "audio":
        raise ValueError(
            "fork_page does not support the audio family: the slot-dense "
            "cross cache carries slots, not pages, at axis 1")
    check_family(cfg)

    def fork(leaf):
        leaf[:, dst] = leaf[:, src]

    lm.map_groups(fork, cache)


# ----------------------------------------------------------------------
# host-side page allocator
# ----------------------------------------------------------------------

class PagePoolExhausted(RuntimeError):
    """Raised when an admit/step needs more pages than the pool has
    free — evict a request, shrink the stream, or raise ``n_pages``."""


class PageAllocator:
    """Refcounted free-list over physical page ids [0, n_pages): pure
    host state, the device only ever sees block tables.

    ``alloc`` hands a page out at refcount 1; a further holder takes a
    ref with ``incref`` and releases it with ``decref``, and the page
    returns to the free list when its last ref drops.  ``free`` is the
    exclusive-owner release: it rejects a shared page, a double free and
    a page that was never handed out.  ``check()`` asserts the pool
    invariant (owned and free partition the pages, every owned page
    holds a ref, no free page does).  ``to_state`` / ``load_state`` carry
    the partition, free-list order included, through an engine snapshot
    (``engine.snapshot``)."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: set = set()
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one holder."""
        return sum(1 for r in self._refs.values() if r > 1)

    def refcount(self, page: int) -> int:
        """Current holders of ``page`` (0 = free)."""
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: need {n} page(s), "
                f"{len(self._free)} free of {self.n_pages} "
                f"(evict a request or raise n_pages / EngineConfig."
                f"page_size)")
        out = [self._free.pop() for _ in range(n)]
        self._owned.update(out)
        for p in out:
            self._refs[p] = 1
        return out

    def _validate_owned(self, pages: Sequence[int], verb: str) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"{verb} invalid page id {p}")
            if p not in self._owned:
                raise ValueError(
                    f"{verb} page {p}: not currently handed out "
                    "(already freed, or never allocated)")

    def incref(self, pages: Sequence[int]) -> None:
        """Take one more ref on each page (pages must be handed out)."""
        self._validate_owned(pages, "incref of")
        for p in pages:
            self._refs[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one ref per page; a page whose last ref drops returns to
        the free list.  A page may appear more than once (one ref per
        occurrence)."""
        self._validate_owned(pages, "decref of")
        counts: Dict[int, int] = {}
        for p in pages:
            counts[p] = counts.get(p, 0) + 1
        for p, n in counts.items():
            if self._refs[p] < n:
                raise ValueError(
                    f"decref of page {p} by {n} holder(s) but only "
                    f"{self._refs[p]} ref(s) held")
        released = []
        for p, n in counts.items():
            self._refs[p] -= n
            if self._refs[p] == 0:
                del self._refs[p]
                self._owned.discard(p)
                released.append(p)
        self._free.extend(released)

    def free(self, pages: Sequence[int]) -> None:
        """Exclusive-owner release: every page must hold exactly one ref;
        a shared page raises (route shared ownership through
        ``decref``)."""
        seen: set = set()
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if p in seen:
                raise ValueError(f"double free of page {p} within one "
                                 "free() call")
            if p not in self._owned:
                raise ValueError(
                    f"double free of page {p}: not currently handed "
                    "out (already freed, or never allocated)")
            if self._refs.get(p, 0) != 1:
                raise ValueError(
                    f"free of shared page {p} (refcount "
                    f"{self._refs.get(p, 0)}): another holder still "
                    "references it — decref instead")
            seen.add(p)
        for p in pages:
            self._owned.discard(p)
            del self._refs[p]
        self._free.extend(pages)

    def check(self) -> bool:
        """Validate the pool invariant; raises ``ValueError`` on any
        violation, returns True otherwise."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise ValueError("free list contains duplicate page ids")
        overlap = free & self._owned
        if overlap:
            raise ValueError(f"pages both free and owned: "
                             f"{sorted(overlap)}")
        universe = free | self._owned
        if universe != set(range(self.n_pages)):
            raise ValueError(
                f"page leak: owned ∪ free covers {len(universe)} of "
                f"{self.n_pages} pages "
                f"(missing {sorted(set(range(self.n_pages)) - universe)})")
        unref = self._owned - set(self._refs)
        if unref:
            raise ValueError(f"owned pages with no refcount: "
                             f"{sorted(unref)}")
        bad = [p for p, r in self._refs.items() if r < 1]
        if bad:
            raise ValueError(f"refcount < 1 on owned pages: {sorted(bad)}")
        ghost = set(self._refs) - self._owned
        if ghost:
            raise ValueError(f"refcounts on pages not handed out: "
                             f"{sorted(ghost)}")
        return True

    def to_state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of the pool partition.  The free
        LIST (not set) is captured in order: ``alloc`` pops from the
        end, so reproducing the exact order is what makes page
        assignment — and therefore block tables — deterministic across
        a snapshot/restore cycle."""
        return {"n_pages": self.n_pages,
                "free": list(self._free),
                "refs": [[int(p), int(r)]
                         for p, r in sorted(self._refs.items())]}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore a ``to_state`` snapshot (validates the partition)."""
        if int(state["n_pages"]) != self.n_pages:
            raise ValueError(
                f"allocator snapshot covers {state['n_pages']} pages "
                f"but this pool has {self.n_pages}")
        self._free = [int(p) for p in state["free"]]
        self._refs = {int(p): int(r) for p, r in state["refs"]}
        self._owned = set(self._refs)
        self.check()
