"""Paged KV cache: a shared page pool + per-slot block tables.

Counterpart of ``repro.engine.paged_cache`` for the dense (GQA) family.
The cache is ``{"k", "v"}`` pools of shape ``(L, n_pages, page_size,
KV, Dh)``, the layout of the JAX package, so a pool copies across as it
is; a ``(B_slots, max_pages)`` int32 block table maps each slot's
logical page j to a physical page id handed out by ``PageAllocator``.

With ``kv_dtype='int8'`` the pools hold symmetric int8 pages with fp32
scale sidecars ``k_scale``/``v_scale`` of shape ``(L, n_pages, KV)`` —
one scale per page and KV head — that the q8 decode kernel applies per
key.

The JAX package writes pools functionally (``.at[].set`` on a donated
buffer); here every write is in place into the engine-owned pools
(``write_prefill``, ``quantized_page_write`` and the decode step), as
the port's dense cache already is.  The MLA, MoE and audio pools and
``fork_page`` (the prefix cache's copy-on-write) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.kernels.quant import int8_scale, quantize_int8
from repro_torch.models.layers import dt

PAGED_FAMILIES = ("dense", "vlm", "moe", "audio")


def check_family(cfg) -> None:
    """Paged KV covers the KV-cache families (``ValueError`` for the
    recurrent ones, as in the JAX package); of those the port serves the
    dense GQA family so far."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged KV cache supports the KV-cache families "
            f"{PAGED_FAMILIES}; family {cfg.family!r} carries O(1) "
            "recurrent state per slot (nothing to page) — serve it "
            "with the dense engine")
    if cfg.family != "dense" or cfg.mla is not None:
        what = "MLA" if cfg.mla is not None else cfg.family
        where = ("item 10 (MoE + MLA families)"
                 if cfg.family == "moe" or cfg.mla is not None
                 else "item 11 (remaining families)")
        raise NotImplementedError(
            f"paged {what} pools are not ported to repro_torch yet: "
            f"ROADMAP queue 1 {where}")


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


def paged_cache_spec(cfg, n_pages: int, page_size: int,
                     kv_dtype: str = None):
    """{name: (shape, dtype)} of the paged decode cache.

    ``kv_dtype``: None/'bf16' keeps the pools at the model dtype;
    'int8' stores int8 pools plus fp32 (L, n_pages, KV) scales."""
    check_family(cfg)
    if kv_dtype not in (None, "bf16", "int8"):
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                         f"{kv_dtype!r}")
    q8 = kv_dtype == "int8"
    pool_dt = torch.int8 if q8 else dt(cfg)
    L, KV = cfg.n_layers, cfg.n_kv_heads
    sh = (L, n_pages, page_size, KV, cfg.d_head)
    spec = {"k": (sh, pool_dt), "v": (sh, pool_dt)}
    if q8:
        spec["k_scale"] = ((L, n_pages, KV), torch.float32)
        spec["v_scale"] = ((L, n_pages, KV), torch.float32)
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
                     kv_dtype: str = None, device="cuda"):
    return {name: _layer_aligned_zeros(shape, dtype, device)
            for name, (shape, dtype) in paged_cache_spec(
                cfg, n_pages, page_size, kv_dtype).items()}


# ----------------------------------------------------------------------
# prefill -> pages
# ----------------------------------------------------------------------

def _page_rows(kv, table, ps):
    """kv (L, B', S, KV, Dh) -> (L, B'*J, ps, KV, Dh) pages, S padded up
    to a page multiple with zeros (the pad scrubs stale bytes from a
    reused page), and the (B'*J,) physical ids they go to."""
    L, Bp, S = kv.shape[:3]
    pad = (-S) % ps
    if pad:
        kv = torch.cat([kv, kv.new_zeros((L, Bp, pad, *kv.shape[3:]))], 2)
    J = kv.shape[2] // ps
    ids = torch.as_tensor(table, device=kv.device)[:, :J].reshape(-1).long()
    return kv.reshape(L, Bp * J, ps, *kv.shape[3:]), ids


def _scatter_pages(pool, kv, table):
    """pool (L, n_pages, ps, ...) <- kv (L, B', S, ...) at the pages of
    ``table`` (B', max_pages), in place."""
    rows, ids = _page_rows(kv, table, pool.shape[2])
    pool[:, ids] = rows.to(pool.dtype)


def _scatter_pages_q8(pool, scales, kv, table):
    """Quantize-on-write prefill scatter into an int8 pool and its
    (L, n_pages, KV) scales, in place: one symmetric int8 scale per
    (page, KV head) over the page's (page_size, Dh) values; the zero
    pad of a partial last page stays inside the group, so it scrubs
    stale bytes and leaves the amax alone."""
    rows, ids = _page_rows(kv, table, pool.shape[2])
    q, s = quantize_int8(rows, axis=(2, 4))     # s: (L, B'*J, 1, KV, 1)
    pool[:, ids] = q
    scales[:, ids] = s[:, :, 0, :, 0]


def quantized_page_write(pool, scales, pages, offs, x):
    """One decode token per active slot into one layer's int8 pool
    (n_pages, ps, KV, Dh) and scales (n_pages, KV), in place.

    pages, offs: (A,) physical page and offset of each active slot's
    write (inactive slots are left out by the caller, where the JAX
    function sends them to page ``n_pages`` and drops the write);
    x: (A, KV, Dh) the new token's values.

    A write at offset 0 resets the page's scale to the token's own amax
    and zeroes the rest of the page (the scrub of a reused page); a
    later write takes ``max(s_old, s_tok)`` and requantizes the page's
    resident rows onto the new grid before inserting the token, so a
    page's scale only grows while it fills."""
    A = x.shape[0]
    if A == 0:
        return
    xf = x.float()
    s_tok = int8_scale(xf.abs().amax(-1))                   # (A, KV)
    s_old = scales[pages]
    fresh = (offs == 0)[:, None]
    s_new = torch.where(fresh, s_tok, torch.maximum(s_old, s_tok))
    page_f = pool[pages].float() * s_old[:, None, :, None]
    page_f = torch.where(fresh[:, :, None, None], 0.0, page_f)
    qpage = torch.clamp(torch.round(page_f / s_new[:, None, :, None]),
                        -127, 127).to(torch.int8)
    qtok = torch.clamp(torch.round(xf / s_new[..., None]),
                       -127, 127).to(torch.int8)
    qpage[torch.arange(A, device=x.device), offs] = qtok
    pool[pages] = qpage
    scales[pages] = s_new


def write_prefill(cfg, cache, caches, table) -> None:
    """Scatter prefill KV material into the page pools, in place.

    ``caches`` is ``lm.prefill``'s (k, v) stacks (L, B', S, KV, Dh) for
    B' requests (the whole batch, or 1 for the scheduler's admission);
    ``table`` holds their block-table rows (B', max_pages), host ints."""
    check_family(cfg)
    for name, kv in zip(("k", "v"), caches):
        if name + "_scale" in cache:
            _scatter_pages_q8(cache[name], cache[name + "_scale"], kv,
                              table)
        else:
            _scatter_pages(cache[name], kv, table)


def fork_page(cfg, cache, src, dst):
    """Copy-on-write page fork of the prefix cache: not ported yet."""
    raise NotImplementedError(
        "fork_page (prefix-cache copy-on-write) is not ported to "
        "repro_torch yet: ROADMAP queue 1 item 7")


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
    holds a ref, no free page does)."""

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
