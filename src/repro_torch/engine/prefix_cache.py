"""Prefix-sharing radix cache over the page pool.

Counterpart of ``repro.engine.prefix_cache`` (a copy: the port imports
nothing of ``repro``).  Serving traffic sends many requests that share
a few system prompts; the cache turns that reuse into pages that are
already resident: a radix trie over prompt token ids whose nodes own
refcounted physical pages.  Block tables already make page aliasing
free at the kernel level, so a hit is just table contents: admission
aliases the matched page ids into the slot's row and prefills only the
suffix.

Granularity is the page.  A trie node is one ``page_size``-token key
owning exactly one physical page of KV; only WHOLE pages are shared —
a prompt's partial tail page is always private (the suffix prefill
fills it and it is never inserted), so the scheduler's own decode path
never writes a shared page.  The allocator-level copy-on-write fork
(``paged_cache.fork_page``) still guards the invariant.

Matching is capped at ``len(tokens) - 1`` tokens so the suffix is never
empty: the first generated token comes from the prefill logits, so at
least the last prompt token runs through the (suffix) prefill.

Ownership (the refcount partition the tests pin):

  * the trie holds ONE allocator ref per node, taken at ``insert``;
  * a slot holds one ref per page in its block-table row (``alloc`` for
    private pages, ``incref`` of the matched pages at admission);
  * ``evict`` only releases nodes whose page has no other holder
    (refcount 1, trie only), LRU-first over leaves, cascading upward
    as children disappear — eviction never drops a page a live slot
    still reads.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.paged_cache import PageAllocator


class _Node:
    """One whole-page trie node: ``key`` is the page's page_size-token
    tuple, ``page`` the physical page id it owns (one trie ref)."""
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Radix index over prompt token ids, page-granular.

    The cache does not own device memory — it owns *refs* on pages of
    the scheduler's pool through the shared ``PageAllocator``.  All
    state is host-side; the device only ever sees block tables that
    happen to alias the same page ids."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = int(page_size)
        self.allocator = allocator
        self._root = _Node((), None, None)
        self._clock = 0
        self._n_nodes = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "insertions": 0, "evictions": 0}

    # ------------------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        """Pages currently held (one per node)."""
        return self._n_nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens: Sequence[int], n_pages: int):
        ps = self.page_size
        toks = [int(t) for t in tokens]
        for j in range(n_pages):
            yield tuple(toks[j * ps:(j + 1) * ps])

    # ------------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached whole-page prefix of ``tokens``.

        Returns the matched physical page ids in prefix order (possibly
        empty).  The match is capped at ``len(tokens) - 1`` tokens so at
        least one suffix token always remains to prefill (its logits
        produce the first generated token).  The caller must ``incref``
        the returned pages before relying on them — a bare match holds
        nothing.
        """
        cap = max(0, (len(tokens) - 1) // self.page_size)
        node = self._root
        pages: List[int] = []
        t = self._tick()
        for key in self._keys(tokens, cap):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = t
            pages.append(child.page)
            node = child
        if pages:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(pages) * self.page_size
        else:
            self.stats["misses"] += 1
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index the whole pages of ``tokens``, whose KV lives in
        ``pages`` (the owning slot's block-table row, prefix order).

        Each NEW node takes one allocator ref on its page; a node that
        already exists keeps its canonical page (the caller's duplicate
        stays the slot's private copy — dedup never rewrites tables).
        Returns the number of nodes created."""
        n_whole = len(tokens) // self.page_size
        if n_whole > len(pages):
            raise ValueError(
                f"insert of {n_whole} whole pages but only "
                f"{len(pages)} page ids supplied")
        node = self._root
        t = self._tick()
        created = 0
        for j, key in enumerate(self._keys(tokens, n_whole)):
            child = node.children.get(key)
            if child is None:
                page = int(pages[j])
                self.allocator.incref([page])
                child = _Node(key, page, node)
                node.children[key] = child
                self._n_nodes += 1
                created += 1
                self.stats["insertions"] += 1
            child.last_used = t
            node = child
        return created

    # ------------------------------------------------------------------

    def _evictable_leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif self.allocator.refcount(nd.page) == 1:
                out.append(nd)
        return out

    def evict(self, n: int) -> int:
        """Release up to ``n`` pages back to the pool, LRU-first over
        leaves whose page has no holder besides the trie (refcount 1).
        Dropping a leaf may expose its parent as the next candidate
        (cascading), so eviction frees arbitrarily deep cold branches.
        Returns the number of pages actually freed — 0 means every
        cached page is still pinned by a live slot."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            self.allocator.decref([victim.page])
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            freed += 1
            self.stats["evictions"] += 1
        return freed

    def clear(self) -> int:
        """Drop every node (decref all held pages).  Returns the number
        of pages released to refcount 0."""
        released = 0
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if self.allocator.refcount(nd.page) == 1:
                released += 1
            self.allocator.decref([nd.page])
            self._n_nodes -= 1
        self._root.children = {}
        return released

    # ------------------------------------------------------------------

    def to_state(self) -> Dict[str, Any]:
        """JSON-serializable trie snapshot: nodes in parent-before-
        child order, each carrying its page_size-token key, physical
        page id, LRU stamp and parent index (-1 = root), plus the LRU
        clock and counters.  Page *refs* are NOT part of this state —
        the trie's one-ref-per-node ownership lives in the allocator,
        whose partition is snapshotted separately."""
        nodes: List[Dict[str, Any]] = []
        stack: List[Tuple[_Node, int]] = [
            (c, -1) for c in self._root.children.values()]
        while stack:
            nd, pidx = stack.pop()
            nodes.append({"key": [int(t) for t in nd.key],
                          "page": int(nd.page),
                          "last_used": int(nd.last_used),
                          "parent": pidx})
            idx = len(nodes) - 1
            stack.extend((c, idx) for c in nd.children.values())
        return {"nodes": nodes, "clock": int(self._clock),
                "stats": dict(self.stats)}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Rebuild the trie from a ``to_state`` snapshot WITHOUT
        touching the allocator (the restored allocator partition
        already carries the trie's refs — increfing again would leak
        every cached page)."""
        self._root = _Node((), None, None)
        built: List[_Node] = []
        for rec in state["nodes"]:
            parent = (self._root if rec["parent"] < 0
                      else built[rec["parent"]])
            node = _Node(tuple(int(t) for t in rec["key"]),
                         int(rec["page"]), parent)
            node.last_used = int(rec["last_used"])
            parent.children[node.key] = node
            built.append(node)
        self._n_nodes = len(built)
        self._clock = int(state["clock"])
        self.stats.update(state.get("stats", {}))
        self.check()

    def check(self) -> bool:
        """Structural invariants: node count matches the tree, every
        node's page is handed out with refcount >= 1 (the trie's own
        ref must be live).  Raises ``ValueError`` on violation."""
        seen = 0
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            seen += 1
            stack.extend(nd.children.values())
            if len(nd.key) != self.page_size:
                raise ValueError(
                    f"node key width {len(nd.key)} != page_size "
                    f"{self.page_size}")
            if self.allocator.refcount(nd.page) < 1:
                raise ValueError(
                    f"trie node holds page {nd.page} with refcount "
                    f"{self.allocator.refcount(nd.page)}")
        if seen != self._n_nodes:
            raise ValueError(f"node count drift: walked {seen}, "
                             f"tracked {self._n_nodes}")
        return True
