"""Radix page-hash prompt prefix cache over the paged KV allocator (a
copy of ``repro.kv.prefix_cache``; plain Python, host side).

SART's redundant sampling already shares a request's prompt pages across
its N branches (``PageAllocator.fork``); this module extends the sharing
*across requests*: realistic reasoning workloads repeat long prompt
prefixes (few-shot math headers, shared system prompts), and recomputing
and re-storing those pages per request wastes exactly the admission FLOPs
chunked prefill made cheap and the HBM pages branch pruning frees.

Design (SGLang-style radix reuse, adapted to page granularity):

  * **Nodes are full pages.** The cache is a radix tree whose edges are
    ``page_size``-token chunks; a node owns exactly one KV page whose
    contents are the K/V of those tokens at those absolute positions.
    Only *page-aligned* prefixes are ever reused, so a hit needs no
    partial-page copies.
  * **Rolling hashes key the walk.** Each node is registered under
    ``hash_fn(parent_hash, page_tokens)``; lookup walks the prompt one
    page at a time through a flat hash→candidates dict. Candidates are
    verified against the stored tokens AND the parent node's identity, so
    hash collisions degrade to misses, never to wrong pages
    (``tests/test_torch_prefix_cache.py`` injects colliding ``hash_fn``s).
  * **Refcount-0 pages park on an LRU free-list.** The cache holds no
    refcount of its own: while any request/branch references a cached
    page it is simply a shared live page. When the last reference drops,
    ``PageAllocator.decref`` routes the page *here* instead of the free
    list (``retain``): its K/V stays resident, a later hash hit
    resurrects it at zero recompute/rewrite cost, and only allocation
    pressure (``evict_one``, called by ``PageAllocator.alloc`` when the
    true free list runs dry) actually frees it.
  * **SSM state gates reuse for ssm/hybrid.** Attention K/V is position-
    addressable, but the masked-dt chunked scan needs the running per-
    layer (conv, ssd) state *at the resume boundary*. Nodes optionally
    carry that state (snapshotted when a chunk boundary lands on a page
    boundary); ``acquire(need_state=True)`` truncates the match to the
    deepest node that has one, so dense configs reuse every matched page
    while ssm/hybrid reuse exactly as far as a seedable boundary exists.

Invariants (asserted by ``PageAllocator.check_invariants`` +
``check_invariants`` here, driven by random interleavings in
``tests/test_torch_prefix_cache.py``):

  * every cache-tracked page has refcount >= 1 or sits on the LRU
    free-list (never both, never the allocator's free list);
  * live + free + LRU partition the pool (conservation under
    admit/fork/release/evict interleavings);
  * evicting a node never frees a page a live branch still references
    (only refcount-0 LRU pages are eviction candidates).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import (Callable, Dict, KeysView, List, Optional, Sequence,
                    Tuple)

from .paged import BranchBlocks, OutOfPagesError, PageAllocator

# rolling-hash seed for the radix root (any constant works; the chain is
# (seed, page0) -> (h0, page1) -> ...)
_ROOT_HASH = 0x9E3779B9


def default_page_hash(parent_hash: int, tokens: tuple) -> int:
    """Rolling page hash: chain the parent's hash with this page's
    tokens. Pluggable (collisions are verified away by ``_match_child``,
    so a weak hash degrades to misses, never wrong pages)."""
    return hash((parent_hash, tokens))


@dataclasses.dataclass(eq=False)           # identity equality: two nodes can
class CacheNode:                           # legally share (hash, tokens)
    """One cached page: ``tokens`` at absolute positions
    ``[(depth-1)*ps, depth*ps)``, K/V resident in ``page_id``."""
    key: int                               # rolling hash at this node
    tokens: tuple                          # the page's page_size tokens
    page_id: int
    parent: Optional["CacheNode"]          # None = child of the root
    depth: int                             # pages from the root, 1-based
    ssm_state: object = None               # per-layer (conv, ssd) at this
    #                                        page boundary, or None


class PrefixCache:
    """Radix page-hash cache; attaches itself to a ``PageAllocator``."""

    def __init__(self, allocator: PageAllocator,
                 hash_fn: Callable[[int, tuple], int] = default_page_hash
                 ) -> None:
        self.allocator = allocator
        self.page_size = allocator.page_size
        self.hash_fn = hash_fn
        self._nodes: Dict[int, List[CacheNode]] = {}   # hash -> candidates
        self._by_page: Dict[int, CacheNode] = {}       # page id -> node
        # refcount-0 cached pages, oldest-idle first (the "LRU free-list")
        self._lru: "OrderedDict[int, CacheNode]" = OrderedDict()
        # counters (surfaced via stats() -> serve CLI / benchmarks)
        self.lookups = 0
        self.hits = 0                      # lookups matching >= 1 page
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.evictions = 0
        self.resurrections = 0
        allocator.attach_cache(self)

    # ------------------------------------------------------------- internals
    def _match_child(self, parent: Optional[CacheNode], h: int,
                     tokens: tuple) -> Optional[CacheNode]:
        """Resolve the next node of a walk, verifying tokens + parent
        identity so hash collisions never alias two prefixes."""
        for cand in self._nodes.get(h, ()):
            if cand.parent is parent and cand.tokens == tokens:
                return cand
        return None

    def _walk(self, prompt: Sequence[int],
              max_pages: int) -> List[CacheNode]:
        """Longest chain of cached nodes covering ``prompt``'s pages."""
        matched: List[CacheNode] = []
        h, node = _ROOT_HASH, None
        ps = self.page_size
        for i in range(max_pages):
            tokens = tuple(prompt[i * ps:(i + 1) * ps])
            h = self.hash_fn(h, tokens)
            node = self._match_child(node, h, tokens)
            if node is None:
                break
            matched.append(node)
        return matched

    # ------------------------------------------------------------ public API
    @property
    def evictable(self) -> int:
        """Pages reclaimable under allocation pressure (the LRU list)."""
        return len(self._lru)

    @property
    def tracked_pages(self) -> int:
        """Pages the radix tree currently maps (live + idle)."""
        return len(self._by_page)

    @property
    def lru_pages(self) -> "KeysView[int]":
        """Ids of refcount-0 cached pages, oldest-idled first (a live
        view — the allocator's partition check iterates it)."""
        return self._lru.keys()

    def match_tokens(self, prompt: Sequence[int],
                     need_state: bool = False) -> int:
        """Non-mutating probe: how many of ``prompt``'s leading tokens an
        ``acquire`` would serve from cache *right now*. Same match rule as
        ``acquire`` — page-aligned, capped so the last prompt token is
        always recomputed, truncated to a seedable SSM boundary when
        ``need_state`` — but takes **no** page references, leaves the LRU
        order untouched, and pollutes no hit/lookup counters. This is the
        lookup the LPM admission policy runs over every queued request
        each admission opportunity, so it must be observationally free."""
        matched = self._walk(prompt, max(0, (len(prompt) - 1))
                             // self.page_size)
        if need_state:
            while matched and matched[-1].ssm_state is None:
                matched.pop()
        return len(matched) * self.page_size

    def acquire(self, prompt: Sequence[int], need_state: bool = False
                ) -> Tuple[List[int], object]:
        """Look up the longest cached page-aligned prefix of ``prompt`` and
        take one reference on each matched page (resurrecting refcount-0
        pages off the LRU list).

        The match is capped at ``(len(prompt) - 1) // page_size`` pages so
        at least one prompt token is always recomputed — the admission
        path needs the last position's logits to sample the first branch
        token, and the recomputed tail then starts on a page boundary of
        an uncached page (no partial-page CoW at admission).

        ``need_state=True`` (ssm/hybrid) additionally truncates the match
        to the deepest node carrying an SSM boundary state — reuse without
        a seedable (conv, ssd) state would corrupt the recurrence.

        Returns ``(page_ids, ssm_state_or_None)``; the caller owns one
        reference per returned page and must decref them on failure paths
        (see ``Engine._new_chunked_state``).
        """
        self.lookups += 1
        self.lookup_tokens += len(prompt)
        matched = self._walk(prompt, max(0, (len(prompt) - 1))
                             // self.page_size)
        if need_state:
            while matched and matched[-1].ssm_state is None:
                matched.pop()
        taken: List[int] = []
        try:
            for node in matched:
                pid = node.page_id
                if self.allocator.refcount(pid) == 0:
                    # resurrect BEFORE the LRU pop: if it raises, the
                    # page is still parked (live/free/LRU partition
                    # intact) instead of stranded in neither set
                    self.allocator.resurrect(pid)
                    self._lru.pop(pid)
                    self.resurrections += 1
                else:
                    self.allocator.incref(pid)
                taken.append(pid)
        except Exception:
            # all-or-nothing like admit: give back the references already
            # taken (decref re-idles resurrected pages onto the LRU via
            # retain, so conservation holds) before propagating
            for pid in reversed(taken):
                self.allocator.decref(pid)
            raise
        if matched:
            self.hits += 1
            self.hit_tokens += len(matched) * self.page_size
        state = matched[-1].ssm_state if (need_state and matched) else None
        return [node.page_id for node in matched], state

    def admit(self, prompt: Sequence[int], need_state: bool = False
              ) -> Tuple[BranchBlocks, object]:
        """The engine's warm-admission dance: ``acquire`` the cached
        prefix, lead the block list with it (shared pages), and reserve
        the uncached tail
        all-or-nothing — rolling the acquired references back (leaf-first,
        re-idling them onto the LRU) if the tail allocation fails, so
        admission under pressure leaves no trace. Returns a
        ``BranchBlocks`` covering the whole prompt plus the boundary SSM
        state (or None); ``blocks.num_shared * page_size`` is the resume
        offset."""
        pages, state = self.acquire(prompt, need_state)
        b = BranchBlocks(pages=list(pages), num_shared=len(pages),
                         length=len(pages) * self.page_size)
        try:
            self.allocator.extend(b, max(len(prompt), 1))
        except OutOfPagesError:
            for pid in reversed(pages):
                self.allocator.decref(pid)
            raise
        b.length = len(prompt)
        return b, state

    def insert(self, prompt: Sequence[int], pages: Sequence[int],
               ssm_states: Optional[Dict[int, object]] = None) -> int:
        """Register a finished prefill's full pages as cache nodes.

        Walks the existing radix chain; pages whose (prefix, tokens) are
        already cached — e.g. the very pages ``acquire`` handed out, or a
        concurrent request that inserted first — are skipped (the
        request's own duplicate page simply stays untracked and frees
        normally). Only *full* pages are inserted: the trailing partial
        page keeps private CoW semantics. ``ssm_states`` maps page-aligned
        token boundaries to (conv, ssd) snapshots; they attach to the node
        at that depth so later ssm/hybrid lookups can resume there.
        Returns the number of newly tracked pages.
        """
        ps = self.page_size
        h, node = _ROOT_HASH, None
        new = 0
        for i in range(len(prompt) // ps):
            tokens = tuple(prompt[i * ps:(i + 1) * ps])
            h = self.hash_fn(h, tokens)
            nxt = self._match_child(node, h, tokens)
            if nxt is None:
                pid = pages[i]
                if pid in self._by_page:   # page already owned by another
                    break                  # chain — never alias it
                nxt = CacheNode(key=h, tokens=tokens, page_id=pid,
                                parent=node, depth=i + 1)
                self._nodes.setdefault(h, []).append(nxt)
                self._by_page[pid] = nxt
                new += 1
            if ssm_states and nxt.ssm_state is None:
                nxt.ssm_state = ssm_states.get((i + 1) * ps)
            node = nxt
        self.inserted_pages += new
        return new

    def revive(self, pid: int) -> bool:
        """Called by ``PageAllocator.fork`` when a parent page is parked
        on the LRU free-list (refcount 0, K/V resident): resurrect it so
        the fork's child holds the single new reference. Returns False
        for pages this cache has not parked — the allocator then treats
        the page as live and increfs (KeyError on a genuinely dead page,
        as before)."""
        if pid not in self._lru:
            return False
        # resurrect BEFORE the LRU pop, mirroring ``acquire``
        self.allocator.resurrect(pid)
        self._lru.pop(pid)
        self.resurrections += 1
        return True

    def retain(self, pid: int) -> bool:
        """Called by ``PageAllocator.decref`` when a page's refcount hits
        0: park tracked pages on the LRU free-list (K/V stays resident for
        resurrection) instead of freeing them. Returns False for untracked
        pages, which free normally."""
        node = self._by_page.get(pid)
        if node is None:
            return False
        self._lru[pid] = node              # most-recently idled at the end
        return True

    def evict_one(self) -> int:
        """Reclaim the least-recently-idled refcount-0 page for the
        allocator (called under ``OutOfPagesError`` pressure only). The
        node is unregistered; its descendants become unreachable orphans
        (the walk verifies parent identity) and drain off the LRU in
        turn. Returns the freed page id."""
        if not self._lru:
            raise KeyError("prefix cache has no evictable pages")
        pid, node = self._lru.popitem(last=False)
        self._nodes[node.key].remove(node)
        if not self._nodes[node.key]:
            del self._nodes[node.key]
        del self._by_page[pid]
        # drop the device-state snapshot and the parent link: orphaned
        # descendants still referencing this node must not pin its
        # (conv, ssd) arrays (or a chain of evicted ancestors) in memory
        node.ssm_state = None
        node.parent = None
        self.allocator.reclaim(pid)
        self.evictions += 1
        return pid

    def drop(self) -> None:
        """Evict every idle page (testing / explicit cache reset)."""
        while self._lru:
            self.evict_one()

    # ------------------------------------------------------------ diagnostics
    def stats(self) -> Dict[str, float]:
        """Counter snapshot for the serve CLI and benchmarks: lookups,
        hits, token-weighted hit rate, insert/evict/resurrect totals, and
        current tracked/LRU page counts."""
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": (self.hit_tokens / self.lookup_tokens
                         if self.lookup_tokens else 0.0),
            "inserted_pages": self.inserted_pages,
            "tracked_pages": len(self._by_page),
            "lru_pages": len(self._lru),
            "evictions": self.evictions,
            "resurrections": self.resurrections,
        }

    def check_invariants(self) -> None:
        """Cache half of the conservation contract (the allocator asserts
        the live/free/LRU partition): every tracked page has refcount >= 1
        or sits on the LRU free-list; every LRU page is tracked; node
        registration is consistent."""
        for pid, node in self._by_page.items():
            assert node.page_id == pid
            assert node in self._nodes.get(node.key, ()), \
                f"page {pid}: node missing from hash bucket"
            assert self.allocator.refcount(pid) >= 1 or pid in self._lru, \
                f"cached page {pid} neither referenced nor on the LRU list"
        for pid in self._lru:
            assert pid in self._by_page, f"LRU page {pid} untracked"
            assert self.allocator.refcount(pid) == 0, \
                f"LRU page {pid} still referenced"
