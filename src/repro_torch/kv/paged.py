"""Paged KV cache with ref-counted prefix sharing.

This is SART's memory substrate (paper §4, last paragraph): all N branches of
a request share the prompt-prefix KV pages; a branch's own generated pages
are private. Pages are released *eagerly* when a branch is pruned,
early-stopped, or completed; the shared prefix pages are released when the
last sibling terminates. This eager release is what lets the scheduler batch
more requests (the paper's queuing-delay reduction).

Layout (TPU-friendly, consumed by ``repro_torch.kernels.paged_attention``):
  k_pages, v_pages: [num_layers, kv_heads, num_pages, page_size, head_dim]

The allocator itself is plain Python (it runs on the host between jit'd decode
steps, exactly like vLLM's block manager runs on the CPU between CUDA steps).

Public contracts (documented in docs/architecture.md, which deep-links
here):

  * **Refcount conservation**: every page is either free or has refcount
    >= 1, never both, and the two sets partition the pool —
    ``check_invariants`` asserts it; ``tests/test_kv_properties.py``
    drives random op interleavings against it.
  * **All-or-nothing reservation**: ``extend`` (and ``alloc_prefix`` built
    on it) either allocates every page the growth needs or raises
    ``OutOfPagesError`` having allocated none, so callers never roll back
    partial state.
  * **Fork shares, append copies**: ``fork`` increfs all parent pages
    (including a trailing partial page); writers must ``cow_last_page``
    (or let ``append_token`` do it) before writing into a shared partial
    page. Release is eager and idempotent on an emptied block list.
  * **Decref-to-LRU vs decref-to-free**: with a ``PrefixCache`` attached
    (``attach_cache``), a cache-tracked page whose refcount drops to 0 is
    parked on the cache's LRU free-list — K/V resident, resurrectable on
    hash hit — instead of the free list; releasing a ``BranchBlocks``
    holding shared prefix pages therefore never recycles (and lets the
    engine overwrite) pages the cache still references. The partition
    invariant becomes live + free + LRU == all pages, and ``free_pages``
    counts LRU pages as reclaimable because ``alloc`` evicts them under
    pressure.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, types only
    from .prefix_cache import PrefixCache


class OutOfPagesError(RuntimeError):
    """Raised when an allocation cannot be covered by free + evictable
    pages. Acquiring paths must leave refcounts unchanged when it
    propagates (the all-or-nothing contract; reprolint REP002)."""


@dataclasses.dataclass
class BranchBlocks:
    """Block table for one branch: shared prefix pages + private pages."""
    pages: List[int]              # all pages, in sequence order
    num_shared: int               # leading pages that are ref-shared
    length: int = 0               # valid tokens

    def copy(self) -> "BranchBlocks":
        """Shallow copy: a new page list, the same page ids. Refcounts are
        untouched — use ``PageAllocator.fork`` to share pages."""
        return BranchBlocks(list(self.pages), self.num_shared, self.length)


class PageAllocator:
    """Ref-counted page allocator (host-side)."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._cache: Optional["PrefixCache"] = None

    def attach_cache(self, cache: "PrefixCache") -> None:
        """Attach a ``PrefixCache`` (called by its constructor): decrefs
        of tracked pages park on the cache's LRU free-list, and ``alloc``
        evicts from it when the true free list runs dry."""
        assert self._cache is None, "allocator already has a prefix cache"
        self._cache = cache

    # ----------------------------------------------------------- primitives
    @property
    def free_pages(self) -> int:
        """Pages an allocation can draw on: the free list plus the prefix
        cache's refcount-0 LRU pages, which ``alloc`` evicts on demand."""
        return len(self._free) + \
            (self._cache.evictable if self._cache is not None else 0)

    @property
    def used_pages(self) -> int:
        """Pages referenced by live block tables (cached-idle LRU pages
        are warm *free* capacity, not usage — a drained system reports 0
        even while the cache keeps pages resident)."""
        return self.num_pages - self.free_pages

    def alloc(self) -> int:
        """Take one fresh page at refcount 1, evicting a cache-idle LRU
        page if the free list is dry. Raises ``OutOfPagesError`` (state
        unchanged) when neither source can supply a page."""
        if not self._free:
            if self._cache is not None and self._cache.evictable:
                self._cache.evict_one()    # LRU page -> self._free
            else:
                raise OutOfPagesError("KV pool exhausted")
        pid = self._free.pop()
        self._refs[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        """Add one reference to a *live* page (KeyError on a dead one —
        sharing can only extend lifetimes, never revive; reviving a cached
        refcount-0 page is ``resurrect``'s job)."""
        self._refs[pid] += 1

    def decref(self, pid: int) -> None:
        """Drop one reference; at zero the page leaves the live set — to
        the prefix cache's LRU list if the cache tracks it (K/V stay
        resident for resurrection), else to the free list."""
        self._refs[pid] -= 1
        assert self._refs[pid] >= 0, f"page {pid} double-free"
        if self._refs[pid] == 0:
            del self._refs[pid]
            # decref-to-LRU vs decref-to-free: a cache-tracked page keeps
            # its K/V resident for resurrection; recycling it through the
            # free list would let the next allocation overwrite state the
            # cache still maps
            if self._cache is not None and self._cache.retain(pid):
                return
            self._free.append(pid)

    def resurrect(self, pid: int) -> None:
        """Revive a refcount-0 cached page off the cache's LRU list (hash
        hit): it re-enters the live set with one reference, K/V intact —
        the zero-recompute, zero-rewrite path warm admission hits. (No
        free-list membership assert here: that would be an O(num_pages)
        scan on the warm path; ``check_invariants`` covers the partition.)
        """
        assert pid not in self._refs, f"page {pid} already live"
        self._refs[pid] = 1

    def reclaim(self, pid: int) -> None:
        """Return an unreferenced cache-evicted page to the free list
        (the write half of the cache's eviction valve — symmetric with
        ``resurrect``, so the free list is only ever grown through
        allocator methods that can assert the page is dead)."""
        assert pid not in self._refs, f"page {pid} still referenced"
        self._free.append(pid)

    def refcount(self, pid: int) -> int:
        """Current reference count; 0 for free and cached-idle pages."""
        return self._refs.get(pid, 0)

    # ------------------------------------------------------- branch helpers
    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` (ceiling division)."""
        return -(-num_tokens // self.page_size)

    def alloc_prefix(self, num_tokens: int) -> BranchBlocks:
        """Allocate pages for a freshly prefilled prompt."""
        b = BranchBlocks(pages=[], num_shared=0, length=0)
        self.extend(b, max(num_tokens, 1))
        b.length = num_tokens
        return b

    def extend(self, b: BranchBlocks, new_length: int) -> List[int]:
        """Grow a branch's page list to cover ``new_length`` tokens,
        appending fresh (refcount-1) pages only. ``alloc_prefix`` is built
        on this; chunked prefill reserves a prompt's pages in one extend at
        admission (fail-fast, so an OutOfPagesError leaves nothing to roll
        back). All-or-nothing: raises OutOfPagesError without allocating
        anything if the pool cannot cover the growth; returns the new page
        ids. Like ``append_token``, it does NOT CoW a shared trailing
        partial page — callers writing into one must ``cow_last_page``
        first.
        """
        assert new_length >= b.length, "extend cannot shrink a branch"
        n = self.pages_for(new_length) - len(b.pages)
        if n > self.free_pages:
            raise OutOfPagesError(f"need {n} pages, {self.free_pages} free")
        new: List[int] = []
        try:
            for _ in range(max(n, 0)):
                new.append(self.alloc())
        except OutOfPagesError:
            # all-or-nothing structurally, not just via the pre-check:
            # return the pages already taken before re-raising
            for pid in reversed(new):
                self.decref(pid)
            raise
        b.pages.extend(new)
        b.length = new_length
        return new

    def fork(self, parent: BranchBlocks) -> BranchBlocks:
        """Fork a branch off `parent`, sharing all its pages.

        All parent pages (including a trailing partial page) become shared;
        the engine performs copy-on-write when a branch needs to append into
        a shared partial page (see ``needs_cow``).

        The fork adds exactly one reference per page for the child. A
        parent page that idled onto the prefix cache's LRU list (its
        holder released while this ``BranchBlocks`` — e.g. a ``copy`` kept
        by the scheduler — still names it) is revived off the LRU at
        refcount 1 rather than incref'd: incref only extends live
        lifetimes and would KeyError on the parked page.
        """
        # fork only increfs pages that are live by precondition (the parent
        # branch references them), and incref cannot raise OutOfPagesError
        # — the loop has no partial-failure mode to roll back
        for pid in parent.pages:
            if (pid not in self._refs and self._cache is not None
                    and self._cache.revive(pid)):
                continue                   # child holds the single new ref
            self.incref(pid)  # reprolint: disable=REP002
        return BranchBlocks(pages=list(parent.pages),
                            num_shared=len(parent.pages),
                            length=parent.length)

    def needs_cow(self, b: BranchBlocks) -> bool:
        """True if appending one token would write into a shared page."""
        if b.length % self.page_size == 0:
            return False  # next token opens a fresh page
        last_idx = len(b.pages) - 1
        return last_idx < b.num_shared and self.refcount(b.pages[last_idx]) > 1

    def cow_last_page(self, b: BranchBlocks) -> Tuple[int, int]:
        """Copy-on-write the trailing shared partial page.

        Returns (old_pid, new_pid) so the engine can copy device data.
        """
        old = b.pages[-1]
        new = self.alloc()
        self.decref(old)
        b.pages[-1] = new
        b.num_shared = len(b.pages) - 1
        return old, new

    def append_token(self, b: BranchBlocks) -> Optional[Tuple[int, int]]:
        """Account for one more token; allocates a page on boundary.

        Returns (old_pid, new_pid) if a CoW copy is required, else None.
        The caller must perform the device copy before the next decode step.
        """
        cow = None
        if self.needs_cow(b):
            cow = self.cow_last_page(b)
        if b.length % self.page_size == 0:
            if b.length // self.page_size == len(b.pages):
                b.pages.append(self.alloc())
        b.length += 1
        return cow

    def release(self, b: BranchBlocks) -> None:
        """Eagerly release a terminated branch's pages (shared pages only
        drop a reference; freed once all siblings terminate). Pages are
        decref'd leaf-first so cache-tracked chains idle onto the LRU list
        deepest-page-first — eviction then reclaims leaves before their
        parents and keeps surviving chains walkable."""
        for pid in reversed(b.pages):
            self.decref(pid)
        b.pages = []
        b.length = 0
        b.num_shared = 0

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        """Assert the pool partition: live + free + cached-idle LRU pages
        cover every page exactly once, and all refcounts are positive.
        O(num_pages); tests call it after every mutation."""
        live = set(self._refs)
        free = set(self._free)
        lru = set(self._cache.lru_pages) if self._cache is not None else set()
        assert not (live & free), "page both live and free"
        assert not (live & lru), "page both live and cached-idle"
        assert not (free & lru), "page both free and cached-idle"
        assert len(free) == len(self._free), "duplicate free pages"
        assert live | free | lru == set(range(self.num_pages)), "page leak"
        assert all(r > 0 for r in self._refs.values())
        if self._cache is not None:
            self._cache.check_invariants()


def tree_decode_map(
    blocks: Sequence[Optional[BranchBlocks]],
    *,
    pages_per_branch: int,
    num_pages: int,
    page_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build the branch×page dedup map the tree-decode attention kernel
    consumes (``repro_torch.kernels.paged_attention.ops.paged_tree_attention``,
    kernel K3) from the slots' fork topology.

    Rows sharing their first page id form a fork group (page ids are
    refcount-shared on fork, so a common ``pages[0]`` — whether from
    ``fork`` or from cross-request prefix-cache admission — means
    physically identical leading KV); the group's shared span is the raw
    longest common page-id prefix across its members. Spans are whole
    pages by construction (page lists diverge at CoW/alloc boundaries
    after per-step accounting), and the kernel's per-row attend mask
    (``kpos < min(length, span)``) keeps a row whose context ends inside
    the span from reading past its own written extent.

    Returns ``(row_group, shared_bt, shared_lens, branch_bt)`` —
    ``row_group`` [B] int32 mapping each row to its group (``B`` = the
    ungrouped sentinel: singletons, empty slots, page-less rows keep
    their full table in ``branch_bt``); ``shared_bt`` [B,
    pages_per_branch] int32 per-group shared page tables; ``shared_lens``
    [B] int32 shared token spans; ``branch_bt`` [B, pages_per_branch]
    int32 post-fork suffix tables. Unused entries hold the ``num_pages``
    OOB sentinel (tables) / 0 (spans); the group axis is padded to B so
    the map's shapes are static per engine config.
    """
    b = len(blocks)
    row_group = np.full((b,), b, np.int32)
    shared_bt = np.full((b, pages_per_branch), num_pages, np.int32)
    shared_lens = np.zeros((b,), np.int32)
    branch_bt = np.full((b, pages_per_branch), num_pages, np.int32)
    groups: Dict[int, List[int]] = {}
    for i, blk in enumerate(blocks):
        if blk is not None and blk.pages:
            groups.setdefault(blk.pages[0], []).append(i)
    gid = 0
    for members in groups.values():
        if len(members) < 2:
            continue
        lists = [blocks[i].pages for i in members]  # type: ignore[union-attr]
        depth = 0
        for cols in zip(*lists):
            if len(set(cols)) != 1:
                break
            depth += 1
        shared_bt[gid, :depth] = lists[0][:depth]
        shared_lens[gid] = depth * page_size
        for i, pages in zip(members, lists):
            row_group[i] = gid
            suffix = pages[depth:]
            branch_bt[i, :len(suffix)] = suffix
        gid += 1
    for i, blk in enumerate(blocks):
        if row_group[i] == b and blk is not None and blk.pages:
            branch_bt[i, :len(blk.pages)] = blk.pages
    return row_group, shared_bt, shared_lens, branch_bt
