"""The port's host-side paged KV allocator against the JAX package's.

``repro_torch.kv`` is a copy of ``repro.kv.paged`` (numpy only). The same
seeded random sequence of admissions, forks, appends (with CoW),
extensions and releases drives both allocators; after every op their free
lists, refcounts, block lists and returned CoW pairs must be identical,
and both must pass their own invariant checks.
"""
import numpy as np
import pytest

from repro.kv import OutOfPagesError as JOutOfPages
from repro.kv import PageAllocator as JAlloc
from repro.kv import tree_decode_map as j_tree_map
from repro_torch.kv import BranchBlocks, OutOfPagesError, PageAllocator
from repro_torch.kv import tree_decode_map


def _state(alloc, live):
    return (list(alloc._free), dict(alloc._refs), alloc.free_pages,
            alloc.used_pages,
            [(list(b.pages), b.num_shared, b.length) for b in live])


def _step(alloc, live, oop, action, pick, size):
    """One op on one allocator; returns its observable result."""
    try:
        if action == 0:
            live.append(alloc.alloc_prefix(size))
            return "alloc"
        if not live:
            return "idle"
        b = live[pick % len(live)]
        if action == 1:
            live.append(alloc.fork(b))
            return "fork"
        if action == 2:
            return ("append", alloc.append_token(b))
        if action == 3:
            return ("extend", alloc.extend(b, b.length + size))
        if action == 4:
            return ("cow", alloc.needs_cow(b),
                    alloc.cow_last_page(b) if alloc.needs_cow(b) else None)
        alloc.release(b)
        live.remove(b)
        return "release"
    except oop:
        return "out_of_pages"


@pytest.mark.parametrize("seed", range(8))
def test_random_ops_match_reference_allocator(seed):
    """Identical state after every op of a 300-op random interleaving."""
    rng = np.random.default_rng(seed)
    page_size = int(rng.integers(1, 9))
    num_pages = int(rng.integers(4, 65))
    port, ref = PageAllocator(num_pages, page_size), JAlloc(num_pages,
                                                            page_size)
    live_p, live_r = [], []
    for _ in range(300):
        action = int(rng.integers(0, 6))
        pick = int(rng.integers(0, 1000))
        size = int(rng.integers(1, 3 * page_size + 1))
        got = _step(port, live_p, OutOfPagesError, action, pick, size)
        want = _step(ref, live_r, JOutOfPages, action, pick, size)
        assert got == want
        assert _state(port, live_p) == _state(ref, live_r)
        port.check_invariants()
    for b in live_p:
        port.release(b)
    assert port.used_pages == 0


@pytest.mark.parametrize("seed", range(4))
def test_tree_decode_map_matches_reference(seed):
    """The fork-group dedup map (copied for the tree-decode slice) builds
    the same four arrays from the same fork topology."""
    rng = np.random.default_rng(100 + seed)
    ps, width, num_pages = 4, 8, 64
    alloc = PageAllocator(num_pages, ps)
    roots = [alloc.alloc_prefix(int(rng.integers(1, 12))) for _ in range(2)]
    slots = []
    for _ in range(6):
        b = alloc.fork(roots[int(rng.integers(0, 2))])
        for _ in range(int(rng.integers(0, 9))):
            alloc.append_token(b)
        slots.append(b)
    slots.append(None)
    got = tree_decode_map(slots, pages_per_branch=width, num_pages=num_pages,
                          page_size=ps)
    want = j_tree_map(slots, pages_per_branch=width, num_pages=num_pages,
                      page_size=ps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_extend_is_all_or_nothing():
    """An extension the pool cannot cover raises and allocates nothing."""
    alloc = PageAllocator(4, 4)
    b = alloc.alloc_prefix(6)
    before = (list(alloc._free), dict(alloc._refs))
    with pytest.raises(OutOfPagesError):
        alloc.extend(b, 40)
    assert (list(alloc._free), dict(alloc._refs)) == before
    assert b.length == 6 and len(b.pages) == 2
    assert isinstance(b, BranchBlocks)
