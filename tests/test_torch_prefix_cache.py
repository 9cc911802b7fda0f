"""The port's radix prefix cache against the JAX package's.

``repro_torch.kv.prefix_cache`` is a copy of ``repro.kv.prefix_cache``
(plain Python). The property tests of ``tests/test_kv_properties.py``
that concern the cache rerun here against the port's ``PrefixCache`` and
``PageAllocator``: random interleavings under colliding hashes keep the
live + free + LRU partition, eviction is LRU and under pressure only,
collisions degrade to misses, a failure mid-loop rolls back, and parked
tail pages revive on fork. A seeded op-by-op run then drives the port's
allocator+cache and the reference's side by side: every op returns the
same result and leaves the same free list, refcounts, LRU order and
counters.
"""
import numpy as np
import pytest

from prop import given, settings, st
from repro.kv import OutOfPagesError as JOutOfPages
from repro.kv import PageAllocator as JAlloc
from repro.kv import PrefixCache as JCache
from repro_torch.kv import (BranchBlocks, OutOfPagesError, PageAllocator,
                            PrefixCache, default_page_hash, tree_decode_map)


def _refcount_conservation(alloc, live_blocks):
    """Every page's refcount equals the number of live BranchBlocks that
    list it."""
    held = {}
    for b in live_blocks:
        for pid in b.pages:
            held[pid] = held.get(pid, 0) + 1
    for pid, n in held.items():
        assert alloc.refcount(pid) == n, f"page {pid}: refs != holders"
    assert alloc.used_pages == len(held)


# degraded hash functions inject collisions: the cache must verify tokens
# + parent identity, so collisions degrade to misses, never wrong pages
_HASH_FNS = (default_page_hash,
             lambda p, t: default_page_hash(p, t) % 13,
             lambda p, t: 7)


def _admit_through_cache(cache, prompt):
    """The engine's admission dance, then the insert a completed prefill
    makes."""
    b, _ = cache.admit(prompt)
    cache.insert(prompt, b.pages)
    return b


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(6, 48), st.integers(0, 2),
       st.lists(st.integers(0, 100_000), min_size=1, max_size=80))
def test_prefix_cache_interleavings_conserve_pages(page_size, num_pages,
                                                   degrade, ops):
    """Random admit / fork / append / release / evict / bare-acquire
    sequences, under colliding hashes too, keep the partition and
    refcount conservation; draining everything empties the pool."""
    alloc = PageAllocator(num_pages, page_size)
    cache = PrefixCache(alloc, hash_fn=_HASH_FNS[degrade])
    live = []
    for op in ops:
        action = op % 6
        pick = (op // 6) % max(len(live), 1)
        size = op % (4 * page_size) + 1
        prompt = [(op // 24) % 3] * size
        try:
            if action == 0:
                live.append(_admit_through_cache(cache, prompt))
            elif action == 1 and live:
                live.append(alloc.fork(live[pick]))
            elif action == 2 and live:
                alloc.append_token(live[pick])
            elif action == 3 and live:
                alloc.release(live.pop(pick))
            elif action == 4 and cache.evictable:
                cache.evict_one()
            elif action == 5:
                pages, _ = cache.acquire(prompt)
                for pid in reversed(pages):
                    alloc.decref(pid)
        except OutOfPagesError:
            pass
        alloc.check_invariants()
        _refcount_conservation(alloc, live)
    for b in live:
        alloc.release(b)
    alloc.check_invariants()
    assert alloc.used_pages == 0
    cache.drop()
    alloc.check_invariants()
    assert cache.evictable == 0 and len(alloc._free) == num_pages


def test_release_shared_prefix_decrefs_to_lru_not_free():
    """Releasing cache-tracked prefix pages parks them on the LRU list,
    not the free list; the untracked partial tail frees; a hit resurrects
    the parked pages at refcount 1; nothing referenced is ever evicted."""
    alloc = PageAllocator(8, 2)
    cache = PrefixCache(alloc)
    prompt = [1, 2, 3, 4, 5]
    b = _admit_through_cache(cache, prompt)
    tracked = list(b.pages[:2])
    free_before = len(alloc._free)
    alloc.release(b)
    assert cache.evictable == 2
    assert sorted(cache.lru_pages) == sorted(tracked)
    assert len(alloc._free) == free_before + 1
    assert not set(tracked) & set(alloc._free)
    alloc.check_invariants()
    held = [alloc.alloc() for _ in range(len(alloc._free))]
    assert not set(held) & set(tracked)
    assert cache.evictable == 2
    pages, _ = cache.acquire(prompt)
    assert pages == tracked
    assert all(alloc.refcount(p) == 1 for p in pages)
    assert cache.evictable == 0
    alloc.check_invariants()
    with pytest.raises(OutOfPagesError):
        for _ in range(alloc.num_pages):
            alloc.alloc()


def test_prefix_cache_eviction_is_lru_and_pressure_only():
    """Idle cached pages go oldest-idled first, and only once the free
    list is dry."""
    alloc = PageAllocator(6, 2)
    cache = PrefixCache(alloc)
    b1 = _admit_through_cache(cache, [1, 1, 1, 1])
    b2 = _admit_through_cache(cache, [2, 2])
    alloc.release(b1)
    alloc.release(b2)
    assert cache.evictable == 3 and alloc.free_pages == 6
    blocks = alloc.alloc_prefix(3 * 2)
    assert cache.evictable == 3 and cache.stats()["evictions"] == 0
    alloc.extend(blocks, 4 * 2)
    assert cache.evictable == 2 and cache.stats()["evictions"] == 1
    alloc.check_invariants()
    pages, _ = cache.acquire([2, 2, 9])
    assert len(pages) == 1
    alloc.release(blocks)
    for pid in reversed(pages):
        alloc.decref(pid)
    alloc.check_invariants()
    assert alloc.used_pages == 0


def test_prefix_cache_collisions_never_alias():
    """Under a constant hash, lookups return only true token matches."""
    alloc = PageAllocator(16, 2)
    cache = PrefixCache(alloc, hash_fn=lambda p, t: 7)
    b1 = _admit_through_cache(cache, [1, 2, 3, 4])
    b2 = _admit_through_cache(cache, [5, 6, 7, 8])
    pages, _ = cache.acquire([5, 6, 9, 9, 9])
    assert pages == [b2.pages[0]] and pages != [b1.pages[0]]
    for pid in pages:
        alloc.decref(pid)
    pages, _ = cache.acquire([9, 9, 9, 9, 9])
    assert pages == []
    alloc.release(b1)
    alloc.release(b2)
    alloc.check_invariants()
    assert alloc.used_pages == 0


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 6), st.integers(1, 20), st.integers(1, 6))
def test_fork_release_any_order_frees_everything(page_size, tokens, forks):
    """Whatever order siblings and the prefix release in, the pool
    drains."""
    alloc = PageAllocator(256, page_size)
    prefix = alloc.alloc_prefix(tokens)
    branches = [alloc.fork(prefix) for _ in range(forks)]
    for i, b in enumerate(branches):
        for _ in range(i):
            alloc.append_token(b)
    for b in branches[1::2] + [prefix] + branches[0::2]:
        alloc.release(b)
        alloc.check_invariants()
    assert alloc.used_pages == 0


def test_extend_rolls_back_when_alloc_fails_mid_loop(monkeypatch):
    """A failure of alloc mid-way through extend returns the pages taken
    so far, and the branch stays usable."""
    alloc = PageAllocator(16, 2)
    b = alloc.alloc_prefix(4)
    real_alloc = PageAllocator.alloc
    calls = {"n": 0}

    def flaky_alloc(self):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OutOfPagesError("injected mid-loop failure")
        return real_alloc(self)

    monkeypatch.setattr(PageAllocator, "alloc", flaky_alloc)
    with pytest.raises(OutOfPagesError):
        alloc.extend(b, 12)
    monkeypatch.undo()
    assert alloc.used_pages == 2
    assert b.length == 4 and len(b.pages) == 2
    alloc.check_invariants()
    _refcount_conservation(alloc, [b])
    alloc.extend(b, 12)
    assert len(b.pages) == 6
    alloc.check_invariants()


def test_prefix_cache_acquire_rolls_back_on_mid_loop_failure(monkeypatch):
    """A failure part-way through acquire gives back the references taken
    (re-idling resurrected pages), and the cache still serves after."""
    alloc = PageAllocator(32, 2)
    cache = PrefixCache(alloc)
    prompt = list(range(10))
    b, _ = cache.admit(prompt)
    cache.insert(prompt, b.pages)
    alloc.release(b)
    assert cache.evictable == 5
    real_incref = PageAllocator.incref
    real_resurrect = PageAllocator.resurrect
    calls = {"n": 0}

    def count():
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected mid-acquire failure")

    def flaky_incref(self, pid):
        count()
        real_incref(self, pid)

    def flaky_resurrect(self, pid):
        count()
        real_resurrect(self, pid)

    monkeypatch.setattr(PageAllocator, "incref", flaky_incref)
    monkeypatch.setattr(PageAllocator, "resurrect", flaky_resurrect)
    with pytest.raises(RuntimeError, match="mid-acquire"):
        cache.acquire(prompt)
    monkeypatch.undo()
    assert alloc.used_pages == 0
    assert cache.evictable == 5
    alloc.check_invariants()
    pages, _ = cache.acquire(prompt)
    assert len(pages) == 4
    assert all(alloc.refcount(pid) == 1 for pid in pages)
    alloc.check_invariants()


def test_fork_parked_prefix_tail_page_revives():
    """Forking off a held copy whose pages idled onto the LRU revives
    them: the child holds the single new reference."""
    alloc = PageAllocator(8, 2)
    cache = PrefixCache(alloc)
    b = _admit_through_cache(cache, [1, 2, 3, 4])
    held = b.copy()
    alloc.release(b)
    assert cache.evictable == 2
    assert all(alloc.refcount(p) == 0 for p in held.pages)
    child = alloc.fork(held)
    assert child.pages == held.pages
    assert all(alloc.refcount(p) == 1 for p in child.pages)
    assert cache.evictable == 0
    alloc.check_invariants()
    alloc.release(child)
    assert cache.evictable == 2
    alloc.check_invariants()
    cache.drop()
    assert alloc.used_pages == 0


def test_fork_mixed_live_and_parked_prefix_pages():
    """One new reference per page: incref for live pages, revive for
    parked ones."""
    alloc = PageAllocator(16, 2)
    cache = PrefixCache(alloc)
    b = _admit_through_cache(cache, [1, 2, 3, 4, 5, 6])
    sibling = alloc.fork(b)
    held = b.copy()
    alloc.release(b)
    assert all(alloc.refcount(p) == 1 for p in held.pages)
    assert cache.evictable == 0
    child = alloc.fork(held)
    assert all(alloc.refcount(p) == 2 for p in child.pages)
    alloc.release(sibling)
    alloc.release(child)
    assert cache.evictable == 3
    child2 = alloc.fork(held)
    assert all(alloc.refcount(p) == 1 for p in child2.pages)
    assert cache.evictable == 0
    alloc.check_invariants()
    alloc.release(child2)
    cache.drop()
    assert alloc.used_pages == 0


def test_generated_prefix_collisions_degrade_to_misses():
    """Two branches of one prompt generate different tokens under a
    constant hash: one's generated key never returns the other's pages."""
    alloc = PageAllocator(32, 2)
    cache = PrefixCache(alloc, hash_fn=lambda p, t: 7)
    prompt = [1, 2]
    a = _admit_through_cache(cache, prompt)
    bb = alloc.fork(a)
    gen_a, gen_b = [5, 6, 7, 8], [5, 9, 9, 9]
    for blocks, gen in ((a, gen_a), (bb, gen_b)):
        for _t in gen:
            alloc.append_token(blocks)
    cache.insert(prompt + gen_a, a.pages)
    cache.insert(prompt + gen_b, bb.pages)
    pages_a, _ = cache.acquire(prompt + gen_a + [0])
    assert pages_a == a.pages[:3] and pages_a[1:] != bb.pages[1:3]
    for pid in reversed(pages_a):
        alloc.decref(pid)
    pages_x, _ = cache.acquire(prompt + [5, 4, 4, 4, 0])
    assert pages_x == a.pages[:1]
    for pid in reversed(pages_x):
        alloc.decref(pid)
    alloc.release(a)
    alloc.release(bb)
    alloc.check_invariants()
    cache.drop()
    assert alloc.used_pages == 0


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(8, 48), st.integers(0, 2),
       st.lists(st.integers(0, 100_000), min_size=1, max_size=80))
def test_generated_prefix_tree_interleavings(page_size, num_pages, degrade,
                                             ops):
    """The decode-side lifecycle the tree-decoding engine runs (admit /
    fork / decode with boundary inserts / complete with insert / evict /
    bare acquire), at random and under colliding hashes, keeps the
    partition and refcounts at every step."""
    alloc = PageAllocator(num_pages, page_size)
    cache = PrefixCache(alloc, hash_fn=_HASH_FNS[degrade])
    live = []
    for op in ops:
        action = op % 7
        pick = (op // 7) % max(len(live), 1)
        size = op % (4 * page_size) + 1
        prompt = [(op // 24) % 3] * size
        try:
            if action == 0:
                b, _ = cache.admit(prompt)
                live.append((b, list(prompt)))
            elif action == 1 and live:
                b, tokens = live[pick]
                live.append((alloc.fork(b), list(tokens)))
            elif action == 2 and live:
                b, tokens = live[pick]
                alloc.append_token(b)
                tokens.append(op % 5)
                if b.length % page_size == 0:
                    cache.insert(tokens, b.pages)
            elif action == 3 and live:
                b, tokens = live.pop(pick)
                cache.insert(tokens, b.pages)
                alloc.release(b)
            elif action == 4 and cache.evictable:
                cache.evict_one()
            elif action == 5 and live:
                _b, tokens = live[pick]
                pages, _ = cache.acquire(tokens + [9])
                for pid in reversed(pages):
                    alloc.decref(pid)
            elif action == 6 and live:
                b, tokens = live[pick]
                alloc.extend(b, b.length + size)
                tokens.extend([op % 5] * size)
        except OutOfPagesError:
            pass
        for b, tokens in live:
            assert len(tokens) == b.length
        alloc.check_invariants()
        _refcount_conservation(alloc, [b for b, _t in live])
    for b, _tokens in live:
        alloc.release(b)
    alloc.check_invariants()
    assert alloc.used_pages == 0
    cache.drop()
    alloc.check_invariants()
    assert cache.evictable == 0 and len(alloc._free) == num_pages


def test_tree_decode_map_from_fork_topology():
    """Forked siblings sharing leading page ids form a group whose span is
    the longest common page prefix; singletons, empty slots and page-less
    rows keep their full table in ``branch_bt``."""
    ps, num_pages, ppb = 4, 32, 6
    sib_a = BranchBlocks(pages=[3, 7, 10], num_shared=2, length=2 * ps + 1)
    sib_b = BranchBlocks(pages=[3, 7, 11], num_shared=2, length=2 * ps + 2)
    sib_c = BranchBlocks(pages=[3, 7, 11, 12], num_shared=2,
                         length=3 * ps + 1)
    single = BranchBlocks(pages=[20, 21], num_shared=0, length=ps + 2)
    blocks = [sib_a, None, sib_b, single, sib_c]
    row_group, shared_bt, shared_lens, branch_bt = tree_decode_map(
        blocks, pages_per_branch=ppb, num_pages=num_pages, page_size=ps)
    b = len(blocks)
    gid = row_group[0]
    assert gid < b and row_group[2] == gid and row_group[4] == gid
    assert row_group[1] == b and row_group[3] == b
    assert shared_lens[gid] == 2 * ps
    assert list(shared_bt[gid][:2]) == [3, 7]
    assert all(shared_bt[gid][2:] == num_pages)
    assert list(branch_bt[0][:1]) == [10]
    assert list(branch_bt[2][:1]) == [11]
    assert list(branch_bt[4][:2]) == [11, 12]
    assert list(branch_bt[3][:2]) == [20, 21]
    assert all(branch_bt[1] == num_pages)
    np.testing.assert_array_equal(row_group[[0, 2, 4]], gid)


# ------------------------------------------------ op-by-op reference parity


def _cache_state(alloc, cache, live):
    return (list(alloc._free), dict(alloc._refs), list(cache.lru_pages),
            sorted(cache._by_page), cache.stats(),
            [(list(b.pages), b.num_shared, b.length) for b, _ in live])


def _cache_op(alloc, cache, live, oop, action, pick, size, tok):
    """One op on one allocator+cache pair; returns its observable
    result."""
    prompt = [tok % 3] * size
    try:
        if action == 0:
            b, _ = cache.admit(prompt)
            live.append((b, list(prompt)))
            return ("admit", b.num_shared)
        if action == 4:
            return ("evict", cache.evict_one() if cache.evictable else None)
        if action == 5:
            pages, _ = cache.acquire(prompt)
            for pid in reversed(pages):
                alloc.decref(pid)
            return ("acquire", pages)
        if action == 7:
            return ("match", cache.match_tokens(prompt))
        if not live:
            return "idle"
        i = pick % len(live)
        b, tokens = live[i]
        if action == 1:
            live.append((alloc.fork(b), list(tokens)))
            return "fork"
        if action == 2:
            cow = alloc.append_token(b)
            tokens.append(tok % 5)
            ins = (cache.insert(tokens, b.pages)
                   if b.length % alloc.page_size == 0 else None)
            return ("append", cow, ins)
        if action == 3:
            live.pop(i)
            ins = cache.insert(tokens, b.pages)
            alloc.release(b)
            return ("release", ins)
        alloc.extend(b, b.length + size)
        tokens.extend([tok % 5] * size)
        return "extend"
    except oop:
        return "out_of_pages"


@pytest.mark.parametrize("seed", range(6))
def test_random_ops_match_reference_cache(seed):
    """The port's allocator+cache and the reference's, driven by one seeded
    200-op sequence, return the same results and hold the same state
    (free list, refcounts, LRU order, tracked pages, counters, block
    lists) after every op."""
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(1, 5))
    num_pages = int(rng.integers(8, 40))
    port, ref = PageAllocator(num_pages, ps), JAlloc(num_pages, ps)
    pc, rc = PrefixCache(port), JCache(ref)
    live_p, live_r = [], []
    for _ in range(200):
        action = int(rng.integers(0, 8))
        pick = int(rng.integers(0, 1000))
        size = int(rng.integers(1, 4 * ps + 1))
        tok = int(rng.integers(0, 1000))
        got = _cache_op(port, pc, live_p, OutOfPagesError, action, pick,
                        size, tok)
        want = _cache_op(ref, rc, live_r, JOutOfPages, action, pick, size,
                         tok)
        assert got == want
        assert _cache_state(port, pc, live_p) == _cache_state(ref, rc,
                                                              live_r)
        port.check_invariants()
