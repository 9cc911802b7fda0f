"""The port's tree-decode attention (kernel K3) against the JAX package's.

The same numpy inputs, made from a seed, go through the port's plain
version (``repro_torch.kernels.paged_attention.ops.paged_tree_attention``
on CPU tensors), the JAX plain version (``ref.paged_tree_attention_ref``)
and the JAX Pallas pair run in interpret mode, over the fork topologies
of ``tests/test_kernels.py``. Tolerances (fp32): 1e-5 against the JAX
plain version (the same gather-and-softmax in two frameworks), 2e-4
against the Pallas pair (its online softmax sums in another order; the
reference's own tests use the same bound); 5e-2 for bf16 pages. Within
the port, the tree plain version is bit-equal to the per-branch plain
version (K1's) over the rebuilt tables. The bf16 shared pass's split
partials, in their plain version, fold back to the whole-span partials
within 1e-6 (fp32). The CUDA pair itself runs only on a card (tests
marked ``gpu``, skipped here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import \
    paged_tree_attention as j_tree_kernel
from repro.kernels.paged_attention.ops import \
    tree_decode_bytes_read as j_tree_bytes
from repro.kernels.paged_attention.ref import \
    paged_tree_attention_ref as j_tree_ref
from repro.kernels.paged_attention.tree_decode import \
    paged_tree_attention_fwd as j_tree_pallas
from repro_torch.kernels.paged_attention import tree_decode
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_tree_attention,
                                                     tree_decode_bytes_read)
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF, decode_splits, tree_branch_merge_ref, tree_branch_split_ref,
    tree_full_tables, tree_merge_splits_ref, tree_shared_partials_ref,
    tree_shared_split_partials_ref)

TOL_REF = dict(atol=1e-5, rtol=1e-5)
TOL_MERGE = dict(atol=1e-6, rtol=1e-6)
TOL_PALLAS = dict(atol=2e-4, rtol=0)
TOL_BF16 = dict(atol=5e-2, rtol=0)


def _topology(seed, groups, singles, *, qh=4, kvh=2, hd=32, ps=4):
    """A fork topology and every table the paths take, as numpy arrays
    (a copy of ``tests/test_kernels.py:_tree_topology``'s layout).
    ``groups``: (shared pages, [row lengths]) per fork group; ``singles``:
    lengths of rows in no group. Page ids are distinct; tables are
    sentinel-padded with one spare column; two live pages no row owns."""
    rng = np.random.default_rng(seed)
    next_page = 0

    def take(n):
        nonlocal next_page
        next_page += n
        return list(range(next_page - n, next_page))

    rows, shared_of = [], []
    for gi, (ns, lens) in enumerate(groups):
        sp = take(ns)
        shared_of.append(sp)
        for n in lens:
            rows.append((gi, sp + take(-(-max(n - ns * ps, 0) // ps)), n))
    rows += [(None, take(-(-n // ps)), n) for n in singles]
    b = len(rows)
    num_pages = next_page + 2
    width = max(len(r[1]) for r in rows) + 1
    full_bt = np.full((b, width), num_pages, np.int32)
    shared_bt = np.full((b, width), num_pages, np.int32)
    shared_lens = np.zeros((b,), np.int32)
    branch_bt = np.full((b, width), num_pages, np.int32)
    row_group = np.full((b,), b, np.int32)
    for i, (gi, pages, _n) in enumerate(rows):
        full_bt[i, :len(pages)] = pages
        if gi is None:
            branch_bt[i, :len(pages)] = pages
            continue
        row_group[i] = gi
        sp = shared_of[gi]
        shared_bt[gi, :len(sp)] = sp
        shared_lens[gi] = len(sp) * ps
        branch_bt[i, :len(pages) - len(sp)] = pages[len(sp):]
    f32 = np.float32
    return dict(
        q=rng.normal(size=(b, qh, hd)).astype(f32),
        kp=rng.normal(size=(kvh, num_pages, ps, hd)).astype(f32),
        vp=rng.normal(size=(kvh, num_pages, ps, hd)).astype(f32),
        row_group=row_group, shared_bt=shared_bt, shared_lens=shared_lens,
        branch_bt=branch_bt, full_bt=full_bt,
        lengths=np.asarray([r[2] for r in rows], np.int32),
        rows=rows, shared_of=shared_of, num_pages=num_pages)


_MAP = ("row_group", "shared_bt", "shared_lens", "branch_bt", "lengths")


def _port(t, kp=None, vp=None, dtype=torch.float32):
    kp = t["kp"] if kp is None else kp
    vp = t["vp"] if vp is None else vp
    return paged_tree_attention(
        torch.from_numpy(t["q"]).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype),
        *(torch.from_numpy(t[k]) for k in _MAP), _span(t))


def _span(t):
    """The longest group span, the host int the engine passes."""
    return int(t["shared_lens"].max(initial=0))


def _jax_args(t, kp=None, vp=None, dtype=jnp.float32):
    kp = t["kp"] if kp is None else kp
    vp = t["vp"] if vp is None else vp
    return (jnp.asarray(t["q"], dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), *(jnp.asarray(t[k]) for k in _MAP))


# the topologies of tests/test_kernels.py:446-550 (all lengths >= 1, where
# the JAX plain version and its Pallas pair agree)
TOPOLOGIES = {
    "mixed_gqa": (dict(qh=4, kvh=2),
                  [(2, [2 * 4 + 5, 2 * 4 + 1, 2 * 4 + 9]), (1, [4 + 3, 4 + 4])],
                  [7]),
    "mixed_mqa": (dict(qh=4, kvh=1),
                  [(2, [2 * 4 + 5, 2 * 4 + 1, 2 * 4 + 9]), (1, [4 + 3, 4 + 4])],
                  [7]),
    "mixed_mha": (dict(qh=4, kvh=4),
                  [(2, [2 * 4 + 5, 2 * 4 + 1, 2 * 4 + 9]), (1, [4 + 3, 4 + 4])],
                  [7]),
    # shared depths 1..3 pages; one row ends inside its group's span
    "ragged_depths": ({}, [(3, [3 * 4 + 2, 2 * 4 + 1]),
                           (2, [2 * 4 + 4, 2 * 4 + 7]),
                           (1, [4 + 1, 4 + 2, 4 + 3])], []),
    # fork on a page boundary vs mid-page (the straddled page is private)
    "boundary_fork": ({}, [(2, [8 + 1, 8 + 2])], []),
    "mid_page_fork": ({}, [(1, [4 + 6, 4 + 8])], []),
    # a 1-member group, and a batch in no group at all
    "one_member_group": ({}, [(2, [2 * 4 + 3])], [9, 5]),
    "all_ungrouped": ({}, [], [13, 6, 2]),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_plain_matches_jax_ref_and_pallas(name):
    """The port's plain tree version against the JAX plain version and
    the Pallas pair (interpret mode) on every topology."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(11, groups, singles, **shape)
    got = _port(t).numpy()
    args = _jax_args(t)
    np.testing.assert_allclose(got, np.asarray(j_tree_ref(*args)), **TOL_REF)
    np.testing.assert_allclose(got, np.asarray(j_tree_kernel(*args)),
                               **TOL_PALLAS)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_plain_tree_is_bit_equal_to_per_branch(name):
    """Within the port: the map's tables rebuild the full ones, and the
    tree plain version equals K1's plain version over them, bit for
    bit."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(12, groups, singles, **shape)
    rg, sbt, sl, bbt, _ = (torch.from_numpy(t[k]) for k in _MAP)
    assert torch.equal(tree_full_tables(rg, sbt, sl, bbt, t["kp"].shape[2]),
                       torch.from_numpy(t["full_bt"]))
    per_branch = paged_attention(
        torch.from_numpy(t["q"]), torch.from_numpy(t["kp"]),
        torch.from_numpy(t["vp"]), torch.from_numpy(t["full_bt"]),
        torch.from_numpy(t["lengths"]))
    assert torch.equal(_port(t), per_branch)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_pass_plain_versions_compose_to_the_tree(name):
    """The plain versions of the two passes (the yardsticks of the two
    CUDA kernels) compose to the tree plain version within 1e-5; rows in
    no group get empty shared partials."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(13, groups, singles, **shape)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    m, l, acc = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl, ln)
    free = rg >= rg.shape[0]
    assert bool((m[free] == NEG_INF).all() and (l[free] == 0).all()
                and (acc[free] == 0).all())
    # garbage in the unwritten partials of ungrouped rows is never read
    m[free], l[free], acc[free] = float("nan"), float("nan"), float("nan")
    out = tree_branch_merge_ref(q, kp, vp, rg, sl, bbt, ln, m, l, acc)
    torch.testing.assert_close(out, _port(t), **TOL_REF)


def _split_partials(t, pages_per_split, n_split=None):
    """The plain split partials of topology ``t`` with splits of
    ``pages_per_split`` pages, as many as cover the table width unless
    ``n_split`` is given (the last split takes the rest)."""
    ps, width = t["kp"].shape[2], t["shared_bt"].shape[1]
    n_split = n_split or -(-width // pages_per_split)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, _, ln = (torch.from_numpy(t[k]) for k in _MAP)
    return tree_shared_split_partials_ref(q, kp, vp, rg, sbt, sl, ln,
                                          pages_per_split * ps, n_split)


@pytest.mark.parametrize("pages_per_split", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_merged_split_partials_equal_the_shared_partials(name,
                                                         pages_per_split):
    """The bf16 shared pass's contract on the CPU: split partials of 1, 2
    or 4 pages (spans of 1-3 pages, so also spans that are not a whole
    number of splits), folded by ``tree_merge_splits_ref``, equal the
    whole-span partials within 1e-6 (fp32); a split past a row's end holds
    exactly (NEG_INF, 0, 0)."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(21, groups, singles, **shape)
    m, l, acc = _split_partials(t, pages_per_split)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, _, ln = (torch.from_numpy(t[k]) for k in _MAP)
    want = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl, ln)
    for got, ref in zip(tree_merge_splits_ref(m, l, acc), want):
        torch.testing.assert_close(got, ref, **TOL_MERGE)
    ps = t["kp"].shape[2]
    grp = rg.long().clamp(0, sl.shape[0] - 1)
    span = torch.where(rg < sl.shape[0], sl.long()[grp], 0)
    end = torch.minimum(ln.long(), span)
    for z in range(m.shape[0]):
        empty = end <= z * pages_per_split * ps
        assert bool((m[z][empty] == NEG_INF).all()
                    and (l[z][empty] == 0).all()
                    and (acc[z][empty] == 0).all())


@pytest.mark.parametrize("n_split", [1, 2])
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_last_split_takes_the_rest_of_the_span(name, n_split):
    """Splits of one page but only 1 or 2 of them (a host span that
    understates the groups' spans): the last split holds every key from
    its start, so the fold still equals the whole-span partials."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(25, groups, singles, **shape)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, _, ln = (torch.from_numpy(t[k]) for k in _MAP)
    want = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl, ln)
    got = tree_merge_splits_ref(*_split_partials(t, 1, n_split))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL_MERGE)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_merged_splits_and_branch_match_pallas(name):
    """The plain split partials (2-page splits), folded and merged with
    each row's suffix by ``tree_branch_merge_ref``, equal the JAX Pallas
    pair run in interpret mode."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(22, groups, singles, **shape)
    merged = tree_merge_splits_ref(*_split_partials(t, 2))
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, _, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    got = tree_branch_merge_ref(q, kp, vp, rg, sl, bbt, ln, *merged)
    pallas = np.asarray(j_tree_pallas(*_jax_args(t), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL_PALLAS)


# topologies for the branch pass's key splits: suffixes across 32-key
# tiles and 128-key splits, a row at the table's capacity (the spare
# sentinel column dropped), rows of length 0 and 1, one ending inside its
# group's span
SPLIT_TOPOLOGIES = {
    "group5_long_suffixes": (dict(qh=10, kvh=2, hd=32, ps=4),
                             [(3, [3 * 4 + 132, 3 * 4 + 1, 3 * 4 + 64, 5])],
                             [140, 0, 1]),
    "mqa_capacity": (dict(qh=4, kvh=1, hd=64, ps=16),
                     [(2, [32 + 200, 32 + 17])], [256, 1, 0]),
    "group7_two_groups": (dict(qh=14, kvh=2, hd=64, ps=8),
                          [(4, [32 + 97, 32 + 33, 32]), (1, [8 + 63])],
                          [31]),
    # past 1,024 keys: suffixes across 2 of the rule's splits (CTA
    # clusters on a card), an ungrouped row at the capacity
    "group7_two_splits": (dict(qh=14, kvh=2, hd=64, ps=16),
                          [(2, [32 + 1100, 32 + 500, 20])], [1200, 0]),
}


def _split_topology(name, seed, poison=False):
    """A SPLIT_TOPOLOGIES topology without its spare table column; with
    ``poison`` NaN in every page no row owns and in every slot past a
    row's end in the pages only that row reads."""
    shape, groups, singles = SPLIT_TOPOLOGIES[name]
    t = _topology(seed, groups, singles, **shape)
    for k in ("shared_bt", "branch_bt", "full_bt"):
        t[k] = np.ascontiguousarray(t[k][:, :-1])
    if poison:
        ps = t["kp"].shape[2]
        kp, vp = t["kp"].copy(), t["vp"].copy()
        kp[:, -2:], vp[:, -2:] = np.nan, np.nan
        for gi, pages, n in t["rows"]:
            private = (pages[len(t["shared_of"][gi]):] if gi is not None
                       else pages)
            if private and n % ps:
                kp[:, private[-1], n % ps:] = np.nan
                vp[:, private[-1], n % ps:] = np.nan
        t["kp"], t["vp"] = kp, vp
    return t


@pytest.mark.parametrize("split", ["rule", "32-key"])
@pytest.mark.parametrize("name", sorted(SPLIT_TOPOLOGIES))
def test_branch_split_merge_matches_plain_and_pallas(name, split):
    """The plain model of the bf16 branch pass (the suffix's per-warp
    partials of each key split, merged behind the shared pass's split
    partials in the fixed order) equals ``tree_branch_merge_ref`` over the
    folded splits and the plain tree version within 1e-5, and the JAX
    Pallas pair in interpret mode within 2e-4 (fp32), at the split rule's
    layout and at 32-key splits; NaN in stale and unowned pages, sentinel
    entries, lengths 0, 1 and the capacity included; length-0 rows are
    exact zeros."""
    t = _split_topology(name, 31, poison=True)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    ps, width = kp.shape[2], bbt.shape[1]
    assert int(ln.max()) == ps * width or name not in (
        "mqa_capacity", "group7_two_splits")
    shared = tree_shared_split_partials_ref(
        q, kp, vp, rg, sbt, sl, ln, *tree_decode.shared_splits(
            ps, width, torch.bfloat16, _span(t)))
    keys, n = (decode_splits(ps, width, torch.bfloat16) if split == "rule"
               else (32, -(-ps * width // 32)))
    got = tree_branch_split_ref(q, kp, vp, rg, sl, bbt, ln, *shared, keys, n)
    assert bool(torch.isfinite(got).all())
    assert (got[ln == 0] == 0).all()
    torch.testing.assert_close(got, tree_branch_merge_ref(
        q, kp, vp, rg, sl, bbt, ln, *tree_merge_splits_ref(*shared)),
        **TOL_REF)
    clean = _split_topology(name, 31)
    torch.testing.assert_close(got, _port(clean), **TOL_REF)
    pallas = np.asarray(j_tree_pallas(*_jax_args(clean), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL_PALLAS)


def test_branch_split_merge_skips_the_partials_of_rows_in_no_group():
    """The branch pass's model reads no shared partial of a row in no
    group: NaN there changes no bit of the output."""
    t = _split_topology("group5_long_suffixes", 32)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    ps, width = kp.shape[2], bbt.shape[1]
    shared = tree_shared_split_partials_ref(
        q, kp, vp, rg, sbt, sl, ln, *tree_decode.shared_splits(
            ps, width, torch.bfloat16, _span(t)))
    keys, n = decode_splits(ps, width, torch.bfloat16)
    base = tree_branch_split_ref(q, kp, vp, rg, sl, bbt, ln, *shared, keys, n)
    free = rg >= sl.shape[0]
    junk = [x.clone() for x in shared]
    for x in junk:
        x[:, free] = float("nan")
    got = tree_branch_split_ref(q, kp, vp, rg, sl, bbt, ln, *junk, keys, n)
    assert bool(free.any()) and torch.equal(got, base)


@pytest.mark.parametrize("span", [0, 16, 100, 256, 4096, 10 ** 6])
@pytest.mark.parametrize("page_size,width", [(16, 32), (16, 5), (4, 3),
                                             (4, 40), (16, 256), (64, 7),
                                             (1, 100)])
def test_shared_splits_cover_every_key_once(page_size, width, span):
    """The launcher's split rule: bf16 splits are whole pages of at least
    32 keys, at most 16 of them, covering the host span (the table when
    None, never more than it); with the last split taking every key from
    its start, each key of the table lies in exactly one split. fp32
    takes one split."""
    cap = page_size * width
    cover = min(span, cap)
    keys, n_split = tree_decode.shared_splits(page_size, width,
                                              torch.bfloat16, span)
    assert keys % page_size == 0 and keys >= 32
    assert 1 <= n_split <= tree_decode.MAX_SPLITS
    assert (n_split - 1) * keys < max(cover, 1) and \
        cover <= -(-cover // page_size) * page_size <= n_split * keys
    owner = [min(p // keys, n_split - 1) for p in range(cap)]
    assert owner == sorted(owner) and set(owner) <= set(range(n_split))
    assert tree_decode.shared_splits(page_size, width, torch.float32,
                                     span) == (cap, 1)


def test_shared_splits_give_the_serve_shape_128_working_ctas():
    """At the tree serve's shape (16-token pages, 32-page tables, a
    256-token span the engine passes) the bf16 split is 32 keys, 8 of
    them, every one with keys: 2 groups x 8 KV heads x 8 = 128 CTAs.
    A span of the whole table takes 16 splits of 512 keys."""
    assert tree_decode.shared_splits(16, 32, torch.bfloat16, 256) == (32, 8)
    assert tree_decode.shared_splits(16, 32, torch.bfloat16, 512) == \
        (32, 16)
    assert 2 * 8 * 8 == 128


def test_unpack_partials_views_the_packed_rows():
    """The shared pass's packed partials [n_split, B, H, hd + 2] hold each
    row's acc, then m, then l; ``unpack_partials`` gives the three as
    views in the ``tree_merge_splits_ref`` shapes, and the fold of packed
    plain split partials equals the whole-span partials."""
    t = _topology(26, [(2, [2 * 4 + 5, 2 * 4 + 1])], [6])
    m, l, acc = _split_partials(t, 1)
    packed = torch.cat([acc, m[..., None], l[..., None]], -1)
    got = tree_decode.unpack_partials(packed)
    for g, w in zip(got, (m, l, acc)):
        assert g.shape == w.shape and torch.equal(g, w)
        assert g.untyped_storage().data_ptr() == \
            packed.untyped_storage().data_ptr()          # a view, no copy
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, _, ln = (torch.from_numpy(t[k]) for k in _MAP)
    want = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl, ln)
    for g, w in zip(tree_merge_splits_ref(*got), want):
        torch.testing.assert_close(g, w, **TOL_MERGE)


def test_unowned_pages_never_reach_a_row():
    """Poisoning one branch's suffix pages and the pages no row owns (the
    clamp target included) leaves every other row unchanged: bitwise in
    the port with NaN, and in the JAX Pallas pair with 1e4 (its own test's
    poison), where the two also agree."""
    t = _topology(14, [(2, [2 * 4 + 5, 2 * 4 + 6, 2 * 4 + 2])], [7])
    victim = 1
    own = set(t["rows"][victim][1]) - set(t["shared_of"][0])
    poison = sorted(own | {t["num_pages"] - 2, t["num_pages"] - 1})
    rows = [i for i in range(len(t["rows"])) if i != victim]
    base = _port(t)
    for value in (float("nan"), 1e4):
        kp, vp = t["kp"].copy(), t["vp"].copy()
        kp[:, poison], vp[:, poison] = value, value
        pert = _port(t, kp, vp)
        assert torch.equal(base[rows], pert[rows])
        if value == 1e4:
            jax_out = np.asarray(j_tree_kernel(*_jax_args(t, kp, vp)))
            np.testing.assert_allclose(pert[rows].numpy(), jax_out[rows],
                                       **TOL_PALLAS)


def test_stale_slots_past_each_end_are_ignored():
    """NaN in every slot past each row's end (in the pages only that row
    reads) never reaches an output."""
    t = _topology(15, [(2, [2 * 4 + 3, 2 * 4 + 6])], [5, 9])
    ps = t["kp"].shape[2]
    kp, vp = t["kp"].copy(), t["vp"].copy()
    for gi, pages, n in t["rows"]:
        private = pages[len(t["shared_of"][gi]):] if gi is not None else pages
        if private and n % ps:
            kp[:, private[-1], n % ps:] = np.nan
            vp[:, private[-1], n % ps:] = np.nan
    out = _port(t, kp, vp)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, _port(t), atol=0, rtol=0)


def test_bf16_pages_match_jax():
    """bf16 q and pages: the port's plain version keeps bf16 and agrees
    with the Pallas pair in bf16 and with the fp32 JAX plain version."""
    t = _topology(16, [(2, [2 * 4 + 3, 2 * 4 + 6])], [5])
    got = _port(t, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_tree_kernel(*_jax_args(t, dtype=jnp.bfloat16)),
                        np.float32), **TOL_BF16)
    np.testing.assert_allclose(got, np.asarray(j_tree_ref(*_jax_args(t))),
                               **TOL_BF16)


def test_length_zero_rows_are_exact_zeros():
    """A row of length 0, in a group or alone, gives exact zeros, as the
    Pallas pair does (the JAX plain version differs there by design)."""
    t = _topology(17, [(2, [2 * 4 + 3, 0])], [0, 6])
    got = _port(t).numpy()
    assert not got[1].any() and not got[2].any()
    np.testing.assert_allclose(got, np.asarray(j_tree_kernel(*_jax_args(t))),
                               **TOL_PALLAS)


@pytest.mark.parametrize("path", ["tree", "branch"])
def test_tree_decode_bytes_read_is_the_reference_formula(path):
    """The copied byte model gives the reference's numbers."""
    for shared, branches, itemsize in ((16, [1, 3, 6], 2), (0, [4], 4),
                                       (5, [], 2)):
        args = (shared, branches, 16, 8, 128)
        assert tree_decode_bytes_read(*args, path=path, itemsize=itemsize) \
            == j_tree_bytes(*args, path=path, itemsize=itemsize)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA pair raises on CPU tensors instead of running anything
    (the branch pass given split partials of the right shape)."""
    t = _topology(18, [(1, [4 + 2, 4 + 3])], [])
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    with pytest.raises(ValueError, match="CUDA"):
        tree_decode.paged_tree_attention_fwd(q, kp, vp, rg, sbt, sl, bbt, ln,
                                             _span(t))
    with pytest.raises(ValueError, match="CUDA"):
        tree_decode.paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln,
            torch.zeros((1, *q.shape[:2], q.shape[2] + 2)), 4)
    assert tree_decode.shared_launches == tree_decode.branch_launches == 0


@pytest.mark.parametrize("case", ["no split axis", "wrong n_split",
                                  "acc width", "dtype", "split width"])
def test_branch_refuses_split_partials_of_the_wrong_shape(case):
    """The branch pass takes only the shared pass's packed split partials
    (fp32 [n_split, B, H, hd + 2], one split in fp32, at most 16 in bf16)
    and a positive split width, and refuses anything else before it looks
    at a device."""
    t = _topology(23, [(1, [4 + 2, 4 + 3])], [])
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, _, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    keys, n = tree_decode.shared_splits(kp.shape[2], bbt.shape[1], q.dtype,
                                        _span(t))
    part = torch.zeros((n, *q.shape[:2], q.shape[2] + 2))
    part, keys = {"no split axis": (part[0], keys),
                  "wrong n_split": (part.repeat(2, 1, 1, 1), keys),
                  "acc width": (part[..., :-1], keys),
                  "dtype": (part.double(), keys),
                  "split width": (part, 0)}[case]
    with pytest.raises(ValueError, match="split partials|split_keys"):
        tree_decode.paged_tree_branch_fwd(q, kp, vp, rg, sl, bbt, ln, part,
                                          keys)
    assert tree_decode.branch_launches == 0


def test_cuda_pair_refuses_head_dim_256():
    """head_dim 256 (gemma-7b) is refused by both passes, before any
    launch."""
    t = _topology(24, [(1, [4 + 2, 4 + 3])], [], hd=256)
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    with pytest.raises(ValueError, match="head_dim 256"):
        tree_decode.paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln,
                                          _span(t))
    with pytest.raises(ValueError, match="head_dim 256"):
        tree_decode.paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln,
            torch.zeros((1, *q.shape[:2], q.shape[2] + 2)),
            kp.shape[2] * bbt.shape[1])
    assert tree_decode.shared_launches == tree_decode.branch_launches == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA pair has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# on the card also: a group of 13 members at 5 heads per KV head, one more
# than a CTA's 64 // 5 = 12, so its second member slice runs
CARD_TOPOLOGIES = dict(TOPOLOGIES, thirteen_members=(
    dict(qh=10, kvh=2), [(2, [2 * 4 + 1 + i for i in range(13)])], [5]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", sorted(CARD_TOPOLOGIES))
def test_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    """Both passes on the card against the plain version, with NaN in
    every page no row owns."""
    shape, groups, singles = CARD_TOPOLOGIES[name]
    t = _topology(19, groups, singles, **shape)
    kp, vp = t["kp"].copy(), t["vp"].copy()
    kp[:, -2:], vp[:, -2:] = np.nan, np.nan
    args = [torch.from_numpy(a).to(cuda, dtype) for a in (t["q"], kp, vp)]
    args += [torch.from_numpy(t[k]).to(cuda) for k in _MAP]
    out = tree_decode.paged_tree_attention_fwd(*args, _span(t))
    ref = paged_tree_attention(*(a.cpu() for a in args), _span(t))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), ref, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", sorted(SPLIT_TOPOLOGIES))
def test_branch_kernel_splits_match_plain_on_card(cuda, name, dtype, tol):
    """Both passes on the card where suffixes span several of the branch
    pass's key splits (its cluster merge), with NaN in stale and unowned
    pages; length-0 rows are exact zeros."""
    t = _split_topology(name, 33, poison=True)
    args = [torch.from_numpy(t[k]).to(cuda, dtype) for k in ("q", "kp", "vp")]
    args += [torch.from_numpy(t[k]).to(cuda) for k in _MAP]
    out = tree_decode.paged_tree_attention_fwd(*args, _span(t))
    ref = paged_tree_attention(*(a.cpu() for a in args), _span(t))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), ref, atol=tol, rtol=tol)
    assert (out[args[-1] == 0] == 0).all()
