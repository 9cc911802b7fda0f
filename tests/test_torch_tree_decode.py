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
version (K1's) over the rebuilt tables. The CUDA pair itself runs only
on a card (tests marked ``gpu``, skipped here).
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
from repro_torch.kernels.paged_attention import tree_decode
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_tree_attention,
                                                     tree_decode_bytes_read)
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF, tree_branch_merge_ref, tree_full_tables,
    tree_shared_partials_ref)

TOL_REF = dict(atol=1e-5, rtol=1e-5)
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
        *(torch.from_numpy(t[k]) for k in _MAP))


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
    """The CUDA pair raises on CPU tensors instead of running anything."""
    t = _topology(18, [(1, [4 + 2, 4 + 3])], [])
    q, kp, vp = (torch.from_numpy(t[k]) for k in ("q", "kp", "vp"))
    rg, sbt, sl, bbt, ln = (torch.from_numpy(t[k]) for k in _MAP)
    with pytest.raises(ValueError, match="CUDA"):
        tree_decode.paged_tree_attention_fwd(q, kp, vp, rg, sbt, sl, bbt, ln)
    with pytest.raises(ValueError, match="CUDA"):
        tree_decode.paged_tree_branch_fwd(q, kp, vp, rg, sl, bbt, ln,
                                          q[..., 0], q[..., 0], q)
    assert tree_decode.shared_launches == tree_decode.branch_launches == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA pair has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    """Both passes on the card against the plain version, with NaN in
    every page no row owns."""
    shape, groups, singles = TOPOLOGIES[name]
    t = _topology(19, groups, singles, **shape)
    kp, vp = t["kp"].copy(), t["vp"].copy()
    kp[:, -2:], vp[:, -2:] = np.nan, np.nan
    args = [torch.from_numpy(a).to(cuda, dtype) for a in (t["q"], kp, vp)]
    args += [torch.from_numpy(t[k]).to(cuda) for k in _MAP]
    out = tree_decode.paged_tree_attention_fwd(*args)
    ref = paged_tree_attention(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), ref, atol=tol, rtol=tol)
