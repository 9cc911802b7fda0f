"""The port's paged attention kernels (K1 decode, K2 prefill) on the CPU.

On a CPU tensor the ``ops`` dispatchers run the plain PyTorch versions;
these are held against both the JAX package's jnp refs and its Pallas
kernels in interpret mode (``use_kernel=True`` on the CPU, as
``tests/test_kernels.py`` runs them), on the same seeded numpy inputs, in
fp32 to atol=rtol=1e-5 (different summation orders). A row of length 0
is compared with the Pallas kernel only: the kernel's max(l, 1e-30)
epilogue gives exact zeros there, while the JAX ref's softmax over an
all-masked row averages garbage. The CUDA kernels themselves run only
on a card (tests marked ``gpu``, skipped here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.ops import \
    mixed_step_bytes_read as jax_bytes_read
from repro.kernels.flash_prefill.ops import paged_flash_prefill as jax_k2
from repro.kernels.flash_prefill.ref import \
    paged_flash_prefill_ref as jax_k2_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_k1
from repro.kernels.paged_attention.ref import \
    paged_attention_decode_ref as jax_k1_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ops import (mixed_step_bytes_read,
                                                   paged_flash_prefill)
from repro_torch.kernels.flash_prefill.paged_prefill import \
    paged_flash_prefill_fwd
from repro_torch.kernels.flash_prefill.ref import paged_flash_prefill_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_decode
from repro_torch.kernels.paged_attention.ref import (
    DECODE_MAX_SPLITS, DECODE_MIN_SPLIT_KEYS, DECODE_TILE_KEYS, DECODE_WARPS,
    decode_split_keys,
    decode_splits, paged_attention_decode_ref,
    paged_attention_decode_split_ref)

F32 = dict(atol=1e-5, rtol=1e-5)


def _decode_inputs(rng, *, batch, q_heads, kv_heads, hd, ps, width, lengths,
                   num_pages=None):
    """Random pool, distinct pages per row, sentinel (num_pages) tails."""
    num_pages = num_pages or batch * width + 3
    q = rng.normal(size=(batch, q_heads, hd)).astype(np.float32)
    k = rng.normal(size=(kv_heads, num_pages, ps, hd)).astype(np.float32)
    v = rng.normal(size=(kv_heads, num_pages, ps, hd)).astype(np.float32)
    perm = rng.permutation(num_pages)
    bt = np.full((batch, width), num_pages, np.int32)
    off = 0
    for b, n_tok in enumerate(lengths):
        n = -(-n_tok // ps)
        bt[b, :n] = perm[off:off + n]
        off += n
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _prefill_inputs(rng, *, t, q_heads, kv_heads, hd, ps, width, end):
    num_pages = width + 5
    q = rng.normal(size=(t, q_heads, hd)).astype(np.float32)
    k = rng.normal(size=(kv_heads, num_pages, ps, hd)).astype(np.float32)
    v = rng.normal(size=(kv_heads, num_pages, ps, hd)).astype(np.float32)
    n = -(-end // ps)
    bt = np.full((width,), num_pages, np.int32)
    bt[:n] = rng.permutation(num_pages)[:n]
    return q, k, v, bt


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


DECODE_CASES = {
    # name: (q_heads, kv_heads, hd, ps, width, lengths)
    "group1_ragged": (4, 4, 64, 8, 4, [1, 7, 8, 9, 32]),
    "group2_zero": (4, 2, 64, 4, 6, [0, 5, 24, 13]),
    "group5_r1": (10, 2, 128, 16, 3, [17, 0, 48, 33]),
    "group7_qwen2": (14, 2, 64, 16, 4, [64, 1, 30]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_ref(case, rng):
    """Plain K1 = the JAX ref on every row of non-zero length (ragged
    lengths, sentinel tails, GQA groups 1/2/5/7)."""
    qh, kvh, hd, ps, width, lengths = DECODE_CASES[case]
    q, k, v, bt, ln = _decode_inputs(rng, batch=len(lengths), q_heads=qh,
                                     kv_heads=kvh, hd=hd, ps=ps, width=width,
                                     lengths=lengths)
    out = paged_attention(*_torch(q, k, v, bt, ln)).numpy()
    ref = np.asarray(jax_k1_ref(*map(jnp.asarray, (q, k, v, bt, ln))))
    live = ln > 0
    np.testing.assert_allclose(out[live], ref[live], **F32)
    assert (out[~live] == 0).all(), "a length-0 row must give exact zeros"


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas_interpret(case, rng):
    """Plain K1 = the Pallas kernel run in interpret mode on every row,
    length-0 rows (exact zeros) included."""
    qh, kvh, hd, ps, width, lengths = DECODE_CASES[case]
    q, k, v, bt, ln = _decode_inputs(rng, batch=len(lengths), q_heads=qh,
                                     kv_heads=kvh, hd=hd, ps=ps, width=width,
                                     lengths=lengths)
    out = paged_attention(*_torch(q, k, v, bt, ln)).numpy()
    ker = np.asarray(jax_k1(*map(jnp.asarray, (q, k, v, bt, ln)),
                            use_kernel=True))
    np.testing.assert_allclose(out, ker, **F32)


def test_decode_plain_ignores_poisoned_stale_slots(rng):
    """NaN in a page's slots past a row's length (stale bytes) must not
    reach the output: masked keys are skipped, not weighted by zero."""
    q, k, v, bt, ln = _decode_inputs(rng, batch=2, q_heads=4, kv_heads=2,
                                     hd=64, ps=8, width=3, lengths=[5, 12])
    base = paged_attention(*_torch(q, k, v, bt, ln)).numpy()
    k2, v2 = k.copy(), v.copy()
    for b, n_tok in enumerate(ln):
        last = bt[b, (n_tok - 1) // 8]
        k2[:, last, n_tok % 8:] = np.nan
        v2[:, last, n_tok % 8:] = np.nan
    got = paged_attention(*_torch(q, k2, v2, bt, ln)).numpy()
    np.testing.assert_array_equal(got, base)


# ------------------------------------- the bf16 decode core's key splits


@pytest.mark.parametrize("page_size", [1, 4, 16, 64])
def test_decode_splits_cover_every_key_once(page_size):
    """The split rule over tables of 1-64 pages: key splits of a multiple
    of 32 keys, 1 to 8 of them, none empty, covering the table, a table
    of more than 1,024 keys cut into splits of at least 1,024; for every
    end from 0 to the table's capacity (every 61st past 1,024 keys), each
    key below it lies in exactly one (CTA, warp) and no other key in any.
    fp32 takes the whole table as one split."""
    for width in range(1, 65):
        cap = page_size * width
        keys, n = decode_splits(page_size, width, torch.bfloat16)
        assert keys % DECODE_TILE_KEYS == 0 and keys >= 128
        assert 1 <= n <= DECODE_MAX_SPLITS
        assert (n - 1) * keys < cap <= n * keys
        assert n == 1 or keys >= DECODE_MIN_SPLIT_KEYS
        ends = torch.arange(cap + 1)
        if cap > 1024:      # several splits: every 61st end and the last
            ends = torch.cat([ends[::61], ends[-2:]])
        owned = decode_split_keys(ends, keys, n, cap).long()
        assert owned.shape == (n, DECODE_WARPS, len(ends), cap)
        want = (torch.arange(cap)[None, :] < ends[:, None]).long()
        assert torch.equal(owned.sum((0, 1)), want)
        assert decode_splits(page_size, width, torch.float32) == (cap, 1)


def test_decode_splits_depend_on_the_shapes_only():
    """The serve's tables (32 pages of 16 tokens) are one split of 512
    keys whatever the step's lengths; past 1,024 keys a table is cut into
    1,024-key splits, doubled until 8 cover it."""
    assert decode_splits(16, 32, torch.bfloat16) == (512, 1)
    assert decode_splits(16, 3, torch.bfloat16) == (128, 1)
    assert decode_splits(16, 64, torch.bfloat16) == (1024, 1)
    assert decode_splits(16, 65, torch.bfloat16) == (1024, 2)
    assert decode_splits(16, 512, torch.bfloat16) == (1024, 8)
    assert decode_splits(16, 1024, torch.bfloat16) == (2048, 8)


# name: (q_heads, kv_heads, hd, ps, width, lengths): the table's capacity,
# 1 and 0, ragged ends across 32-key tiles and 128-key splits
SPLIT_CASES = {
    "group5_capacity": (10, 2, 128, 16, 12, [192, 1, 0, 129, 65]),
    "group7_tiles": (14, 2, 64, 8, 20, [160, 33, 31, 96, 97]),
    "group2_page1": (4, 2, 32, 1, 300, [300, 0, 1, 128, 257]),
    "group1_page4": (4, 4, 64, 4, 70, [280, 255, 2, 0]),
    # past 1,024 keys: 2 and 4 splits by the rule (CTA clusters on a card)
    "group5_two_splits": (10, 2, 128, 16, 80,
                          [1280, 1025, 1024, 1023, 0, 1, 700]),
    "group2_four_splits": (4, 2, 32, 16, 200, [3200, 2049, 0, 3000, 1]),
}


def _split_inputs(rng, case, poison):
    """A SPLIT_CASES case with sentinel tails; with ``poison`` NaN in
    every slot past each row's end in its last page and in the two
    pages no row owns."""
    qh, kvh, hd, ps, width, lengths = SPLIT_CASES[case]
    q, k, v, bt, ln = _decode_inputs(rng, batch=len(lengths), q_heads=qh,
                                     kv_heads=kvh, hd=hd, ps=ps, width=width,
                                     lengths=lengths,
                                     num_pages=len(lengths) * width + 2)
    if poison:
        k, v = k.copy(), v.copy()
        for b, n_tok in enumerate(lengths):
            if n_tok % ps:
                k[:, bt[b, n_tok // ps], n_tok % ps:] = np.nan
                v[:, bt[b, n_tok // ps], n_tok % ps:] = np.nan
        owned = set(bt[bt < k.shape[1]].tolist())
        free = [p for p in range(k.shape[1]) if p not in owned]
        k[:, free], v[:, free] = np.nan, np.nan
    return q, k, v, bt, ln


@pytest.mark.parametrize("split", ["rule", "32-key"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_merge_matches_plain_and_pallas(case, split):
    """The plain model of the bf16 decode core (per-warp partials of each
    key split, merged in warp order, then split order, then divided)
    equals the plain K1 and the JAX Pallas kernel in interpret mode
    within 1e-5 (fp32), at the split rule's layout and at 32-key splits
    (many CTAs per row); lengths 0, 1 and the table's capacity, NaN in
    stale and unowned pages and sentinel table entries included, and a
    length-0 row is exact zeros."""
    q, k, v, bt, ln = _split_inputs(np.random.default_rng(5), case,
                                    poison=True)
    ps, width = k.shape[2], bt.shape[1]
    keys, n = (decode_splits(ps, width, torch.bfloat16) if split == "rule"
               else (32, -(-ps * width // 32)))
    got = paged_attention_decode_split_ref(*_torch(q, k, v, bt, ln), keys, n)
    assert bool(torch.isfinite(got).all())
    assert (got[torch.from_numpy(ln) == 0] == 0).all()
    clean = _split_inputs(np.random.default_rng(5), case, poison=False)
    np.testing.assert_allclose(
        got.numpy(), paged_attention(*_torch(*clean)).numpy(), **F32)
    ker = np.asarray(jax_k1(*map(jnp.asarray, clean), use_kernel=True))
    np.testing.assert_allclose(got.numpy(), ker, **F32)


PREFILL_CASES = {
    # name: (t, pos0, valid, q_heads, kv_heads, hd, ps, width)
    "first_chunk_pad_rows": (8, 0, 5, 4, 2, 64, 4, 6),
    "pos0_mid_page": (8, 6, 8, 4, 4, 64, 4, 6),
    "group5_mid_page_pad": (16, 37, 11, 10, 2, 128, 16, 4),
    "group7_one_valid_row": (8, 13, 1, 14, 2, 64, 8, 4),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_plain_matches_jax_ref_and_pallas(case, rng):
    """Plain K2 = the JAX ref and the Pallas kernel (interpret mode):
    causal on absolute positions, pos0 mid-page, pad rows exact zeros."""
    t, pos0, valid, qh, kvh, hd, ps, width = PREFILL_CASES[case]
    q, k, v, bt = _prefill_inputs(rng, t=t, q_heads=qh, kv_heads=kvh, hd=hd,
                                  ps=ps, width=width, end=pos0 + valid)
    out = paged_flash_prefill(*_torch(q, k, v, bt), pos0, valid).numpy()
    jargs = list(map(jnp.asarray, (q, k, v, bt))) + [jnp.int32(pos0),
                                                     jnp.int32(valid)]
    ref = np.asarray(jax_k2_ref(*jargs))
    ker = np.asarray(jax_k2(*jargs, use_kernel=True))
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, ker, **F32)
    assert (out[valid:] == 0).all(), "pad rows must give exact zeros"


def test_prefill_plain_ignores_poisoned_future_slots(rng):
    """NaN past the chunk's last valid position never reaches a row."""
    t, pos0, valid, ps = 8, 3, 6, 4
    q, k, v, bt = _prefill_inputs(rng, t=t, q_heads=4, kv_heads=2, hd=64,
                                  ps=ps, width=4, end=pos0 + valid)
    base = paged_flash_prefill(*_torch(q, k, v, bt), pos0, valid).numpy()
    end = pos0 + valid
    k2, v2 = k.copy(), v.copy()
    k2[:, bt[(end - 1) // ps], end % ps:] = np.nan
    v2[:, bt[(end - 1) // ps], end % ps:] = np.nan
    got = paged_flash_prefill(*_torch(q, k2, v2, bt), pos0, valid).numpy()
    np.testing.assert_array_equal(got, base)


def test_prefill_matches_decode_path_row_by_row(rng):
    """K2 over a chunk = K1 per chunk row with length pos0 + i + 1 (the
    engine's "decode" fallback computes the same attention)."""
    t, pos0, valid, ps = 8, 5, 7, 4
    q, k, v, bt = _prefill_inputs(rng, t=t, q_heads=6, kv_heads=2, hd=64,
                                  ps=ps, width=5, end=pos0 + valid)
    out = paged_flash_prefill(*_torch(q, k, v, bt), pos0, valid).numpy()
    rows = np.broadcast_to(bt, (t, bt.shape[0])).copy()
    lens = (pos0 + np.arange(t) + 1).astype(np.int32)
    dec = paged_attention(*_torch(q, k, v, rows, lens)).numpy()
    np.testing.assert_allclose(out[:valid], dec[:valid], **F32)


def test_plain_versions_keep_bf16(rng):
    """bf16 in, bf16 out, within bf16 rounding of the fp32 result."""
    q, k, v, bt, ln = _decode_inputs(rng, batch=3, q_heads=4, kv_heads=2,
                                     hd=64, ps=8, width=3, lengths=[3, 9, 24])
    ref = paged_attention(*_torch(q, k, v, bt, ln))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = paged_attention(qb, kb, vb, *_torch(bt, ln))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=2e-2)


def test_mixed_step_bytes_read_is_the_reference_formula():
    """The copied analytic byte count equals the JAX package's."""
    for chunk, pos0, path in ((64, 0, "fused"), (32, 37, "fused"),
                              (16, 5, "decode"), (48, 448, "decode")):
        kw = dict(page_size=16, kv_heads=8, head_dim=128, path=path,
                  block_q=32, itemsize=2)
        assert mixed_step_bytes_read(chunk, pos0, **kw) == \
            jax_bytes_read(chunk, pos0, **kw)


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """The CUDA wrappers never compute on the CPU: they raise, and only
    the ops dispatchers route CPU tensors to the plain versions."""
    q, k, v, bt, ln = _torch(*_decode_inputs(
        rng, batch=2, q_heads=4, kv_heads=2, hd=64, ps=8, width=2,
        lengths=[3, 9]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_decode(q, k, v, bt, ln)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_prefill_fwd(q, k, v, bt[0], 0, 2)


def test_build_raises_without_nvcc(monkeypatch):
    """No compiler means an error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_build_dir_is_keyed_by_sources():
    """The build goes under the repo's build/ and its hash covers every
    csrc file, so an edited kernel is rebuilt."""
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT
    assert d.parent.parent.name == "build"
    assert d == build.build_dir()
    names = {p.name for p in build.CSRC.iterdir()}
    assert {f"{s}.cu" for s in build.SOURCES} <= names


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain_on_card(cuda, case, dtype, tol, rng):
    """CUDA K1 = plain K1 on the card, in the working dtype."""
    qh, kvh, hd, ps, width, lengths = DECODE_CASES[case]
    args = [t.to(cuda) for t in _torch(*_decode_inputs(
        rng, batch=len(lengths), q_heads=qh, kv_heads=kvh, hd=hd, ps=ps,
        width=width, lengths=lengths))]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = paged_attention(*args)
    ref = paged_attention_decode_ref(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_kernel_splits_match_plain_on_card(cuda, case, dtype, tol,
                                                  rng):
    """CUDA K1 = plain K1 on the card where rows span several key splits
    (the bf16 kernel's cluster merge), with NaN in stale and unowned
    pages; a length-0 row is exact zeros."""
    args = [a.to(cuda) for a in _torch(*_split_inputs(rng, case, True))]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = paged_attention(*args)
    ref = paged_attention_decode_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert (out[args[4] == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_kernel_two_head_slices_on_card(cuda, dtype, tol, rng):
    """A GQA group of 24 query heads (two 16-head slices of the bf16
    kernel) against the plain K1 on the card."""
    args = [a.to(cuda) for a in _torch(*_decode_inputs(
        rng, batch=3, q_heads=48, kv_heads=2, hd=64, ps=16, width=16,
        lengths=[256, 17, 0]))]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = paged_attention(*args)
    ref = paged_attention_decode_ref(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_kernel_matches_plain_on_card(cuda, case, dtype, tol, rng):
    """CUDA K2 = plain K2 on the card, in the working dtype."""
    t, pos0, valid, qh, kvh, hd, ps, width = PREFILL_CASES[case]
    args = [a.to(cuda) for a in _torch(*_prefill_inputs(
        rng, t=t, q_heads=qh, kv_heads=kvh, hd=hd, ps=ps, width=width,
        end=pos0 + valid))]
    args[:3] = [a.to(dtype) for a in args[:3]]
    out = paged_flash_prefill(*args, pos0, valid)
    ref = paged_flash_prefill_ref(*args, pos0, valid)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert (out[valid:] == 0).all()


@pytest.mark.parametrize("hd,ok", [(32, True), (64, True), (128, True),
                                   (16, False), (256, False)])
def test_paged_operands_head_dims(hd, ok):
    """K1-K3 take head_dim 32 (the serve launcher's fallback trunks), 64
    and 128; any other width raises before a launch."""
    q = torch.zeros((2, 4, hd))
    pages = torch.zeros((2, 3, 4, hd))
    if ok:
        build.check_paged_operands("k", q, pages, pages, 32)
    else:
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            build.check_paged_operands("k", q, pages, pages, 32)
