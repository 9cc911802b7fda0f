"""The port's dense flash prefill (kernel K5) on the CPU.

On a CPU tensor ``ops.flash_attention`` runs the plain PyTorch version;
it is held against the JAX package's Pallas kernel in interpret mode
(``flash_attention`` / ``flash_prefill`` with ``interpret=True``, as
``tests/test_kernels.py`` runs them) and against its jnp ref, on the
same seeded numpy inputs, in fp32 to atol=rtol=1e-5 (different summation
orders). The cases are those of ``tests/test_kernels.py``: block-divisible
and non-divisible S, causal and non-causal, GQA groups 1/2/4 and more,
``true_len`` rows that are exact zeros. The CUDA kernel itself runs only
on a card (tests marked ``gpu``, skipped here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.kernels.flash_prefill.flash_prefill import \
    flash_prefill as jax_k5_pallas
from repro.kernels.flash_prefill.ops import flash_attention as jax_k5
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_k5_ref
from repro_torch.kernels.flash_prefill import flash_prefill as k5_module
from repro_torch.kernels.flash_prefill.flash_prefill import flash_prefill
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.flash_prefill.ref import (CHUNKED_THRESHOLD,
                                                   Q_BLOCK,
                                                   flash_prefill_ref)

F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(rng, b, s, h, hkv, hd):
    return [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (h, hkv, hkv)]


def _port(arrays, **kw):
    return flash_attention(*[torch.from_numpy(a) for a in arrays],
                           **kw).numpy()


@pytest.mark.parametrize("b,s,h,hd,bq,bk", [
    (2, 64, 4, 64, 16, 16),
    (1, 128, 2, 128, 32, 64),
    (2, 48, 3, 32, 16, 16),
    (1, 100, 2, 64, 32, 32),   # non-divisible: the kernel pads internally
])
def test_causal_matches_pallas_and_ref(rng, b, s, h, hd, bq, bk):
    """Causal, one KV head per query head, at the reference kernel
    tests' shapes and block sizes."""
    arrays = _inputs(rng, b, s, h, h, hd)
    out = _port(arrays)
    jx = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        out, np.asarray(jax_k5(*jx, block_q=bq, block_k=bk)), **F32)
    np.testing.assert_allclose(out, np.asarray(jax_k5_ref(*jx)), **F32)


@pytest.mark.parametrize("s", [32, 37])
def test_noncausal_matches_pallas_and_ref(rng, s):
    """Non-causal, divisible (32) and non-divisible (37) S."""
    arrays = _inputs(rng, 1, s, 2, 2, 32)
    out = _port(arrays, causal=False)
    jx = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(jax_k5(
        *jx, causal=False, block_q=16, block_k=16)), **F32)
    np.testing.assert_allclose(out, np.asarray(jax_k5_ref(
        *jx, causal=False)), **F32)


@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1), (6, 3), (8, 2)])
def test_gqa_native_matches_pallas(rng, h, hkv):
    """GQA groups 2, 8, 2 and 4: K/V stay [B, S, Hkv, hd]; pre-repeated
    K/V give the same output."""
    arrays = _inputs(rng, 2, 48, h, hkv, 32)
    out = _port(arrays)
    jx = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        out, np.asarray(jax_k5(*jx, block_q=16, block_k=16)), **F32)
    q, k, v = arrays
    rep = _port([q, np.repeat(k, h // hkv, 2), np.repeat(v, h // hkv, 2)])
    np.testing.assert_allclose(out, rep, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("true_len,s", [(13, 16), (5, 37)])
def test_true_len_rows_are_exact_zeros(rng, causal, true_len, s):
    """Rows at or past ``true_len`` are exact zeros and keys there are
    never attended: the rows before it equal the Pallas kernel's (and
    attention over the unpadded prefix), whatever the padded keys hold."""
    q, k, v = _inputs(rng, 1, s, 2, 2, 32)
    out = _port([q, k, v], causal=causal, true_len=true_len)
    pallas = np.asarray(jax_k5_pallas(
        *[jnp.asarray(a) for a in (q, k, v)], causal=causal, block_q=8,
        block_k=8, interpret=True, true_len=true_len))
    np.testing.assert_allclose(out, pallas, **F32)
    assert np.all(out[:, true_len:] == 0.0)
    head = _port([a[:, :true_len] for a in (q, k, v)], causal=causal)
    np.testing.assert_allclose(out[:, :true_len], head, **F32)
    k[:, true_len:] = 1e4                         # never attended
    out2 = _port([q, k, v], causal=causal, true_len=true_len)
    np.testing.assert_allclose(out2, out, atol=0, rtol=0)


class _LargestTensor(TorchDispatchMode):
    """Records the most elements any tensor an op returns holds."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("true_len", [None, 13])
def test_head_dim_256_matches_pallas_and_ref(rng, causal, true_len):
    """gemma-7b's head_dim 256 (GQA group 2, non-divisible S): the plain
    version equals the Pallas kernel (interpret mode) and the jnp ref over
    the rows before ``true_len``; rows at or past it are exact zeros."""
    q, k, v = _inputs(rng, 2, 37, 4, 2, 256)
    out = _port([q, k, v], causal=causal, true_len=true_len)
    jx = [jnp.asarray(a) for a in (q, k, v)]
    pallas = np.asarray(jax_k5_pallas(
        *jx, causal=causal, block_q=16, block_k=16, interpret=True,
        true_len=true_len))
    np.testing.assert_allclose(out, pallas, **F32)
    n = 37 if true_len is None else true_len
    ref = np.asarray(jax_k5_ref(*[a[:, :n] for a in jx], causal=causal))
    np.testing.assert_allclose(out[:, :n], ref, **F32)
    assert np.all(out[:, n:] == 0.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,true_len", [(4096, None), (4096, 3001),
                                        (2049, None)])
def test_long_prompt_blocks_match_jax(causal, s, true_len):
    """Past 2,048 positions the plain version attends in blocks of 512
    query rows: no tensor of the call holds [S, S] elements per head (the
    largest, recorded op by op, is one block's [512, S] scores per head),
    and the output equals the JAX plain version over the first
    ``true_len`` positions within 1e-5 (fp32), rows past it exact zeros;
    causal and not, a partial last block (S = 2049) included."""
    assert s > CHUNKED_THRESHOLD
    b, h, hkv = 1, 2, 1
    arrays = _inputs(np.random.default_rng(7), b, s, h, hkv, 32)
    with _LargestTensor() as seen:
        out = flash_prefill_ref(*[torch.from_numpy(a) for a in arrays],
                                causal=causal, true_len=true_len).numpy()
    assert seen.most <= b * h * Q_BLOCK * s < b * h * s * s
    n = s if true_len is None else true_len
    want = np.asarray(jax_k5_ref(*[jnp.asarray(a[:, :n]) for a in arrays],
                                 causal=causal))
    np.testing.assert_allclose(out[:, :n], want, **F32)
    assert np.all(out[:, n:] == 0.0)


def test_short_prompt_is_one_block():
    """At or under 2,048 positions the plain version stays one [S, S]
    block per head, as before."""
    arrays = _inputs(np.random.default_rng(8), 1, 300, 2, 1, 32)
    with _LargestTensor() as seen:
        flash_prefill_ref(*[torch.from_numpy(a) for a in arrays])
    assert seen.most == 2 * 300 * 300


def test_plain_version_keeps_bf16(rng):
    """bf16 in, bf16 out, computed in fp32 (the rounded fp32 result)."""
    arrays = _inputs(rng, 1, 24, 4, 2, 64)
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = flash_prefill_ref(q.float(), k.float(), v.float())
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """The CUDA wrapper never computes on the CPU and never falls back:
    it raises for CPU tensors (fp32 and bf16, whichever kernel they would
    pick), for inputs that require grad (K5 is forward-only, as the TPU
    kernel), for a head_dim it is not built for (96) and for more than 64
    query heads per KV head. Head_dim 256 (gemma-7b) passes its checks and
    is refused only for lying on the CPU."""
    q, k, v = [torch.from_numpy(a) for a in _inputs(rng, 1, 8, 4, 2, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(*[t.to(torch.bfloat16) for t in (q, k, v)])
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_prefill(q.clone().requires_grad_(), k, v)
    odd = [torch.zeros((1, 8, n, 96)) for n in (4, 2, 2)]
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_prefill(*odd)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_prefill(*[t.to(torch.bfloat16) for t in odd])
    wide = [torch.zeros((1, 8, n, 256)) for n in (4, 2, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(*wide)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(*[t.to(torch.bfloat16) for t in wide])
    many = [torch.zeros((1, 8, n, 32)) for n in (128, 1, 1)]
    with pytest.raises(ValueError, match="128 query heads over 1"):
        flash_prefill(*many)
    assert k5_module.launches == 0


@pytest.mark.parametrize("cta", [64, 128])
def test_block_rows_fill_a_cta(cta):
    """A CTA of 64 rows (one consumer warpgroup; the fp32 kernel) or 128
    (two) holds floor(rows / group) positions x group heads, filled to
    within one group (r1-distill-14b: 12 or 25 positions x 5 heads)."""
    for group in (1, 2, 5, 7, 8, 64):
        rows = k5_module.block_rows(group, cta) * group
        assert cta - group < rows <= cta
    assert k5_module.block_rows(5) == 12


H100_SMS = 132      # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("seqlen,group,kv_heads,batch,want", [
    (272, 5, 8, 1, 64),      # r1-distill-14b's admissions: 88 CTAs of 128
    (4096, 5, 8, 1, 128),    # its Model.prefill(4096): 1,312 CTAs of 128
    (272, 7, 2, 1, 64),      # qwen2-0.5b: 11 x 2 = 22 CTAs of 128
    (2000, 7, 2, 8, 128),    # 111 x 2 x 8 = 1,776
    (100, 2, 2, 2, 64),
    (3300, 1, 1, 1, 64),     # 26 tiles of 128 positions: still too few
    (17000, 1, 1, 1, 128),   # 133 tiles of 128
])
def test_cta_rows_rule(seqlen, group, kv_heads, batch, want):
    """The bf16 tiling rule on an H100 SXM (132 SMs): 128 rows per CTA
    where that still gives the grid a CTA for each SM, else 64; fp32, and
    bf16 at head_dim 256, always 64. Either way every query position lies
    in exactly one CTA."""
    rows = k5_module.cta_rows(seqlen, group, kv_heads, batch,
                              torch.bfloat16, H100_SMS, 128)
    assert rows == want
    assert k5_module.cta_rows(seqlen, group, kv_heads, batch,
                              torch.float32, H100_SMS, 128) == 64
    # head_dim 256: one consumer warpgroup in bf16 too
    assert k5_module.cta_rows(seqlen, group, kv_heads, batch,
                              torch.bfloat16, H100_SMS, 256) == 64
    per = k5_module.block_rows(group, rows)
    tiles = -(-seqlen // per)
    assert (tiles - 1) * per < seqlen <= tiles * per
    tiles128 = -(-seqlen // k5_module.block_rows(group, 128))
    assert (tiles128 * kv_heads * batch >= H100_SMS) == \
        (rows == 128)


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = {
    # name: (B, S, H, Hkv, hd, causal, true_len)
    "r1_272": (1, 272, 40, 8, 128, True, None),
    "qwen2_272": (1, 272, 14, 2, 64, True, None),
    "hd32_nondivisible": (2, 100, 4, 2, 32, True, None),
    "noncausal": (2, 37, 4, 2, 32, False, None),
    "true_len": (1, 272, 40, 8, 128, True, 200),
    # 16 key tiles through the TMA ring, the last one partial
    "ring_wrap": (1, 1000, 40, 8, 128, True, 997),
    # gemma-7b's 16/16 heads of 256: its admissions, non-causal, a
    # true_len, the ring wrapped
    "gemma256_272": (1, 272, 16, 16, 256, True, None),
    "gemma256_noncausal_true_len": (2, 48, 16, 16, 256, False, 13),
    "gemma256_ring_wrap": (1, 1000, 16, 16, 256, True, 997),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda, case, dtype, tol, rng):
    """CUDA K5 = plain K5 on the card, in the working dtype; rows past
    ``true_len`` exact zeros."""
    b, s, h, hkv, hd, causal, tl = CARD_CASES[case]
    q, k, v = [torch.from_numpy(a).to(cuda, dtype)
               for a in _inputs(rng, b, s, h, hkv, hd)]
    out = flash_attention(q, k, v, causal=causal, true_len=tl)
    ref = flash_prefill_ref(q, k, v, causal, tl)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if tl is not None:
        assert (out[:, tl:] == 0).all()
