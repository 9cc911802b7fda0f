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

from repro.kernels.flash_prefill.flash_prefill import \
    flash_prefill as jax_k5_pallas
from repro.kernels.flash_prefill.ops import flash_attention as jax_k5
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_k5_ref
from repro_torch.kernels.flash_prefill import flash_prefill as k5_module
from repro_torch.kernels.flash_prefill.flash_prefill import flash_prefill
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

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
    it raises for CPU tensors, for inputs that require grad (K5 is
    forward-only, as the TPU kernel), for head_dim 256 (gemma-7b) and
    for more than 64 query heads per KV head."""
    q, k, v = [torch.from_numpy(a) for a in _inputs(rng, 1, 8, 4, 2, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(q, k, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_prefill(q.clone().requires_grad_(), k, v)
    wide = [torch.zeros((1, 8, n, 256)) for n in (4, 2, 2)]
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_prefill(*wide)
    many = [torch.zeros((1, 8, n, 32)) for n in (128, 1, 1)]
    with pytest.raises(ValueError, match="128 query heads over 1"):
        flash_prefill(*many)
    assert k5_module.launches == 0


def test_block_rows_fill_a_cta():
    """A CTA holds floor(64 / group) positions x group heads <= 64
    rows (r1-distill-14b: 12 positions x 5 heads)."""
    for group in (1, 2, 5, 7, 8, 64):
        rows = k5_module.block_rows(group) * group
        assert 64 - group < rows <= 64


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
