"""The gradient of the port's dense flash prefill (kernel K5) on the CPU.

``flash_prefill_bwd_ref`` (the backward kernel's plain version: the
gradient written out in fp32 from the forward's output and log-sum-exp)
is held against autograd of ``flash_prefill_ref`` and against
``jax.grad`` of the JAX package's ``_attend`` (what the reference's
training path differentiates), on the same seeded numpy inputs: causal
and not, ``true_len``, GQA groups 1, 2 and 7, head_dim 32 and 64, fp32 to
atol=rtol=2e-5 (sums over up to 50 keys taken in different orders). The
CUDA backward runs only on a card (tests marked ``gpu``, skipped here);
``chip_smoke.py`` holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models.attention import _attend as jax_attend
from repro_torch.kernels.flash_prefill import flash_prefill_bwd as bwd_module
from repro_torch.kernels.flash_prefill.flash_prefill_bwd import (
    FlashPrefillFn, flash_prefill_bwd)
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_bwd_ref,
                                                   flash_prefill_lse_ref,
                                                   flash_prefill_ref)

TOL = dict(atol=2e-5, rtol=2e-5)

# name: (B, S, H, Hkv, hd, causal, true_len)
CASES = {
    "causal g1 hd64": (2, 40, 3, 3, 64, True, None),
    "causal g2 hd32": (2, 37, 4, 2, 32, True, None),
    "causal g7 hd64 true_len": (1, 50, 14, 2, 64, True, 31),
    "non-causal g2 hd32": (2, 33, 4, 2, 32, False, None),
    "non-causal g7 hd32 true_len": (1, 29, 7, 1, 32, False, 13),
    "causal g2 hd64 true_len=1": (1, 24, 4, 2, 64, True, 1),
}


def _inputs(rng, b, s, h, hkv, hd):
    """q, k, v and the output's gradient dO, fp32 numpy."""
    return [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (h, hkv, hkv, h)]


def _ref_grads(q, k, v, do, causal, tl):
    """(out, lse, dq, dk, dv) of the plain versions."""
    out = flash_prefill_ref(q, k, v, causal, tl)
    lse = flash_prefill_lse_ref(q, k, v, causal, tl)
    return (out, lse) + flash_prefill_bwd_ref(q, k, v, out, lse, do, causal,
                                              tl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_autograd_of_the_forward(rng, case):
    """The written-out gradient equals autograd's through the plain
    forward; rows past true_len get zero dq, keys past it zero dk, dv."""
    b, s, h, hkv, hd, causal, tl = CASES[case]
    q, k, v, do = [torch.from_numpy(a) for a in _inputs(rng, b, s, h, hkv,
                                                        hd)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_prefill_ref(*leaves, causal, tl)
    want = torch.autograd.grad(out, leaves, do)
    _, _, *got = _ref_grads(q, k, v, do, causal, tl)
    for name, a, w in zip("qkv", got, want):
        torch.testing.assert_close(a, w, **TOL, msg=f"d{name}")
    if tl is not None:
        for t in got:
            assert bool((t[:, tl:] == 0).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_jax_grad_of_attend(rng, case):
    """``jax.grad`` of the reference's ``_attend`` under K5's mask (keys
    before true_len, causal or not), with the rows past true_len taken
    out of the objective (K5 writes them as constant zeros)."""
    b, s, h, hkv, hd, causal, tl = CASES[case]
    arrays = _inputs(rng, b, s, h, hkv, hd)
    n = s if tl is None else tl
    cfg = JConfig(num_layers=1, d_model=h * hd, num_heads=h,
                  num_kv_heads=hkv, head_dim=hd, d_ff=4, vocab_size=8)
    pos = np.arange(s)
    mask = (pos[None, :] < n) & ((pos[None, :] <= pos[:, None]) if causal
                                 else True)
    rows = (pos < n).astype(np.float32)[None, :, None]
    q, k, v, do = [jnp.asarray(a) for a in arrays]

    def objective(q, k, v):
        out = jax_attend(cfg, q, k, v, jnp.asarray(mask)[None, None])
        return jnp.sum(out * do.reshape(out.shape) * rows)
    want = jax.grad(objective, argnums=(0, 1, 2))(q, k, v)
    _, _, *got = _ref_grads(*[torch.from_numpy(a) for a in arrays], causal,
                            tl)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


def test_lse_ref_is_the_softmax_normaliser(rng):
    """exp(scores - lse) sums to 1 over each valid row's visible keys;
    rows past true_len hold 0."""
    q, k, v, _ = [torch.from_numpy(a) for a in _inputs(rng, 1, 20, 4, 2,
                                                       32)]
    lse = flash_prefill_lse_ref(q, k, v, True, 15)
    scores = torch.einsum("bqhd,bshd->bhqs", q,
                          k.repeat_interleave(2, dim=2)) / 32 ** 0.5
    pos = torch.arange(20)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] < 15)
    p = torch.where(keep, torch.exp(scores - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1)[..., :15], torch.ones(1, 4, 15))
    assert bool((lse[..., 15:] == 0).all())


def test_plain_version_past_the_block_threshold():
    """Past 2,048 positions the plain versions run in query blocks: the
    blocked gradient equals autograd's of the (blocked) forward."""
    rng = np.random.default_rng(3)
    q, k, v, do = [torch.from_numpy(a) for a in _inputs(rng, 1, 2100, 2, 1,
                                                        32)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_prefill_ref(*leaves, True, 2090),
                               leaves, do)
    _, _, *got = _ref_grads(q, k, v, do, True, 2090)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)


def test_cpu_dispatch_is_differentiable(rng):
    """``flash_attention`` on CPU tensors that require grad runs the plain
    version under autograd (no kernel, no launch counted): its gradient is
    the plain backward's."""
    q, k, v, do = [torch.from_numpy(a) for a in _inputs(rng, 2, 19, 6, 3,
                                                        32)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = bwd_module.launches
    out = flash_attention(*leaves, causal=True, true_len=17)
    got = torch.autograd.grad(out, leaves, do)
    _, _, *want = _ref_grads(q, k, v, do, True, 17)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)
    assert bwd_module.launches == before
    with torch.no_grad():
        assert not flash_attention(*leaves).requires_grad


def test_cuda_backward_refuses_what_the_kernel_does_not_take(rng):
    """The backward wrapper never computes on the CPU and never falls
    back: it raises for CPU tensors (fp32 and bf16), a head_dim it is not
    built for (96), more than 64 query heads per KV head, and an lse of
    the wrong shape; ``FlashPrefillFn`` on CPU tensors raises in its
    forward (the CUDA kernel's)."""
    q, k, v, do = [torch.from_numpy(a) for a in _inputs(rng, 1, 8, 4, 2,
                                                        64)]
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_bwd(*[t.to(torch.bfloat16) for t in (q, k, v, q)],
                          lse, do.to(torch.bfloat16))
    odd = [torch.zeros((1, 8, n, 96)) for n in (4, 2, 2, 4)]
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_prefill_bwd(*odd[:3], odd[0], lse, odd[3])
    wide = [torch.zeros((1, 8, n, 64)) for n in (65, 1, 1, 65)]
    with pytest.raises(ValueError, match="65 query heads"):
        flash_prefill_bwd(*wide[:3], wide[0], torch.zeros(1, 65, 8),
                          wide[3])
    with pytest.raises(ValueError, match="CUDA"):
        FlashPrefillFn.apply(q.clone().requires_grad_(), k, v, True, None)


# ---------------------------------------- the launch grids, on the CPU


def test_bwd_grid_at_the_training_shapes():
    """``flash_prefill_bwd_grid`` at phase 14's shapes: the D pass over
    every (head, position), bf16's positions padded to 64 (16 threads a
    row of 128 bf16, 32 of 256; 2 passes of a 256-thread block), then
    dK/dV (KV head, batch, key tile)
    and dQ (query head, batch, query tile), 128-row tiles (64 at head_dim
    256), the tile on z; fp32 (32-row tiles on x)."""
    from repro_torch.kernels.flash_prefill.flash_prefill_bwd import \
        flash_prefill_bwd_grid
    grids = lambda *a: [lg.grid for lg in flash_prefill_bwd_grid(*a)]  # noqa
    bf, f32 = torch.bfloat16, torch.float32
    # r1-distill-14b, B=2, S=2048, 40/8 heads of 128
    assert grids(2, 2048, 40, 128, 8, bf) == [
        (2 * 2048 * 40 // 32, 1, 1), (8, 2, 16), (40, 2, 16)]
    # gemma-7b, B=1, S=2048, 16/16 heads of 256
    assert grids(1, 2048, 16, 256, 16, bf) == [
        (2048 * 16 // 16, 1, 1), (16, 1, 32), (16, 1, 32)]
    # the tiny reasoner's head_dim 32, and S = 1000 (positions padded)
    assert grids(2, 160, 4, 32, 2, bf) == [
        (2 * 192 * 4 // 128, 1, 1), (2, 2, 2), (4, 2, 2)]
    assert grids(1, 1000, 14, 64, 2, bf) == [
        (1024 * 14 // 64, 1, 1), (2, 1, 8), (14, 1, 8)]
    assert grids(2, 2048, 40, 128, 8, f32) == [
        (2 * 2048 * 40 // 16, 1, 1), (64, 8, 2), (64, 40, 2)]
    lgs = flash_prefill_bwd_grid(1, 1000, 14, 64, 2, bf)
    assert [lg.route for lg in lgs] == ["bf16"] * 3
    assert [lg.kernel.split(".")[1] for lg in lgs] == ["bwd_dot", "dkdv",
                                                      "dq"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_its_grids(monkeypatch, dtype):
    """The wrapper hands its launcher ``flash_prefill_bwd_grid``'s grids
    as the two arguments before the stream (the signature of the
    ``extern "C"`` launcher ends so) and ``true_len``; the grids do not
    depend on ``true_len``."""
    import ctypes
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels import introspect as ix
    calls = []

    def function(source, fn_name, argtypes):
        assert (source, fn_name) == ("flash_prefill_bwd",
                                     "flash_prefill_bwd_launch")
        calls.append(list(argtypes))
        return lambda *args: calls.append(args) or 0
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "check_operands", lambda *a: None)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    q, k, v = (torch.zeros(2, 37, n, 32, dtype=dtype) for n in (4, 2, 2))
    lse = torch.zeros(2, 4, 37)
    flash_prefill_bwd(q, k, v, q, lse, q, True, 29)
    argtypes, args = calls
    arr, n = args[-3], args[-2]
    got = [tuple((ctypes.c_int * 3).from_address(ctypes.addressof(arr)
                                                 + 12 * i)) for i in range(n)]
    assert got == [lg.grid for lg in bwd_module.flash_prefill_bwd_grid(
        2, 37, 4, 32, 2, dtype)]
    assert args[16] == 29 and len(args) == len(argtypes)
    assert argtypes[-3:] == ix.GRID_ARGTYPES + [ctypes.c_void_p]
    text = (build.CSRC / "flash_prefill_bwd.cu").read_text()
    m = re.search(r'extern "C" int flash_prefill_bwd_launch\((.*?)\)\s*\{',
                  text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    assert params[-3:] == ["const int* grids", "int n_grids", "void* stream"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda, case, dtype, tol, rng):
    """CUDA K5 backward = its plain version on the card, from the
    kernel's own output and LSE, in the working dtype; max error relative
    to the largest magnitude of each reference gradient."""
    b, s, h, hkv, hd, causal, tl = CASES[case]
    q, k, v, do = [torch.from_numpy(a).to(cuda, dtype)
                   for a in _inputs(rng, b, s, h, hkv, hd)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, true_len=tl)
    got = torch.autograd.grad(out, leaves, do)
    lse = flash_prefill_lse_ref(q, k, v, causal, tl)
    want = flash_prefill_bwd_ref(q, k, v, out.detach(), lse, do, causal, tl)
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * max(float(w.float().abs().max()), 1e-6)
