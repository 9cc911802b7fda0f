"""The gradient of the port's SSD chunked scan (kernel K4) on the CPU.

``ssd_chunked_bwd_ref`` (the backward kernel's plain version: the gradient
written out in fp32 from the states before each chunk) is held against
autograd of the port's ``ssd_chunked`` and against ``jax.vjp`` of the JAX
package's ``ssd_chunked`` (what the reference's training path
differentiates), with both the output's and the final state's gradient
given, on the same seeded numpy inputs: S a multiple of the chunk and not,
a ``valid`` mask, an initial state that requires grad, chunks 8 and 16,
head_dim 16-32, state 4-16, dt near 0 and large. fp32: dx, db, dc and
d(initial state) to atol=rtol=2e-5, each a sum of up to a few hundred
products taken in other orders by the three (2e-5 was enough for K5's
backward). d dt and da to 2e-5 of their largest magnitude: each entry is
a reverse cumulative sum of row sums minus column sums of E = dG ∘ G,
whose terms are as large as the largest entries, so a small entry is a
difference of large ones (with dt up to 6 an entry of 0.75 beside one of
58 differs by 4.6e-5). The CUDA backward runs only on a card (tests marked
``gpu``, skipped here); ``chip_smoke.py`` holds it against the plain
version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_chunked
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ssd_scan as k4
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as bwd_module
from repro_torch.kernels.ssd_scan.ops import ssd_with_state
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_states_ref,
                                              ssd_chunked,
                                              ssd_chunked_bwd_ref)
from repro_torch.kernels.ssd_scan.ssd_scan_bwd import (SsdScanFn,
                                                       bwd_smem_bytes,
                                                       ssd_scan_bwd)

TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")

# name: (B, S, H, P, N, chunk, initial state, valid mask, dt scale)
CASES = {
    "S=32 q8 p16 n8": (2, 32, 3, 16, 8, 8, False, False, 1.0),
    "S=37 q8 p16 n8 init": (2, 37, 3, 16, 8, 8, True, False, 1.0),
    "S=40 q16 p32 n16 valid": (1, 40, 2, 32, 16, 16, False, True, 1.0),
    "S=64 q16 p24 n4 init valid": (1, 64, 2, 24, 4, 16, True, True, 1.0),
    "S=29 q8 p16 n12 dt~0 init": (2, 29, 2, 16, 12, 8, True, False, 1e-4),
    "S=33 q16 p20 n16 dt large": (1, 33, 2, 20, 16, 16, False, False, 30.0),
}


def _inputs(rng, b, s, h, p, n, init, valid, dt_scale):
    """x, dt, a, b, c, the initial state (or None), the mask (or None),
    dy and dfinal, fp32 numpy; dt in [0.01, 0.2) x ``dt_scale``."""
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (rng.uniform(0.01, 0.2, size=(b, s, h)) * dt_scale).astype(
        np.float32)
    a = -rng.uniform(0.5, 2, size=(h,)).astype(np.float32)
    bb, cc = (rng.normal(size=(b, s, h, n)).astype(np.float32)
              for _ in range(2))
    st = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    vm = rng.random((b, s)) < 0.7 if valid else None
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    df = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a, bb, cc, st, vm, dy, df


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _ref_grads(x, dt, a, bb, cc, st, vm, dy, df, chunk):
    """The plain backward's gradients as torch tensors, the mask's
    ``where`` taken back to the unmasked dt (as autograd would)."""
    x, dt, a, bb, cc, st, dy, df = (_t(v) for v in (x, dt, a, bb, cc, st,
                                                     dy, df))
    vm = _t(vm)
    dtm = torch.where(vm[..., None], dt, 0.0) if vm is not None else dt
    states = ssd_chunk_states_ref(x, dtm, a, bb, cc, chunk, st)
    dx, ddt, da, db, dc, dinit = ssd_chunked_bwd_ref(
        x, dtm, a, bb, cc, states, dy, df, chunk=chunk)
    if vm is not None:
        ddt = ddt * vm[..., None]
    return dx, ddt, da, db, dc, dinit


def _close(got, want, name):
    got, want = (np.asarray(v, np.float32) for v in (got, want))
    if name in ("ddt", "da"):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * float(
            np.abs(want).max()), err_msg=name)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_autograd_of_the_forward(rng, case):
    """The written-out gradient equals autograd's through the plain
    chunked scan, for y and the final state at once."""
    b, s, h, p, n, q, init, valid, scale = CASES[case]
    arrays = _inputs(rng, b, s, h, p, n, init, valid, scale)
    x, dt, a, bb, cc, st, vm, dy, df = arrays
    leaves = [_t(v).clone().requires_grad_() for v in (x, dt, a, bb, cc)]
    if init:
        leaves.append(_t(st).clone().requires_grad_())
    y, fin = ssd_chunked(*leaves[:5], q, leaves[5] if init else None,
                         _t(vm))
    want = torch.autograd.grad((y * _t(dy)).sum() + (fin * _t(df)).sum(),
                               leaves)
    got = _ref_grads(*arrays, q)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_jax_vjp_of_ssd_chunked(rng, case):
    """``jax.vjp`` of the reference's ``ssd_chunked`` (its training
    path's scan), cotangents on both outputs."""
    b, s, h, p, n, q, init, valid, scale = CASES[case]
    arrays = _inputs(rng, b, s, h, p, n, init, valid, scale)
    x, dt, a, bb, cc, st, vm, dy, df = arrays
    primals = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    if init:
        primals.append(jnp.asarray(st))
    mask = None if vm is None else jnp.asarray(vm)

    def fn(*args):
        return jax_chunked(*args[:5], chunk=q,
                           initial_state=args[5] if init else None,
                           valid=mask)
    _, vjp = jax.vjp(fn, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(df)))
    got = _ref_grads(*arrays, q)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("q", [8, 16])
def test_chunk_states_are_the_states_before_each_chunk(rng, q):
    """State z of ``ssd_chunk_states_ref`` is the final state of the scan
    over the first z chunks (state 0 the initial state itself)."""
    x, dt, a, bb, cc, st, _, _, _ = _inputs(rng, 2, 37, 2, 16, 8, True,
                                            False, 1.0)
    x, dt, a, bb, cc, st = (_t(v) for v in (x, dt, a, bb, cc, st))
    states = ssd_chunk_states_ref(x, dt, a, bb, cc, q, st)
    assert states.shape == (2, -(-37 // q), 2, 16, 8)
    assert torch.equal(states[:, 0], st)
    for z in range(1, states.shape[1]):
        _, fin = ssd_chunked(x[:, :z * q], dt[:, :z * q], a, bb[:, :z * q],
                             cc[:, :z * q], q, st)
        torch.testing.assert_close(states[:, z], fin, atol=1e-5, rtol=1e-5)


def test_cpu_dispatch_is_differentiable(rng):
    """``ssd_with_state`` on CPU tensors that require grad runs the plain
    scan under autograd (no kernel, no launch counted): its gradient is
    the plain backward's; under no_grad nothing requires grad."""
    arrays = _inputs(rng, 2, 27, 2, 16, 8, True, True, 1.0)
    x, dt, a, bb, cc, st, vm, dy, df = arrays
    leaves = [_t(v).clone().requires_grad_() for v in (x, dt, a, bb, cc,
                                                       st)]
    before = (bwd_module.launches, k4.launches)
    y, fin = ssd_with_state(*leaves[:5], 8, leaves[5], valid=_t(vm))
    got = torch.autograd.grad((y * _t(dy)).sum() + (fin * _t(df)).sum(),
                              leaves)
    want = _ref_grads(*arrays, 8)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)
    assert (bwd_module.launches, k4.launches) == before
    with torch.no_grad():
        assert not ssd_with_state(*leaves[:5], 8)[0].requires_grad


def test_cuda_backward_refuses_what_the_kernel_does_not_take(rng):
    """The backward wrapper never computes on the CPU and never falls
    back: CPU tensors raise (fp32 and bf16), and so do chunk states,
    dy or dfinal of the wrong shape or type, a width over 128 and what one
    CTA cannot hold (P = N = 128 at a chunk of 128 in bf16) before any
    device is touched; ``SsdScanFn`` on CPU tensors raises in its forward
    (the CUDA kernel's)."""
    x, dt, a, bb, cc, st, _, dy, df = (_t(v) for v in _inputs(
        rng, 1, 16, 2, 16, 8, True, False, 1.0))
    states = torch.zeros(1, 2, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(x, dt, a, bb, cc, states, dy, df, chunk=8)
    bf = [t.to(torch.bfloat16) for t in (x, bb, cc, dy)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(bf[0], dt, a, bf[1], bf[2], states, bf[3], chunk=8)
    with pytest.raises(ValueError, match="chunk states"):
        ssd_scan_bwd(x, dt, a, bb, cc, states[:, :1], dy, chunk=8)
    with pytest.raises(ValueError, match="chunk states"):
        ssd_scan_bwd(x, dt, a, bb, cc, states.double(), dy, chunk=8)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, a, bb, cc, states, bf[3], chunk=8)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_scan_bwd(x, dt, a, bb, cc, states, dy, df[:, :1], chunk=8)
    with pytest.raises(ValueError, match="exceed 128"):
        ssd_scan_bwd(x, dt, a, bb, cc, states, dy, chunk=256)
    wide = [torch.zeros((1, 128, 1, 128), dtype=torch.bfloat16)
            for _ in range(4)]
    with pytest.raises(ValueError, match="one CTA"):
        ssd_scan_bwd(wide[0], torch.zeros(1, 128, 1), torch.zeros(1),
                     wide[1], wide[2], torch.zeros(1, 1, 1, 128, 128),
                     wide[3], chunk=128)
    with pytest.raises(ValueError, match="CUDA"):
        SsdScanFn.apply(x.clone().requires_grad_(), dt, a, bb, cc, st, 8)


def test_training_widths_fit_one_cta():
    """The backward's shared memory at every trained SSM width (one CTA
    owns all of P and N): mamba2-130m (P 64, N 128) and hymba-1.5b (N 16)
    at their chunk of 128, the smoke variants (P 32, N 16, chunk 16), in
    both dtypes; P = N = 128 at a chunk of 128 does not fit in bf16; the
    kernel source is built with the others."""
    for dtype in (torch.bfloat16, torch.float32):
        for p, n, q in ((64, 128, 128), (64, 16, 128), (32, 16, 16)):
            for s in (16, 64, 2048):
                assert 0 < bwd_smem_bytes(q, p, n, s, dtype) <= k4.MAX_SMEM
        # sized by the rows present, not by the chunk
        assert bwd_smem_bytes(128, 64, 128, 16, dtype) < \
            bwd_smem_bytes(128, 64, 128, 2048, dtype)
    assert bwd_smem_bytes(128, 128, 128, 2048) > k4.MAX_SMEM
    assert "ssd_scan_bwd" in build.SOURCES
    assert (build.CSRC / "ssd_scan_bwd.cu").exists()


def test_bwd_grid_at_the_training_shapes():
    """``ssd_scan_bwd_grid`` at phase 14's shapes and at a partial last
    chunk: bf16 launches the chain (32 columns of P, head, row),
    chunk_grad (chunk, head, row) and da_reduce; fp32 dstate, state_pass
    (256 of P N, head, row), chunk_grad and da_reduce."""
    grids = lambda *a: [lg.grid for lg in bwd_module.ssd_scan_bwd_grid(  # noqa
        *a)]
    bf, f32 = torch.bfloat16, torch.float32
    # mamba2-130m, B=2, S=2048, 24 heads of P 64, N 128, chunk 128
    assert grids(2, 2048, 24, 64, 128, 128, bf) == [
        (2, 24, 2), (16, 24, 2), (1, 1, 1)]
    assert grids(2, 2048, 24, 64, 128, 128, f32) == [
        (16, 24, 2), (32, 24, 2), (16, 24, 2), (1, 1, 1)]
    # hymba-1.5b, B=1, 50 heads, N 16; a partial last chunk (S = 1000)
    assert grids(1, 2048, 50, 64, 16, 128, bf) == [
        (2, 50, 1), (16, 50, 1), (1, 1, 1)]
    assert grids(2, 1000, 24, 64, 128, 128, bf) == [
        (2, 24, 2), (8, 24, 2), (1, 1, 1)]
    # the smoke widths (P 32, N 16, chunk 16), 300 heads for da_reduce
    assert grids(4, 64, 300, 32, 16, 16, bf) == [
        (1, 300, 4), (4, 300, 4), (2, 1, 1)]
    assert [lg.kernel for lg in bwd_module.ssd_scan_bwd_grid(
        1, 20, 2, 16, 8, 8, bf)] == ["ssd_scan_bwd.dstate_chain",
                                      "ssd_scan_bwd.chunk_grad",
                                      "ssd_scan_bwd.da_reduce"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_its_grids(monkeypatch, rng, dtype):
    """The wrapper hands its launcher ``ssd_scan_bwd_grid``'s grids as the
    two arguments before the stream (the signature of the ``extern "C"``
    launcher ends so), at a partial last chunk (S = 20, chunk 8), with one
    workspace for dS_end, cs_last and the da partials."""
    import ctypes
    import re

    from repro_torch.kernels import introspect as ix
    calls = []

    def function(source, fn_name, argtypes):
        assert (source, fn_name) == ("ssd_scan_bwd", "ssd_scan_bwd_launch")
        calls.append(list(argtypes))
        return lambda *args: calls.append(args) or 0
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "check_operands", lambda *a: None)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    x, dt, a, bb, cc, _, _, dy, _ = (_t(v) for v in _inputs(
        rng, 1, 20, 2, 16, 8, False, False, 1.0))
    x, bb, cc, dy = (t.to(dtype) for t in (x, bb, cc, dy))
    ssd_scan_bwd(x, dt, a, bb, cc, torch.zeros(1, 3, 2, 16, 8), dy,
                 chunk=8)
    argtypes, args = calls
    arr, n = args[-3], args[-2]
    got = [tuple((ctypes.c_int * 3).from_address(ctypes.addressof(arr)
                                                 + 12 * i)) for i in range(n)]
    assert got == [lg.grid for lg in bwd_module.ssd_scan_bwd_grid(
        1, 20, 2, 16, 8, 8, dtype)]
    assert len(args) == len(argtypes)
    assert argtypes[-3:] == ix.GRID_ARGTYPES + [ctypes.c_void_p]
    text = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    m = re.search(r'extern "C" int ssd_scan_bwd_launch\((.*?)\)\s*\{',
                  text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    assert params[-3:] == ["const int* grids", "int n_grids", "void* stream"]


# ------------------------------------------------------- on the card only


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
    """CUDA K4 backward through ``ops.ssd_with_state`` (``SsdScanFn``) =
    its plain version on the card, from the kernel's own chunk states, in
    the working dtype; max error relative to the largest magnitude of
    each reference gradient; two runs bit-equal."""
    b, s, h, p, n, q, init, valid, scale = CASES[case]
    x, dt, a, bb, cc, st, vm, dy, df = _inputs(rng, b, s, h, p, n, init,
                                               valid, scale)
    x, bb, cc, dy = (_t(v).to(cuda, dtype) for v in (x, bb, cc, dy))
    dt, a, df = (_t(v).to(cuda) for v in (dt, a, df))
    st = _t(st).to(cuda, dtype) if init else None
    vm = _t(vm).to(cuda) if valid else None
    dtm = torch.where(vm[..., None], dt, 0.0) if valid else dt

    def grads():
        leaves = [t.clone().requires_grad_() for t in (x, dt, a, bb, cc)]
        if init:
            leaves.append(st.clone().requires_grad_())
        y, fin = ssd_with_state(*leaves[:5], q, leaves[5] if init else None,
                                valid=vm)
        return torch.autograd.grad((y.float() * dy.float()).sum()
                                   + (fin.float() * df).sum(), leaves)
    before = bwd_module.launches
    got, again = grads(), grads()
    assert bwd_module.launches == before + 2
    states = k4.ssd_scan_states(x, dtm, a, bb, cc, chunk=q,
                                initial_state=st)[2]
    want = list(ssd_chunked_bwd_ref(x, dtm, a, bb, cc, states, dy, df,
                                    chunk=q))
    if valid:
        want[1] = want[1] * vm[..., None]
    for name, g, g2, w in zip(NAMES, got, again, want):
        assert torch.equal(g, g2), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * max(float(w.float().abs().max()), 1e-6), name
