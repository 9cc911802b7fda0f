"""The port's SSD chunked scan (kernel K4) on the CPU.

On a CPU tensor ``ops.ssd`` and ``ops.ssd_with_state`` run the plain
chunked scan (``ref.ssd_chunked``); it is held against the JAX package's
``ssd`` running the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it on the CPU), against the JAX chunked scan
``ssd_chunked`` with a state in and out, and against the naive recurrence,
on the same seeded numpy inputs: fp32 to atol=2e-4, the reference kernel
tests' tolerance for sums over chunks in another order; bf16 inputs to
0.15, theirs for bf16. The CUDA kernel runs only on a card (tests marked
``gpu``, skipped here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_naive
from repro.models.mamba2 import ssd_chunked as jax_chunked
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ssd_scan as k4
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_with_state
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref

ATOL = 2e-4


def _inputs(rng, b, s, h, p, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2, size=(h,)).astype(np.float32)
    bb = rng.normal(size=(b, s, h, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, h, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


KERNEL_SHAPES = [(2, 32, 3, 16, 8, 8), (1, 64, 2, 32, 16, 16),
                 (2, 40, 4, 8, 4, 16), (1, 16, 1, 64, 32, 4)]


@pytest.mark.parametrize("b,s,h,p,n,q", KERNEL_SHAPES)
def test_plain_k4_matches_pallas_kernel(rng, b, s, h, p, n, q):
    """The port's ``ssd`` (plain chunked scan on the CPU) = the JAX
    ``ssd`` through the Pallas kernel in interpret mode = both naive
    recurrences, at the reference kernel tests' shapes."""
    args = _inputs(rng, b, s, h, p, n)
    want = np.asarray(jax_ssd(*_j(*args), chunk=q))
    got = ssd(*_t(*args), chunk=q).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    naive = ssd_scan_ref(*_t(*args)).numpy()
    np.testing.assert_allclose(naive, np.asarray(jax_naive(*_j(*args))),
                               atol=ATOL)
    np.testing.assert_allclose(got, naive, atol=ATOL)


def test_plain_k4_nondivisible_s_matches_pallas_kernel(rng):
    """S = 13 under chunk 8: the plain version pads inside, like the
    Pallas wrapper."""
    args = list(_inputs(rng, 1, 13, 2, 8, 4))
    args[2] = -np.ones((2,), np.float32)
    want = np.asarray(jax_ssd(*_j(*args), chunk=8))
    got = ssd(*_t(*args), chunk=8).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("vl", [1, 7, 11, 16])
def test_plain_k4_masked_dt_matches_pallas_kernel(rng, vl):
    """Masked dt: the valid prefix of a right-padded sequence gives the
    Pallas kernel's outputs and the unpadded scan's, and the final state
    equals the unpadded scan's."""
    args = list(_inputs(rng, 2, 16, 2, 8, 4))
    args[2] = -np.ones((2,), np.float32)
    valid = np.arange(16)[None, :] < vl
    want = np.asarray(jax_ssd(*_j(*args), chunk=8, valid=jnp.asarray(valid)))
    got = ssd(*_t(*args), chunk=8, valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[:, :vl], want[:, :vl], atol=ATOL)
    x, dt, a, bb, cc = _t(*args)
    y_m, st_m = ssd_with_state(x, dt, a, bb, cc, 8,
                               valid=torch.from_numpy(valid))
    y_u, st_u = ssd_with_state(x[:, :vl], dt[:, :vl], a, bb[:, :vl],
                               cc[:, :vl], 8)
    np.testing.assert_allclose(y_m[:, :vl].numpy(), y_u.numpy(), atol=ATOL)
    np.testing.assert_allclose(st_m.numpy(), st_u.numpy(), atol=ATOL)


def test_plain_k4_bf16_matches_pallas_kernel(rng):
    """bf16 x, dt, b, c: the plain version against the Pallas kernel (fp32
    inside) and the fp32 naive recurrence, to the reference's 0.15."""
    x, dt, _, bb, cc = _inputs(rng, 1, 16, 2, 8, 4)
    a = -np.ones((2,), np.float32)
    jx, jdt, jb, jc = (jnp.asarray(t).astype(jnp.bfloat16)
                       for t in (x, dt, bb, cc))
    ker = np.asarray(jax_ssd(jx, jdt, jnp.asarray(a), jb, jc, chunk=8),
                     np.float32)
    tx, tdt, tb, tc = (torch.from_numpy(t).to(torch.bfloat16)
                       for t in (x, dt, bb, cc))
    got = ssd(tx, tdt, torch.from_numpy(a), tb, tc, chunk=8)
    assert got.dtype == torch.bfloat16
    naive = ssd_scan_ref(tx.float(), tdt.float(), torch.from_numpy(a),
                         tb.float(), tc.float()).numpy()
    np.testing.assert_allclose(got.float().numpy(), ker, atol=0.15)
    np.testing.assert_allclose(got.float().numpy(), naive, atol=0.15)


@pytest.mark.parametrize("s,q", [(24, 8), (13, 8), (32, 128)])
def test_state_in_and_out_match_jax_chunked(rng, s, q):
    """``ssd_with_state`` from a given state = the JAX ``ssd_chunked``
    with ``initial_state``: outputs and final state (S=32 under chunk 128
    is the serving lane's shape: one partial chunk)."""
    args = _inputs(rng, 2, s, 3, 16, 8)
    init = rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
    jy, jst = jax_chunked(*_j(*args), chunk=q,
                          initial_state=jnp.asarray(init))
    y, st = ssd_with_state(*_t(*args), q, torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=ATOL)


def test_all_invalid_rows_keep_their_state_bit_exactly(rng):
    """dt = 0 everywhere: the state passes through bit for bit."""
    x, dt, a, bb, cc = _t(*_inputs(rng, 2, 8, 4, 16, 8))
    init = torch.from_numpy(rng.normal(size=(2, 4, 16, 8)).astype(
        np.float32))
    _, st = ssd_with_state(x, dt, a, bb, cc, 8, init,
                           valid=torch.zeros((2, 8), dtype=torch.bool))
    assert torch.equal(st, init)


def test_k4_wrapper_refuses_cpu_tensors(rng):
    """The CUDA wrapper never computes on the CPU; only the dispatcher
    routes CPU tensors to the plain version."""
    x, dt, a, bb, cc = _t(*_inputs(rng, 1, 8, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        k4.ssd_scan(x, dt, a, bb, cc, chunk=8)


def test_k4_serving_widths_fit_one_cta():
    """mamba2-130m's chunk lane (Q = N = 128, P = 64) and hymba-1.5b's
    (N = 16) fit one CTA's shared memory in both dtypes; a CTA holds one
    16-column slice of P, so P = 128, which the one-CTA-per-head layout
    could not hold, fits at the same size; the kernel source is built."""
    for dtype in (torch.bfloat16, torch.float32):
        for p, n in ((64, 128), (64, 16), (128, 128)):
            assert k4.smem_bytes(128, p, n, 2048, dtype) <= k4.MAX_SMEM
        assert k4.smem_bytes(128, 128, 128, 2048, dtype) == \
            k4.smem_bytes(128, 64, 128, 2048, dtype)
    assert "ssd_scan" in build.SOURCES
    assert (build.CSRC / "ssd_scan.cu").exists()


def _ssm_widths():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _FALLBACK_FAMILIES
    out = {name: (c.ssm_head_dim, c.ssm_state, c.ssm_chunk)
           for name, c in ((n, get_config(n))
                           for n in ("mamba2-130m", "hymba-1.5b"))}
    for fam in ("ssm", "hybrid"):
        f = _FALLBACK_FAMILIES[fam]
        out[f"fallback-{fam}"] = (f["ssm_head_dim"], f["ssm_state"],
                                  f["ssm_chunk"])
    return out


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b",
                                  "fallback-ssm", "fallback-hybrid"])
def test_k4_geometry_fits_the_card(name):
    """The redesigned K4's geometry at each served SSM width: one CTA per
    16-column slice of P (4 per head at P = 64, 2 at the fallbacks' 32),
    shared memory within the card's 227 KB at the serving lanes (32 and
    64 rows) and at a long exact-length admission (2,048 positions) in
    both dtypes, and small enough at a 32-row lane in bf16 that four CTAs
    share an SM."""
    p, n, chunk = _ssm_widths()[name]
    assert k4.ctas_per_head(p) == -(-p // 16)
    for dtype in (torch.bfloat16, torch.float32):
        for s in (32, 64, 2048):
            assert 0 < k4.smem_bytes(chunk, p, n, s, dtype) <= k4.MAX_SMEM
    assert 4 * k4.smem_bytes(chunk, p, n, 32) <= k4.MAX_SMEM
    # sized by the rows present, not by the chunk
    assert k4.smem_bytes(chunk, p, n, 16) <= k4.smem_bytes(chunk, p, n,
                                                           chunk)


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
@pytest.mark.parametrize("b,s,h,p,n,q", KERNEL_SHAPES
                         + [(2, 64, 24, 64, 128, 128)])
def test_k4_matches_plain_on_card(cuda, rng, b, s, h, p, n, q, dtype, tol):
    """CUDA K4 = the plain chunked scan computed in fp32 on the same
    inputs, outputs and final state, from a given state."""
    x, dt, a, bb, cc = (t.to(cuda) for t in _t(*_inputs(rng, b, s, h, p,
                                                         n)))
    init = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(
        np.float32)).to(cuda)
    x, bb, cc, init_d = (t.to(dtype) for t in (x, bb, cc, init))
    y, st = k4.ssd_scan(x, dt, a, bb, cc, chunk=q, initial_state=init_d)
    y_r, st_r = ssd_chunked(x.float(), dt, a, bb.float(), cc.float(), q,
                            init_d.float())
    torch.testing.assert_close(y.float(), y_r, atol=tol, rtol=tol)
    torch.testing.assert_close(st.float(), st_r, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_k4_long_row_matches_plain_on_card(cuda, rng, dtype, tol):
    """CUDA K4 over one row of 2,048 positions at mamba2-130m's widths (16
    chunks of 128: the double-buffered chunk loop) = the plain chunked
    scan in fp32, outputs and final state, from a given state."""
    b, s, h, p, n, q = 1, 2048, 24, 64, 128, 128
    x, dt, a, bb, cc = (t.to(cuda) for t in _t(*_inputs(rng, b, s, h, p,
                                                         n)))
    init = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(
        np.float32)).to(cuda)
    x, bb, cc, init_d = (t.to(dtype) for t in (x, bb, cc, init))
    y, st = k4.ssd_scan(x, dt, a, bb, cc, chunk=q, initial_state=init_d)
    y_r, st_r = ssd_chunked(x.float(), dt, a, bb.float(), cc.float(), q,
                            init_d.float())
    torch.testing.assert_close(y.float(), y_r, atol=tol, rtol=tol)
    torch.testing.assert_close(st.float(), st_r, atol=tol, rtol=tol)


def test_batched_lanes_are_bit_exact_with_single_lanes(rng):
    """The scan is independent across batch rows: three lanes scanned
    together give each lane's outputs and final state of that lane scanned
    alone, bit for bit (what lets the mixed step batch its chunk lanes)."""
    x, dt, a, bb, cc = _t(*_inputs(rng, 3, 12, 4, 16, 8))
    init = torch.from_numpy(rng.normal(size=(3, 4, 16, 8)).astype(
        np.float32))
    valid = torch.arange(12)[None, :] < torch.tensor([12, 5, 9])[:, None]
    y, st = ssd_with_state(x, dt, a, bb, cc, 8, init, valid)
    for r in range(3):
        sl = slice(r, r + 1)
        y1, st1 = ssd_with_state(x[sl], dt[sl], a, bb[sl], cc[sl], 8,
                                 init[sl], valid[sl])
        assert torch.equal(y[sl], y1) and torch.equal(st[sl], st1)
