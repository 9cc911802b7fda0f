"""The port's Mamba2 mixer against the JAX package's, on the CPU.

Same seeded numpy inputs and the same weights (JAX ``init_mamba2`` ->
slash-keyed numpy -> ``params_from_numpy``) go through
``repro.models.mamba2`` and ``repro_torch.models.mamba2`` in fp32. The
scan-level functions agree to atol=2e-4 and the full mixer to 5e-4, the
tolerances ``tests/test_mamba2.py`` holds the JAX functions to against
each other (sums over chunks and a gated norm in another order); the conv
tail, a plain sum of W products, to 1e-5. The masked-dt identities the
reference pins bit-exact are pinned bit-exact in the port too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.models import Model as JModel
from repro.models import mamba2 as jm
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import mamba2 as tm

ATOL_SCAN = 2e-4
ATOL_MIXER = 5e-4


def _cfgs(**kw):
    base = dict(arch_type="ssm", d_ff=0, ssm_state=16, ssm_head_dim=32,
                ssm_chunk=8)
    base.update(kw)
    cfg = tiny_config(**base)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _params(jcfg, seed=0):
    jp = jm.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(_flatten(jp), device="cpu")


def _scan_inputs(rng, b=2, s=24, h=4, p=16, n=8):
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _leaves(tree, prefix=""):
    """A nested dict of tensors as {slash key: tensor}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        out.update(_leaves(v, key + "/") if isinstance(v, dict)
                   else {key: v})
    return out


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


# ------------------------------------------------------------ scan level


@pytest.mark.parametrize("chunk", [4, 8, 16, 24])
def test_ssd_chunked_matches_jax(rng, chunk):
    """Outputs and final state of the plain chunked scan, from a zero
    state and from a given one."""
    args = _scan_inputs(rng)
    init = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    for state in (None, init):
        jy, js = jm.ssd_chunked(*_j(*args), chunk=chunk,
                                initial_state=None if state is None
                                else jnp.asarray(state))
        ty, ts = tm.ssd_chunked(*_t(*args), chunk,
                                None if state is None else _t(state)[0])
        _close(ty, jy, ATOL_SCAN)
        _close(ts, js, ATOL_SCAN)


def test_segsum_matches_jax(rng):
    x = rng.normal(size=(3, 6)).astype(np.float32)
    _close(tm._segsum(_t(x)[0]), jm._segsum(jnp.asarray(x)), 1e-5)


def test_final_state_feeds_continuation(rng):
    """Splitting a sequence and carrying the state == one long scan."""
    x, dt, a, b, c = _t(*_scan_inputs(rng, s=32))
    full, final = tm.ssd_chunked(x, dt, a, b, c, 8)
    y1, s1 = tm.ssd_chunked(x[:, :16], dt[:, :16], a, b[:, :16], c[:, :16],
                            8)
    y2, s2 = tm.ssd_chunked(x[:, 16:], dt[:, 16:], a, b[:, 16:], c[:, 16:],
                            8, initial_state=s1)
    _close(torch.cat([y1, y2], 1), full, ATOL_SCAN)
    _close(s2, final, ATOL_SCAN)


def test_ssd_decode_step_matches_jax(rng):
    """One-token recurrence, with and without a validity mask."""
    x, dt, a, b, c = _scan_inputs(rng, b=3, s=1)
    state = rng.normal(size=(3, 4, 16, 8)).astype(np.float32)
    valid = np.asarray([True, False, True])
    for v in (None, valid):
        jy, js = jm.ssd_decode_step(
            jnp.asarray(state), *_j(x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0]),
            valid=None if v is None else jnp.asarray(v))
        ty, ts = tm.ssd_decode_step(
            *_t(state, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0]),
            valid=None if v is None else torch.from_numpy(v))
        _close(ty, jy, ATOL_SCAN)
        _close(ts, js, ATOL_SCAN)


def test_decode_step_matches_scan(rng):
    """Stepping the decode recurrence token by token == the naive scan."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    x, dt, a, b, c = _t(*_scan_inputs(rng, b=1, s=12))
    state = torch.zeros((1, 4, 16, 8))
    outs = []
    for t in range(12):
        y, state = tm.ssd_decode_step(state, x[:, t], dt[:, t], a, b[:, t],
                                      c[:, t])
        outs.append(y)
    _close(torch.stack(outs, 1), ssd_scan_ref(x, dt, a, b, c), ATOL_SCAN)


# ------------------------------------------------------------ masked dt


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("vl", [1, 5, 8, 13, 16])
def test_masked_scan_matches_unpadded_prefix(vl, chunk):
    """A right-padded sequence with a validity mask reproduces the
    unpadded scan (valid outputs and final state), and the JAX masked
    scan."""
    rng = np.random.default_rng(vl * 31 + chunk)
    args = _scan_inputs(rng, b=2, s=16)
    valid = np.arange(16)[None, :] < vl
    y_m, st_m = tm.ssd_chunked(*_t(*args), chunk,
                               valid=torch.from_numpy(valid))
    x, dt, a, b, c = _t(*args)
    y_u, st_u = tm.ssd_chunked(x[:, :vl], dt[:, :vl], a, b[:, :vl],
                               c[:, :vl], chunk)
    _close(st_m, st_u, ATOL_SCAN)
    _close(y_m[:, :vl], y_u, ATOL_SCAN)
    jy, js = jm.ssd_chunked(*_j(*args), chunk=chunk,
                            valid=jnp.asarray(valid))
    _close(st_m, js, ATOL_SCAN)
    _close(y_m[:, :vl], np.asarray(jy)[:, :vl], ATOL_SCAN)


def test_masked_scan_all_invalid_is_bit_exact_identity(rng):
    """dt == 0 everywhere: the carried state passes through bit-exactly."""
    x, dt, a, b, c = _t(*_scan_inputs(rng, b=2, s=8))
    init = _t(rng.normal(size=(2, 4, 16, 8)))[0]
    _, st = tm.ssd_chunked(x, dt, a, b, c, 8, initial_state=init,
                           valid=torch.zeros((2, 8), dtype=torch.bool))
    assert torch.equal(st, init)


def test_masked_decode_step_freezes_state(rng):
    """valid=[True, False]: the invalid row's state is bit-identical; the
    valid row matches the unmasked step bit for bit."""
    x, dt, a, b, c = _t(*_scan_inputs(rng, b=2, s=1))
    state = _t(rng.normal(size=(2, 4, 16, 8)))[0]
    _, st_u = tm.ssd_decode_step(state, x[:, 0], dt[:, 0], a, b[:, 0],
                                 c[:, 0])
    _, st_m = tm.ssd_decode_step(state, x[:, 0], dt[:, 0], a, b[:, 0],
                                 c[:, 0], valid=torch.tensor([True, False]))
    assert torch.equal(st_m[1], state[1])
    assert torch.equal(st_m[0], st_u[0])


# ---------------------------------------------------------- the full mixer


def test_causal_conv_matches_jax(rng):
    """The shifted-sum conv: outputs, and the conv tail from a zero start,
    from a given tail, and gathered per row at valid lengths."""
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    c = jm._conv_dim(jcfg)
    xbc = rng.normal(size=(3, 7, c)).astype(np.float32)
    tail = rng.normal(size=(3, jcfg.ssm_conv_width - 1, c)).astype(
        np.float32)
    vl = np.asarray([7, 2, 0], np.int32)
    for state, valid_len in ((None, None), (tail, None), (tail, vl)):
        jo, js = jm._causal_conv(
            jp, jnp.asarray(xbc), None if state is None else jnp.asarray(
                state), None if valid_len is None else jnp.asarray(valid_len))
        to, ts = tm._causal_conv(
            tp, _t(xbc)[0], None if state is None else _t(state)[0],
            None if valid_len is None else torch.from_numpy(valid_len))
        _close(to, jo, 1e-5)
        _close(ts, js, 1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_forward_matches_jax(rng, groups):
    """The mixer over a sequence: from a zero state, then continued from
    the returned states, with per-row valid lengths (group-broadcast B/C
    with 2 groups)."""
    jcfg, tcfg = _cfgs(ssm_groups=groups)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    jy, (jc, js) = jm.mamba2_forward(jcfg, jp, jnp.asarray(x))
    ty, (tc, ts) = tm.mamba2_forward(tcfg, tp, _t(x)[0])
    _close(ty, jy, ATOL_MIXER)
    _close(tc, jc, 1e-5)
    _close(ts, js, ATOL_MIXER)
    x2 = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    vl = np.asarray([9, 4], np.int32)
    jy2, (jc2, js2) = jm.mamba2_forward(jcfg, jp, jnp.asarray(x2),
                                        initial=(jc, js),
                                        valid_len=jnp.asarray(vl))
    ty2, (tc2, ts2) = tm.mamba2_forward(tcfg, tp, _t(x2)[0],
                                        initial=(tc, ts),
                                        valid_len=torch.from_numpy(vl))
    for r, n in enumerate(vl):
        _close(ty2[r, :n], np.asarray(jy2)[r, :n], ATOL_MIXER)
    _close(tc2, jc2, 1e-4)
    _close(ts2, js2, ATOL_MIXER)


def test_mamba2_decode_matches_jax(rng):
    """One-token mixer decode from random states, with a validity mask:
    outputs and both states agree with the reference; the invalid row
    keeps both states bit-identical."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    conv, ssd = jm.init_mamba2_state(jcfg, 3)
    conv = np.asarray(conv) + rng.normal(size=conv.shape).astype(np.float32)
    ssd = np.asarray(ssd) + rng.normal(size=ssd.shape).astype(np.float32)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    valid = np.asarray([True, False, True])
    jy, jc, js = jm.mamba2_decode(jcfg, jp, *_j(x, conv, ssd),
                                  valid=jnp.asarray(valid))
    tconv, tssd = _t(conv, ssd)
    ty, tc, ts = tm.mamba2_decode(tcfg, tp, _t(x)[0], tconv, tssd,
                                  valid=torch.from_numpy(valid))
    _close(ty[valid], np.asarray(jy)[valid], ATOL_MIXER)
    _close(tc, jc, 1e-5)
    _close(ts, js, ATOL_MIXER)
    assert torch.equal(tc[1], tconv[1]) and torch.equal(ts[1], tssd[1])


def test_mamba2_block_decode_matches_forward(rng):
    """Within the port: stepwise decode == the forward over the sequence,
    and the forward's states continue decoding."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = _t(rng.normal(size=(1, 20, tcfg.d_model)))[0]
    full, _ = tm.mamba2_forward(tcfg, tp, x)
    conv, ssd = tm.init_mamba2_state(tcfg, 1)
    outs = []
    for t in range(16):
        y, conv, ssd = tm.mamba2_decode(tcfg, tp, x[:, t:t + 1], conv, ssd)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), full[:, :16], ATOL_MIXER)
    _, (conv, ssd) = tm.mamba2_forward(tcfg, tp, x[:, :15])
    for t in range(15, 20):
        y, conv, ssd = tm.mamba2_decode(tcfg, tp, x[:, t:t + 1], conv, ssd)
    _close(y[:, 0], full[:, -1], ATOL_MIXER)


def test_mamba2_forward_valid_len_matches_unpadded(rng):
    """valid_len masking reproduces the unpadded forward's outputs AND
    both carried states (the conv tail comes from the valid stream)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = _t(rng.normal(size=(1, 12, tcfg.d_model)))[0]
    for vl in (1, 2, 7, 9, 12):
        y_m, (c_m, s_m) = tm.mamba2_forward(tcfg, tp, x, valid_len=vl)
        y_u, (c_u, s_u) = tm.mamba2_forward(tcfg, tp, x[:, :vl])
        _close(c_m, c_u, 1e-5)
        _close(s_m, s_u, ATOL_MIXER)
        _close(y_m[:, :vl], y_u, ATOL_MIXER)


def test_dt_does_not_depend_on_row_count(rng):
    """``_dt`` gives a row the same bits alone as among more rows: the CPU
    computes a tensor's SIMD body and its scalar tail differently, and the
    row count moves the tail."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    raw = _t(rng.normal(size=(2, 8, tcfg.ssm_heads)) * 3)[0]
    assert torch.equal(tm._dt(tp, raw[:1, :4]), tm._dt(tp, raw)[:1, :4])
    assert torch.equal(tm._dt(tp, raw[:1, 0]), tm._dt(tp, raw[:, 0])[:1])


def test_mamba2_forward_lane_is_independent_bit_exact(rng):
    """A lane's outputs and both states come out bit for bit the same when
    it runs alone at a short bucket as beside another lane at a longer
    one (the chunk lanes of one mixed step)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = _t(rng.normal(size=(2, 8, tcfg.d_model)))[0]
    init = [_t(rng.normal(size=(2,) + tuple(t.shape[1:])) * 0.1)[0]
            for t in tm.init_mamba2_state(tcfg, 1)]
    vl = torch.tensor([5, 1])
    y2, (c2, s2) = tm.mamba2_forward(tcfg, tp, x, init, vl)
    y1, (c1, s1) = tm.mamba2_forward(tcfg, tp, x[1:, :4],
                                     [t[1:] for t in init], vl[1:])
    assert torch.equal(y1[0, :1], y2[1, :1])
    assert torch.equal(c1[0], c2[1])
    assert torch.equal(s1[0], s2[1])


# ------------------------------------------------------------ the weights


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_bridge_keeps_reference_dtypes_in_bf16(family):
    """A bf16 JAX ``Model.init_params`` converted to the port keeps every
    leaf's dtype: fp32 norm scales and mixer ``a_log``/``dt_bias``, bf16
    for the rest; the port's own bf16 ``init_params`` makes the same
    tree with the same dtypes and shapes."""
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    jp = _flatten(JModel(cfg, dtype=jnp.bfloat16).init_params(
        jax.random.PRNGKey(0)))
    names = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
             jnp.dtype(jnp.float32): torch.float32}
    want = {k: names[jnp.dtype(v.dtype)] for k, v in jp.items()}
    assert want["layers/mamba/a_log"] == torch.float32
    assert want["layers/mamba/dt_bias"] == torch.float32
    got = _leaves(params_from_numpy(jp, device="cpu",
                                    dtype=torch.bfloat16))
    assert {k: v.dtype for k, v in got.items()} == want
    model = Model(ModelConfig(**dataclasses.asdict(cfg)),
                  dtype=torch.bfloat16, device="cpu")
    own = _leaves(model.init_params(torch.Generator().manual_seed(0)))
    assert {k: v.dtype for k, v in own.items()} == want
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_init_mamba2_matches_reference_layout():
    """``init_mamba2`` gives the reference's keys and shapes; a_log is the
    reference's deterministic log-linspace, dt_bias inverts a softplus in
    [exp(-4.6), exp(-2.3)]."""
    jcfg, tcfg = _cfgs()
    jp = jm.init_mamba2(jax.random.PRNGKey(0), jcfg)
    tp = tm.init_mamba2(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in _leaves(tp).items()} == \
        {k: tuple(v.shape) for k, v in _flatten(jp).items()}
    _close(tp["a_log"], jp["a_log"], 1e-6)
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt0 > 0.0099) & (dt0 < 0.101)).all())
