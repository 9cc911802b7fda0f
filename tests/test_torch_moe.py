"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed; the router and expert weights
are the JAX ``init_moe``'s, converted to torch. The configs are the smoke
variants of dbrx-132b and qwen3-moe-235b-a22b (4 experts, top-2, the
configs' own capacity factor 1.25), dbrx's also with
``norm_topk_prob=False``. fp32 throughout. Expert ids, ``keep`` masks,
sort orders and positions within an expert must be equal; gates, the
aux loss and outputs within 1e-5 (two frameworks summing in different
orders). The capacity binds where a case sets it to 8 at 40 rows: 80
assignments over 4 experts of 8 slots (the configs' own factor gives 32
slots there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke
from repro.models import moe as jmoe
from repro_torch.models import ModelConfig
from repro_torch.models import moe

TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = {
    "dbrx": smoke("dbrx-132b"),
    "dbrx_unnormed": smoke("dbrx-132b").replace(norm_topk_prob=False),
    "qwen3_moe": smoke("qwen3-moe-235b-a22b"),
}


def _setup(name, t, seed=0):
    """(jax cfg, port cfg, jax params, port params, x [t, D] numpy)."""
    jcfg = CONFIGS[name]
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).normal(
        size=(t, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("t", [5, 40])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_router_probs_match_jax(name, t):
    """Top-k expert ids equal, gates and the Switch aux loss within 1e-5;
    the gates sum to 1 with ``norm_topk_prob``."""
    jcfg, tcfg, jp, tp, x = _setup(name, t)
    jg, ji, jaux = jmoe.router_probs(jcfg, jp, jnp.asarray(x))
    tg, ti, taux = moe.router_probs(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), _np(jg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert tg.dtype == torch.float32
    if tcfg.norm_topk_prob:
        np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_capacity_matches_jax(name):
    """The capacity of every row count from 1 to 300 is the reference's
    (a multiple of 8, at least 8)."""
    jcfg, tcfg = CONFIGS[name], ModelConfig(**dataclasses.asdict(
        CONFIGS[name]))
    for t in range(1, 301):
        assert moe._capacity(tcfg, t) == jmoe._capacity(jcfg, t), t


def _dispatch_both(name, t, cap=None):
    jcfg, tcfg, jp, tp, x = _setup(name, t)
    jg, ji, _ = jmoe.router_probs(jcfg, jp, jnp.asarray(x))
    tg, ti, _ = moe.router_probs(tcfg, tp, torch.from_numpy(x))
    cap = cap or jmoe._capacity(jcfg, t)
    jbuf, jind = jmoe._dispatch(jcfg, jnp.asarray(x), jg, ji, cap)
    tbuf, tind = moe._dispatch(tcfg, torch.from_numpy(x), tg, ti, cap)
    return (jcfg, tcfg), (jbuf, jind), (tbuf, tind), cap


@pytest.mark.parametrize("t,cap", [(5, None), (12, None), (40, None),
                                   (40, 8)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dispatch_matches_jax(name, t, cap):
    """The sorted expert stream, each assignment's position within its
    expert, the ``keep`` mask and the token order are equal; the gates in
    stream order and the [E, C, D] buffer within 1e-5. At a capacity of 8
    for 40 rows it binds (some assignment is dropped), at the config's
    own it does not."""
    _, (jbuf, jind), (tbuf, tind), _ = _dispatch_both(name, t, cap)
    j_sorted, j_pos, j_keep, j_tok, j_gate = (np.asarray(a) for a in jind)
    t_sorted, t_pos, t_keep, t_tok, t_gate, _ = tind
    np.testing.assert_array_equal(t_sorted.numpy(), j_sorted)
    np.testing.assert_array_equal(t_pos.numpy(), j_pos)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    np.testing.assert_array_equal(t_tok.numpy(), j_tok)
    np.testing.assert_allclose(t_gate.numpy(), j_gate, **TOL)
    assert tuple(tbuf.shape) == tuple(jbuf.shape)
    np.testing.assert_allclose(_np(tbuf), _np(jbuf), **TOL)
    assert j_keep.all() == (cap is None)


@pytest.mark.parametrize("t,cap", [(12, None), (40, 8)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_combine_matches_jax(name, t, cap):
    """The same expert outputs (seeded), routed back through each
    package's own dispatch indices, give [T, D] within 1e-5, dropped
    assignments adding nothing."""
    _, (jbuf, jind), (_, tind), cap = _dispatch_both(name, t, cap)
    out = np.random.default_rng(4).normal(size=jbuf.shape).astype(
        np.float32)
    want = jmoe._combine(jnp.asarray(out), jind, t, jnp.float32)
    got = moe._combine(torch.from_numpy(out), tind, t, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_bit_equal_run_to_run(dtype):
    """Two runs of the combine over the same inputs give the same bits
    (no atomics: each token's k contributions are added in expert id
    order)."""
    _, (jbuf, _), (_, tind), _ = _dispatch_both("qwen3_moe", 40, 8)
    out = torch.from_numpy(np.random.default_rng(5).normal(
        size=jbuf.shape).astype(np.float32)).to(dtype)
    a = moe._combine(out, tind, 40, dtype)
    b = moe._combine(out.clone(), tind, 40, dtype)
    assert a.dtype == dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,s", [(1, 5), (2, 20)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_moe_matches_jax(name, b, s):
    """The whole layer, [B, S, D] in and out, and its aux loss."""
    jcfg, tcfg, jp, tp, x = _setup(name, b * s)
    x = x.reshape(b, s, -1)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_moe_matches_dense_eval_without_drops(name):
    """Where nothing is dropped (4 rows: at most 4 assignments per
    expert, capacity 8) the dispatch computes what every expert on every
    token does, and the port's dense version is the reference's."""
    jcfg, tcfg, jp, tp, x = _setup(name, 4)
    x = torch.from_numpy(x.reshape(2, 2, -1))
    _, ind = moe._dispatch(tcfg, x.reshape(4, -1),
                           *moe.router_probs(tcfg, tp, x.reshape(4, -1))[:2],
                           moe._capacity(tcfg, 4))
    assert bool(ind[2].all())
    y, _ = moe.apply_moe(tcfg, tp, x)
    dense = moe.apply_moe_dense_eval(tcfg, tp, x)
    np.testing.assert_allclose(_np(y), _np(dense), **TOL)
    want = jmoe.apply_moe_dense_eval(jcfg, jp, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(_np(dense), _np(want), **TOL)


def test_drops_change_the_output():
    """With the capacity binding (a factor of 0.25: 8 slots for 40
    rows), the dispatch differs from the dense version: the rows whose
    assignments were dropped lose them; it is still the reference's."""
    jcfg, tcfg, jp, tp, x = _setup("qwen3_moe", 40)
    jcfg = jcfg.replace(moe_capacity_factor=0.25)
    tcfg = tcfg.replace(moe_capacity_factor=0.25)
    assert moe._capacity(tcfg, 40) == 8
    xt = torch.from_numpy(x)[None]
    y, _ = moe.apply_moe(tcfg, tp, xt)
    want, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x)[None])
    np.testing.assert_allclose(_np(y), _np(want), **TOL)
    dense = moe.apply_moe_dense_eval(tcfg, tp, xt)
    assert not torch.allclose(y, dense, **TOL)


def test_init_moe_matches_jax_layout():
    """Keys, shapes and dtypes of the port's init are the reference's
    (router [D, E], experts [E, D, F] and [E, F, D], model dtype)."""
    jcfg = CONFIGS["qwen3_moe"]
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = moe.init_moe(torch.Generator().manual_seed(0), tcfg,
                      torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.bfloat16 for v in tp.values())


def test_bf16_layer_stays_bf16_and_near_fp32():
    """In bf16 the layer returns bf16 and stays near the fp32 layer on
    the same weights (within bf16 rounding, 5e-2), with the same
    experts chosen."""
    _, tcfg, _, tp, x = _setup("qwen3_moe", 12)
    xt = torch.from_numpy(x)[None]
    y32, _ = moe.apply_moe(tcfg, tp, xt)
    bf = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    y16, _ = moe.apply_moe(tcfg, bf, xt.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y16), _np(y32), atol=5e-2, rtol=5e-2)


# ------------------------------------------------- the shard-local dispatch


def _moe_cfg(**kw):
    """The reference test's MoE config (``tests/test_moe.py:_moe_cfg``)."""
    from conftest import tiny_config
    base = dict(arch_type="moe", d_ff=96, num_experts=4,
                num_experts_per_tok=2, moe_capacity_factor=4.0)
    base.update(kw)
    return tiny_config(**base)


def test_shard_local_dispatch_matches_dense_eval():
    """The reference's test on the port: the shard-local dispatch
    (``moe_dp_chunks() > 1``) keeps the routing, each group with its own
    capacity, and matches dense eval when nothing drops (atol 2e-5)."""
    from repro.models.moe import init_moe as jinit
    from repro_torch.distributed.logical import activation_rules

    jcfg = _moe_cfg(moe_capacity_factor=8.0)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = {k: torch.from_numpy(np.array(v))
         for k, v in jinit(jax.random.PRNGKey(0), jcfg).items()}
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (2, 16, cfg.d_model)), np.float32))
    ref = moe.apply_moe_dense_eval(cfg, p, x)
    with activation_rules(None, {"_moe_dp": 4}):
        y, _ = moe.apply_moe(cfg, p, x)
    np.testing.assert_allclose(_np(y), _np(ref), atol=2e-5)


@pytest.mark.parametrize("name,moe_dp", [("dbrx", 2), ("qwen3_moe", 4)])
def test_shard_local_dispatch_matches_jax(name, moe_dp):
    """``apply_moe`` under ``{"_moe_dp": G}`` against the reference's
    under the same rules, the weights carried across, fp32, at a
    capacity that binds within a group (64 rows in G groups): outputs and
    the aux loss within 1e-5."""
    from repro.distributed.logical import activation_rules as jrules
    from repro_torch.distributed.logical import activation_rules
    jcfg, tcfg, jp, tp, x = _setup(name, 64)
    x3 = x.reshape(2, 32, -1)
    with jrules(None, {"_moe_dp": moe_dp}):
        jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x3))
    with activation_rules(None, {"_moe_dp": moe_dp}):
        ty, taux = moe.apply_moe(tcfg, tp, torch.from_numpy(x3))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the groups' own capacity: not the global dispatch's result
    gy, _ = moe.apply_moe(tcfg, tp, torch.from_numpy(x3))
    assert not torch.equal(gy, ty)


def test_shard_local_dispatch_needs_divisible_rows():
    """With G not dividing the rows the dispatch stays global, as in the
    reference."""
    from repro_torch.distributed.logical import activation_rules
    _, tcfg, _, tp, x = _setup("dbrx", 15)
    x3 = torch.from_numpy(x.reshape(3, 5, -1))
    with activation_rules(None, {"_moe_dp": 4}):
        y, _ = moe.apply_moe(tcfg, tp, x3)
    g, _ = moe.apply_moe(tcfg, tp, x3)
    assert torch.equal(y, g)
