"""The train step as one CUDA graph per batch signature, and AdamW's
update as one fused pass, on the CPU.

On the card ``make_train_step`` (and ``make_prm_step``) runs as a
``TrainGraph``: the first call of a batch signature warms up eagerly, the
second captures the body and every later one replays it; the CPU runs
the same body eagerly over the same static buffers. These tests hold
what capture needs to the CPU path at smoke widths: the static path
bit-equal to ``step.eager()`` (the same body on the CPU: a mismatch would
be state that leaks between the paths), a body with no host read of a
value (run under ``FakeTensorMode``, where any such read raises), static
outputs overwritten by the next call, one entry per batch signature, and
the binding to the first call's trees. The AdamW dispatcher takes the
plain update on the CPU, which is held to the reference's
``adamw_update`` per leaf within 1e-6 (fp32, two frameworks; bf16
params bit-equal), and the CUDA wrapper refuses what its kernel does not
take. The card's graph against its eager step and the fused kernel
against the plain update (bit-equal) are ``gpu`` tests, skipped here
(``chip_smoke.py`` phases 3 and 14 run them at full size).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import FAMILY_CONFIGS, tiny_config
from repro.training import optimizer as jax_opt
from repro_torch.configs import smoke
from repro_torch.core.prm import init_prm_head
from repro_torch.data import DataConfig, padded_batches, prm_batches
from repro_torch.data import tokenizer as tk
from repro_torch.kernels.adamw import adamw, ops
from repro_torch.kernels.adamw.ref import adamw_leaf_ref
from repro_torch.models import Model, ModelConfig
from repro_torch.training import (AdamWConfig, TrainGraph, adamw_update,
                                  init_opt_state, make_prm_step,
                                  make_train_step, train_lm, train_prm_head)
from repro_torch.training.optimizer import tree_leaves, update_scalars
from repro_torch.kernels.launches import launch_counts
from repro_torch.training.train_graph import batch_signature
from repro_torch.training.train_loop import to_batch

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FAMILIES = {"dense": None, "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "hymba-1.5b"}


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _model(which: str, device="cpu") -> Model:
    cfg = _port_cfg(tiny_config()) if FAMILIES[which] is None else \
        smoke(FAMILIES[which])
    return Model(cfg, device=device)


def _arrays(rng, cfg, b: int = 2, s: int = 24) -> dict:
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    out = {"labels": np.roll(toks, -1, 1),
           "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.multimodal:
        out["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = toks
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _clone(tree):
    return _map(tree, lambda t: t.clone())


def _assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _three_steps(step, params, opt, batches):
    metrics = []
    for batch in batches:
        _, _, m = step(params, opt, batch)
        metrics.append({k: v.clone() for k, v in m.items()})
    return metrics


# ------------------------------------------- (a) static path against eager


@pytest.mark.parametrize("which", sorted(FAMILIES))
def test_static_path_matches_eager_bit_for_bit(which):
    """Three steps through the step's static buffers against three of a
    second step inside ``eager()`` from the same weights and batches:
    params, mu, nu, the step count and every metric bit-equal (0 ulp)."""
    model = _model(which)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [to_batch(_arrays(rng, model.cfg), "cpu") for _ in range(3)]
    runs = []
    for eager in (False, True):
        p = _clone(params)
        opt = init_opt_state(p)
        step = make_train_step(model, AdamWConfig(**OPT))
        if eager:
            with step.eager():
                metrics = _three_steps(step, p, opt, batches)
        else:
            metrics = _three_steps(step, p, opt, batches)
        assert step.eager_runs == 3 and step.captures == 0
        assert step.replays == 0 and step.launches_run() == {}
        runs.append((p, opt, metrics))
    (pg, og, mg), (pe, oe, me) = runs
    _assert_trees_equal(pg, pe)
    _assert_trees_equal(og, oe)
    for a, b in zip(mg, me):
        assert a.keys() == b.keys() == {"loss", "aux_loss", "grad_norm"}
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert int(og["step"]) == 3


# ------------------------------------ (b) no host read of a value in a body


def _fake_tree(mode, tree):
    return _map(tree, mode.from_tensor)


BODY_FAMILIES = ("dense", "swa", "moe", "ssm", "hybrid", "vlm", "audio")


@pytest.mark.parametrize("family", BODY_FAMILIES)
def test_train_body_runs_on_fake_tensors(family):
    """The train step's body (forward with per-layer recompute, the
    gradient, the AdamW update and the metrics) runs with params, state
    and batch as fake tensors (``FakeTensorMode``: any host read of a
    value, the MoE dispatch's included, raises), and gives 0-d metrics;
    the real params and state are left bit-equal."""
    model = Model(_port_cfg(tiny_config(**FAMILY_CONFIGS[family])),
                  device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    kept = (_clone(params), _clone(opt))
    batch = to_batch(_arrays(np.random.default_rng(1), model.cfg), "cpu")
    step = make_train_step(model, AdamWConfig(**OPT))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        out = step.body(_fake_tree(mode, params), _fake_tree(mode, opt),
                        _fake_tree(mode, batch))
    assert set(out) == {"loss", "aux_loss", "grad_norm"}
    assert all(tuple(t.shape) == () for t in out.values())
    _assert_trees_equal(params, kept[0])
    _assert_trees_equal(opt, kept[1])


def test_prm_body_runs_on_fake_tensors():
    """The PRM head's step body (the frozen LM's hidden states, the BCE,
    its gradient and the SGD update) on fake tensors: no host read."""
    model = Model(_port_cfg(tiny_config(vocab_size=tk.VOCAB_SIZE)),
                  device="cpu")
    lm = model.init_params(torch.Generator().manual_seed(0))
    head = init_prm_head(torch.Generator().manual_seed(1),
                         model.cfg.d_model)
    toks, labels, mask = next(prm_batches(DataConfig(batch_size=2,
                                                     seq_len=32)))
    batch = to_batch({"tokens": toks, "labels": labels, "mask": mask},
                     "cpu")
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        step = make_prm_step(model, _fake_tree(mode, lm))
        out = step.body(_fake_tree(mode, head), None,
                        _fake_tree(mode, batch))
    assert set(out) == {"prm_loss"} and tuple(out["prm_loss"].shape) == ()


# ------------------------------------------ (c) static outputs, signatures


def _dense_setup(seed: int = 0):
    model = _model("dense")
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, init_opt_state(params)


def test_kept_metric_is_overwritten_by_the_next_step():
    """A metric kept past the next call of the same signature is that
    call's value: the outputs are the step's static tensors."""
    model, params, opt = _dense_setup()
    step = make_train_step(model, AdamWConfig(**OPT))
    rng = np.random.default_rng(2)
    _, _, m1 = step(params, opt, to_batch(_arrays(rng, model.cfg), "cpu"))
    kept, first = m1["loss"], float(m1["loss"])
    _, _, m2 = step(params, opt, to_batch(_arrays(rng, model.cfg), "cpu"))
    assert m2["loss"] is kept and float(kept) == float(m2["loss"])
    assert float(kept) != first


def test_each_batch_signature_gets_its_own_entry():
    """A batch of another shape (or dtype) is another signature, with its
    own static buffers and outputs; the first signature's entry is
    reused when its shape comes back."""
    model, params, opt = _dense_setup()
    step = make_train_step(model, AdamWConfig(**OPT))
    rng = np.random.default_rng(3)
    long_batch = to_batch(_arrays(rng, model.cfg, s=24), "cpu")
    short_batch = to_batch(_arrays(rng, model.cfg, s=16), "cpu")
    _, _, m_long = step(params, opt, long_batch)
    _, _, m_short = step(params, opt, short_batch)
    step(params, opt, long_batch)
    assert len(step.signatures) == 2
    sigs = step.signatures
    assert sigs[batch_signature(long_batch)].eager_runs == 2
    assert sigs[batch_signature(short_batch)].eager_runs == 1
    assert m_long["loss"] is not m_short["loss"]
    assert tuple(sigs[batch_signature(short_batch)].batch["tokens"].shape) \
        == (2, 16)
    as_int32 = dict(long_batch, tokens=long_batch["tokens"].int())
    assert batch_signature(as_int32) != batch_signature(long_batch)


@pytest.mark.parametrize("other", ["params", "mu", "step"])
def test_another_tree_raises(other):
    """The step is bound to its first call's params and opt-state trees
    (its graphs write those leaves in place): a call with another tree
    raises, and moves nothing."""
    model, params, opt = _dense_setup()
    step = make_train_step(model, AdamWConfig(**OPT))
    batch = to_batch(_arrays(np.random.default_rng(4), model.cfg), "cpu")
    step(params, opt, batch)
    assert step.params is params and step.opt_state is opt
    p2, o2 = params, dict(opt)
    if other == "params":
        p2 = _clone(params)
    elif other == "mu":
        o2["mu"] = _clone(opt["mu"])
    else:
        o2["step"] = opt["step"].clone()
    before = (_clone(params), _clone(opt))
    with pytest.raises(ValueError, match="another params or opt-state"):
        step(p2, o2, batch)
    _assert_trees_equal(params, before[0])
    _assert_trees_equal(opt, before[1])


def test_train_lm_and_prm_head_run_through_one_entry():
    """``train_lm`` and ``train_prm_head`` run every step through the
    step they are given: one signature, one eager run a step on the CPU,
    the returned params the bound tree."""
    cfg = _port_cfg(tiny_config(vocab_size=tk.VOCAB_SIZE))
    model = Model(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(model, opt_cfg)
    params, hist = train_lm(model, padded_batches(DataConfig(
        batch_size=2, seq_len=32)), 4, opt_cfg, log_every=1, step_fn=step)
    assert len(step.signatures) == 1 and step.eager_runs == 4
    assert step.params is params and len(hist) == 4
    assert all(np.isfinite(r["loss"]) for r in hist)
    prm = make_prm_step(model, params, lr=1e-2)
    head, phist = train_prm_head(model, params, prm_batches(DataConfig(
        batch_size=2, seq_len=32)), 3, step_fn=prm)
    assert len(prm.signatures) == 1 and prm.eager_runs == 3
    assert prm.params is head and prm.opt_state is None
    assert np.isfinite(phist[-1]["prm_loss"])


def test_cpu_step_launches_no_kernel():
    """On the CPU the step's kernels are their plain versions: no
    wrapper's counter moves, and no graph is made."""
    model, params, opt = _dense_setup()
    step = make_train_step(model, AdamWConfig(**OPT))
    before = launch_counts()
    step(params, opt, to_batch(_arrays(np.random.default_rng(5),
                                       model.cfg), "cpu"))
    assert launch_counts() == before
    assert all(s.graph is None for s in step.signatures.values())
    assert isinstance(step, TrainGraph)


# ------------------------------------------------------------ (d) AdamW


def _leaf_inputs(rng, shape, dtype, seed_state: bool = True):
    p = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy((3 * rng.normal(size=shape)).astype(
        np.float32)).to(dtype)
    m = torch.from_numpy((0.1 * rng.normal(size=shape)).astype(np.float32))
    v = torch.from_numpy(np.abs(0.01 * rng.normal(size=shape)).astype(
        np.float32))
    if not seed_state:
        m.zero_()
        v.zero_()
    return p, g, m, v


def _scalars(clip: bool):
    return (torch.tensor(0.25 if clip else 1.0), torch.tensor(1e-3),
            torch.tensor(0.271), torch.tensor(0.1426))


HYPER = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)


def test_adamw_dispatcher_takes_the_plain_update_on_the_cpu(monkeypatch):
    """On CPU tensors ``ops.adamw_leaf`` is the plain loop body, bit for
    bit, and never reaches the CUDA wrapper (its counter stays)."""
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA wrapper was called on the CPU")
    monkeypatch.setattr(ops, "adamw_step", no_kernel)
    rng = np.random.default_rng(6)
    launched = adamw.launches
    for shape, dtype in (((3, 8), torch.bfloat16), ((8,), torch.float32)):
        a = _leaf_inputs(rng, shape, dtype)
        b = [t.clone() for t in a]
        ops.adamw_leaf(*a, *_scalars(True), **HYPER)
        adamw_leaf_ref(*b, *_scalars(True), **HYPER)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    tree = {"w": torch.ones(2, 3), "b": torch.ones(3)}
    adamw_update(AdamWConfig(), tree, _map(tree, torch.ones_like),
                 init_opt_state(tree))
    assert adamw.launches == launched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16,), (3, 16)])
def test_adamw_leaf_matches_reference(dtype, shape):
    """Three updates of one leaf through the port's ``adamw_update`` (the
    dispatcher's plain path) against the reference's: params, mu and nu
    within 1e-6 (fp32, two frameworks), bf16 params bit-equal; decay
    where ndim >= 2, clipped every step."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=shape).astype(np.float32)
    cfg = dict(lr=0.05, warmup_steps=1, total_steps=5, weight_decay=0.1,
               grad_clip=1.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {"w": jnp.asarray(w, jdt)}
    tp = {"w": torch.from_numpy(w).to(tdt)}
    js, ts = jax_opt.init_opt_state(jp), init_opt_state(tp)
    for _ in range(3):
        g = (5 * rng.normal(size=shape)).astype(np.float32)
        jp, js, _ = jax_opt.adamw_update(
            jax_opt.AdamWConfig(**cfg), jp, {"w": jnp.asarray(g, jdt)}, js)
        tp, ts, _ = adamw_update(AdamWConfig(**cfg), tp,
                                 {"w": torch.from_numpy(g).to(tdt)}, ts)
    ours = tp["w"].float().numpy()
    ref = np.asarray(jp["w"], np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    for k in ("mu", "nu"):
        np.testing.assert_allclose(ts[k]["w"].numpy(),
                                   np.asarray(js[k]["w"]), atol=1e-6,
                                   rtol=1e-6)


def test_update_scalars_advance_the_step():
    """``update_scalars`` advances the step once and returns 0-d fp32
    scalars on the state's device: what the fused kernel reads."""
    tree = {"w": torch.ones(2, 3)}
    state = init_opt_state(tree)
    gnorm, scalars = update_scalars(AdamWConfig(warmup_steps=0), tree, state)
    assert int(state["step"]) == 1
    assert float(gnorm) == pytest.approx(6 ** 0.5)
    assert all(s.dtype == torch.float32 and s.dim() == 0 for s in scalars)


def _refusal_case(case: str):
    rng = np.random.default_rng(8)
    p, g, m, v = _leaf_inputs(rng, (4, 8), torch.bfloat16)
    sc = list(_scalars(False))
    if case == "p_fp16":
        p = p.half()
    elif case == "g_fp64":
        g = g.double()
    elif case == "mu_bf16":
        m = m.bfloat16()
    elif case == "nu_fp64":
        v = v.double()
    elif case == "scalar_not_0d":
        sc[1] = sc[1].reshape(1)
    elif case == "scalar_fp64":
        sc[2] = sc[2].double()
    elif case == "shape":
        m = m[:, :4].contiguous()
    elif case == "non_contiguous":
        p = p.t().contiguous().t()
    elif case == "mixed_devices":
        g = g.to("meta")
    return (p, g, m, v, *sc)


REFUSALS = {"cpu": (ValueError, "CUDA"), "p_fp16": (TypeError, "fp32 or bf16"),
            "g_fp64": (TypeError, "fp32 or bf16"),
            "mu_bf16": (TypeError, "mu and nu"),
            "nu_fp64": (TypeError, "mu and nu"),
            "scalar_not_0d": (TypeError, "0-d fp32"),
            "scalar_fp64": (TypeError, "0-d fp32"),
            "shape": (ValueError, "shapes differ"),
            "non_contiguous": (ValueError, "contiguous"),
            "mixed_devices": (ValueError, "one CUDA device")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_adamw_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The CUDA wrapper raises on CPU tensors, mixed devices, dtypes other
    than fp32 / bf16 params and gradients and fp32 moments and scalars,
    shape mismatches and strided leaves; it never takes the plain path."""
    err, match = REFUSALS[case]
    launched = adamw.launches
    with pytest.raises(err, match=match):
        adamw.adamw_step(*_refusal_case(case), **HYPER)
    assert adamw.launches == launched


def test_adamw_bytes_count_each_operand_once():
    """The bound's bytes: p read and written, g read, mu and nu (fp32)
    read and written: 22 bytes a bf16 element, 28 an fp32 one."""
    bf = torch.empty(10, dtype=torch.bfloat16)
    f = torch.empty(10)
    assert adamw.adamw_bytes(bf, bf) == 220
    assert adamw.adamw_bytes(f, f) == 280


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which", sorted(FAMILIES))
def test_graph_matches_eager_on_card(cuda, which):
    """Three steps through the graph (warm-up, capture and replay,
    replay) against three inside ``eager()``: params, state and metrics
    bit-equal; one capture, two replays."""
    model = _model(which, device=cuda)
    params = model.init_params(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [to_batch(_arrays(rng, model.cfg), cuda) for _ in range(3)]
    runs = []
    for eager in (False, True):
        p = _clone(params)
        opt = init_opt_state(p)
        step = make_train_step(model, AdamWConfig(**OPT))
        if eager:
            with step.eager():
                metrics = _three_steps(step, p, opt, batches)
        else:
            metrics = _three_steps(step, p, opt, batches)
            assert step.captures == 1 and step.replays == 2
        runs.append((p, opt, metrics))
    (pg, og, mg), (pe, oe, me) = runs
    _assert_trees_equal(pg, pe)
    _assert_trees_equal(og, oe)
    for a, b in zip(mg, me):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("shape", [(1000,), (7, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_update_matches_plain_on_card(cuda, dtype, shape, clip):
    """The fused kernel against the plain loop body on the card, three
    updates from the same inputs: p, mu and nu bit-equal (0 ulp); odd
    sizes take the vector loop and the scalar tail."""
    rng = np.random.default_rng(9)
    a = [t.to(cuda) for t in _leaf_inputs(rng, shape, dtype)]
    b = [t.clone() for t in a]
    sc = [s.to(cuda) for s in _scalars(clip)]
    for _ in range(3):
        g = torch.from_numpy((3 * rng.normal(size=shape)).astype(
            np.float32)).to(cuda, dtype)
        a[1].copy_(g)
        b[1].copy_(g)
        adamw.adamw_step(*a, *sc, **HYPER)
        adamw_leaf_ref(*b, *sc, **HYPER)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
