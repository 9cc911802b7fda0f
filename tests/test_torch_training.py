"""The port's training path (``repro_torch.training``, the losses,
``launch.train``) against the JAX package's on the CPU.

Both sides get the same inputs from one numpy seed; weights come from
JAX's ``init_params`` carried over with ``params_from_numpy``. Tolerances
(fp32, two frameworks summing in different orders):
  * the optimizer on given gradients, the schedule and the losses:
    atol=rtol=1e-6 (elementwise fp32 arithmetic in the same order);
  * three train steps (forward, backward through the plain K5 and K4 on
    the CPU, AdamW): loss and grad norm rtol 1e-5; every param atol 2e-5
    dense, 1e-4 ssm and hybrid, 2e-4 MoE. Adam divides each gradient by
    its own running scale, so an entry whose gradient is near zero moves
    by up to ~lr (1e-3) on a relative difference of its gradient; the
    chunked scan's sums in another order (measured: 1.9e-5 ssm, 4.1e-5
    hybrid) and the MoE's router (9.0e-5) give more such entries;
  * hidden states and the PRM head after SGD steps: 1e-4 / 1e-5;
  * checkpoints and their keys: bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.configs import smoke as jax_smoke
from repro.core import prm as jax_prm
from repro.data import DataConfig as JData
from repro.data import prm_batches as jax_prm_batches
from repro.models import Model as JModel
from repro.models import cross_entropy_loss as jax_ce
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_loop
from repro_torch.core import prm as torch_prm
from repro_torch.data import DataConfig, padded_batches, prm_batches
from repro_torch.data import tokenizer as tk
from repro_torch.launch import train as launch_train
from repro_torch.models import (Model, ModelConfig, cross_entropy_loss,
                                params_from_numpy)
from repro_torch.training import (AdamWConfig, adamw_update, hidden_states,
                                  init_opt_state, load_checkpoint,
                                  make_train_step, save_checkpoint,
                                  train_lm, train_prm_head)
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import _flatten
from repro_torch.training.optimizer import global_norm, schedule
from repro_torch.training.train_loop import to_batch

EXACT = dict(atol=1e-6, rtol=1e-6)


def _np(x):
    """A float32 numpy copy (never a view of a tensor's memory)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.array(x, np.float32)


def _flat_np(tree):
    return {k: _np(v) for k, v in _flatten(tree).items()}


def _stacked_tree(rng, layers=3, d=8):
    """A params tree shaped like the model's: stacked [L, ...] matrices,
    [L, D] norm scales and biases, an unstacked [D] final norm."""
    return {"layers": {"attn": {"wq": rng.normal(size=(layers, d, d)),
                                "bq": rng.normal(size=(layers, d))},
                       "norm1": {"scale": 1 + rng.normal(size=(layers, d))}},
            "embed": {"tok": rng.normal(size=(11, d))},
            "final_norm": {"scale": 1 + rng.normal(size=(d,))}}


def _flatten_tensors(tree):
    for v in tree.values():
        yield from (_flatten_tensors(v) if isinstance(v, dict) else (v,))


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("grad_clip", [1.0, 1e3])
def test_adamw_matches_reference_step_for_step(grad_clip):
    """Five steps on a stacked tree with fresh gradients each step:
    params, mu, nu, step and the reported grad norm equal the
    reference's. The [L, D] norm scales and biases are decayed (ndim >=
    2, the reference's rule on its stacked layers), the [D] final norm
    is not. grad_clip 1.0 clips every step, 1e3 never."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=8, weight_decay=0.1,
               grad_clip=grad_clip)
    tree = _map(_stacked_tree(rng), lambda a: a.astype(np.float32))
    jp = _map(tree, jnp.asarray)
    tp = _map(tree, lambda a: torch.from_numpy(a.copy()))
    js, ts = jax_opt.init_opt_state(jp), init_opt_state(tp)
    for _ in range(5):
        g = _map(_stacked_tree(rng), lambda a: (3 * a).astype(np.float32))
        jp, js, jn = jax_opt.adamw_update(jax_opt.AdamWConfig(**cfg), jp,
                                          _map(g, jnp.asarray), js)
        tp, ts, tn = adamw_update(AdamWConfig(**cfg), tp,
                                  _map(g, torch.from_numpy), ts)
        np.testing.assert_allclose(float(tn), float(jn), **EXACT)
        for name, a, b in (("params", tp, jp), ("mu", ts["mu"], js["mu"]),
                           ("nu", ts["nu"], js["nu"])):
            fa, fb = _flat_np(a), jax_ckpt._flatten(b)
            assert set(fa) == set(fb)
            for k in fb:
                np.testing.assert_allclose(fa[k], fb[k], **EXACT,
                                           err_msg=f"{name} {k}")
        assert int(ts["step"]) == int(js["step"])
    assert ts["mu"]["layers"]["attn"]["wq"].dtype == torch.float32


def test_weight_decay_follows_ndim_of_the_stacked_tree():
    """With zero gradients only decay moves a param: every leaf of ndim
    >= 2 (the [L, D] norm scales included) shrinks, the [D] final norm
    does not."""
    rng = np.random.default_rng(1)
    tp = _map(_stacked_tree(rng), lambda a: torch.from_numpy(
        a.astype(np.float32)))
    before = _flat_np(tp)
    grads = _map(tp, torch.zeros_like)
    adamw_update(AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5),
                 tp, grads, init_opt_state(tp))
    after = _flat_np(tp)
    for k in before:
        moved = not np.array_equal(before[k], after[k])
        assert moved == (before[k].ndim >= 2), k


def test_bf16_params_keep_their_dtype_with_fp32_moments():
    """A bf16 leaf is updated in fp32 and cast back, as the reference's
    ``(p - lr * delta).astype(p.dtype)``; mu and nu are fp32."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    g = rng.normal(size=(4, 8)).astype(np.float32)
    cfg = dict(lr=0.01, warmup_steps=0)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jp, js, _ = jax_opt.adamw_update(jax_opt.AdamWConfig(**cfg), jp,
                                     {"w": jnp.asarray(g, jnp.bfloat16)},
                                     jax_opt.init_opt_state(jp))
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    tp, ts, _ = adamw_update(AdamWConfig(**cfg), tp,
                             {"w": torch.from_numpy(g).to(torch.bfloat16)},
                             init_opt_state(tp))
    assert tp["w"].dtype == torch.bfloat16
    assert ts["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(_np(tp["w"]),
                                  np.asarray(jp["w"], np.float32))
    np.testing.assert_allclose(_np(ts["nu"]["w"]), np.asarray(js["nu"]["w"]),
                               **EXACT)


def test_schedule_matches_reference():
    """Warmup, the cosine and the floor past total_steps."""
    cfg = dict(lr=2.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.2)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        ours = float(schedule(AdamWConfig(**cfg), torch.tensor(step)))
        ref = float(jax_opt.schedule(jax_opt.AdamWConfig(**cfg),
                                     jnp.asarray(step)))
        assert ours == pytest.approx(ref, rel=1e-6, abs=1e-7), step


def test_grad_clip_caps_update_norm():
    """``tests/test_training.py``'s clip case: the raw norm is reported and
    the update stays within lr."""
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-9, warmup_steps=0,
                      weight_decay=0.0)
    params = {"w": torch.ones(4)}
    state = init_opt_state(params)
    _, _, gn = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)},
                            state)
    assert float(gn) > 1e5
    assert float((params["w"] - 1).abs().max()) <= 1.1
    assert float(global_norm({"a": torch.full((4,), 3.0)})) == 6.0


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    """fp32 log-softmax NLL; the masked mean divides by max(sum, 1), so an
    all-zero mask gives 0 (checked too)."""
    rng = np.random.default_rng(3)
    logits = (4 * rng.normal(size=(2, 7, 13))).astype(np.float32)
    labels = rng.integers(0, 13, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    ours = cross_entropy_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                 None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(ours), float(ref), **EXACT)
    if masked:
        zero = cross_entropy_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.zeros(2, 7))
        assert float(zero) == 0.0


@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_prm_head_loss_matches_reference(head):
    """The stable BCE on large logits too (|logit| up to ~60)."""
    rng = np.random.default_rng(4)
    d = 16
    if head == "mlp":
        p = {"w1": rng.normal(size=(d, 8)), "b1": rng.normal(size=(8,)),
             "w2": 20 * rng.normal(size=(8,)), "b2": np.float64(0.3)}
    else:
        p = {"w": 5 * rng.normal(size=(d,)), "b": np.float64(-0.2)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    hidden = rng.normal(size=(3, 5, d)).astype(np.float32)
    labels = (rng.random((3, 5)) < 0.5).astype(np.float32)
    ours = torch_prm.prm_head_loss(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(hidden), torch.from_numpy(labels))
    ref = jax_prm.prm_head_loss({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(hidden), jnp.asarray(labels))
    np.testing.assert_allclose(float(ours), float(ref), **EXACT)
    assert np.isfinite(float(ours))


def _both(cfg):
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(jax_ckpt._flatten(jp), device="cpu")
    tm.load_params(tp)
    return jm, jp, tm, tp


TRAIN_CASES = {"dense": None, "moe": "qwen3-moe-235b-a22b",
               "ssm": "mamba2-130m", "hybrid": "hymba-1.5b"}


@pytest.mark.parametrize("which", list(TRAIN_CASES))
def test_train_step_matches_reference(which):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches (a 0.8 mask): loss, aux loss and grad norm per step, and
    every param after the last, against the reference's jitted step.
    dense: ``tiny_config()``; moe: qwen3-moe-235b-a22b's smoke widths
    (4 experts top-2, the load-balance aux loss in the objective); ssm
    and hybrid: mamba2-130m's and hymba-1.5b's smoke widths (the chunked
    scan at chunk 16 over 24 positions, a partial last chunk; the hybrid's
    window attention beside it), differentiated through the plain scan on
    the CPU and through ``jax.grad`` of ``ssd_chunked`` in the
    reference."""
    cfg = tiny_config() if which == "dense" else \
        jax_smoke(TRAIN_CASES[which])
    jm, jp, tm, tp = _both(cfg)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_loop.make_train_step(jm, jax_opt.AdamWConfig(**ocfg)))
    tstep = make_train_step(tm, AdamWConfig(**ocfg))
    jo, to = jax_opt.init_opt_state(jp), init_opt_state(tp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        arrays = {"tokens": toks, "labels": np.roll(toks, -1, 1),
                  "mask": (rng.random((2, 24)) < 0.8).astype(np.float32)}
        jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
        jp, jo, jm_ = jstep(jp, jo, jbatch)
        tp, to, tm_ = tstep(tp, to, to_batch(arrays, "cpu"))
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    atol = {"dense": 2e-5, "ssm": 1e-4, "hybrid": 1e-4, "moe": 2e-4}[which]
    ours, ref = _flat_np(tp), jax_ckpt._flatten(jp)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), atol=atol,
                                   rtol=0, err_msg=k)
    # the model's bound weights are the updated tensors (no copy), and a
    # step leaves them as it found them: not requiring grad
    mixer, mat = ("attn", "wq") if "attn" in tp["layers"] else \
        ("mamba", "in_proj")
    bound = dict(tm.named_parameters())[f"weights.layers.{mixer}.{mat}"]
    assert bound.data_ptr() == tp["layers"][mixer][mat].data_ptr()
    assert not any(p.requires_grad for p in _flatten_tensors(tp))


def test_hidden_states_match_reference():
    """Final-norm hidden states of the layers' training forward."""
    jm, jp, tm, tp = _both(tiny_config(vocab_size=tk.VOCAB_SIZE))
    toks = next(prm_batches(DataConfig(batch_size=2, seq_len=40)))[0]
    ours = hidden_states(tm, tp, torch.from_numpy(toks).long())
    ref = jax_loop.hidden_states(jm, jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_train_prm_head_matches_reference(monkeypatch):
    """Four SGD steps of ``train_prm_head`` on the same frozen LM and
    batches, both heads started from the same numpy draw (the two
    packages' own initialisers draw from different generators): the loss
    history and the final head equal the reference's."""
    cfg = tiny_config(vocab_size=tk.VOCAB_SIZE)
    jm, jp, tm, tp = _both(cfg)
    rng = np.random.default_rng(5)
    head = {"w1": rng.normal(size=(cfg.d_model, 64)) / 8,
            "b1": np.zeros(64), "w2": rng.normal(size=(64,)) / 8,
            "b2": np.zeros(())}
    head = {k: np.asarray(v, np.float32) for k, v in head.items()}
    monkeypatch.setattr(jax_loop, "init_prm_head", lambda *a, **k: {
        n: jnp.asarray(v) for n, v in head.items()})
    monkeypatch.setattr(train_loop, "init_prm_head", lambda *a, **k: {
        n: torch.from_numpy(v.copy()) for n, v in head.items()})
    data = dict(batch_size=4, seq_len=64, seed=2)
    jh, jhist = jax_loop.train_prm_head(jm, jp, jax_prm_batches(JData(**data)),
                                        4, lr=0.05)
    th, thist = train_prm_head(tm, tp, prm_batches(DataConfig(**data)), 4,
                               lr=0.05)
    assert [r["step"] for r in thist] == [r["step"] for r in jhist]
    np.testing.assert_allclose([r["prm_loss"] for r in thist],
                               [r["prm_loss"] for r in jhist], atol=1e-5,
                               rtol=1e-5)
    for k in head:
        np.testing.assert_allclose(_np(th[k]), np.asarray(jh[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_checkpoints_cross_load(tmp_path):
    """A file written by either package loads in the other with the same
    keys and the same bits; ``like`` restores the structure, dtypes
    (bf16 leaves written as fp32 and cast back) and device."""
    jm, jp, tm, tp = _both(tiny_config())
    ours = os.path.join(tmp_path, "port.npz")
    theirs = os.path.join(tmp_path, "ref.npz")
    save_checkpoint(ours, tp)
    jax_ckpt.save_checkpoint(theirs, jp)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    back = load_checkpoint(theirs, like=tp)
    for k, v in _flatten(back).items():
        np.testing.assert_array_equal(v, np.asarray(jax_ckpt._flatten(jp)[k]))
    jback = jax_ckpt.load_checkpoint(ours, like=jp)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    half = {"a": {"w": torch.randn(3, 2).to(torch.bfloat16)},
            "b": [torch.arange(3), torch.ones(())]}
    save_checkpoint(os.path.join(tmp_path, "h.npz"), half)
    r = load_checkpoint(os.path.join(tmp_path, "h.npz"), like=half)
    assert r["a"]["w"].dtype == torch.bfloat16 and isinstance(r["b"], list)
    assert torch.equal(r["a"]["w"], half["a"]["w"])
    assert torch.equal(r["b"][0], half["b"][0])
    plain = load_checkpoint(os.path.join(tmp_path, "h.npz"))
    assert sorted(plain) == ["a", "b"] and sorted(plain["b"]) == ["0", "1"]


def test_lm_loss_decreases():
    """``tests/test_training.py:test_lm_loss_decreases`` on the port: 60
    steps on the synthetic task cut the loss by 20%."""
    cfg = tiny_config(vocab_size=tk.VOCAB_SIZE, d_model=96, d_ff=256)
    model = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    data = padded_batches(DataConfig(batch_size=16, seq_len=96, seed=0))
    _, hist = train_lm(model, data, steps=60,
                       opt_cfg=AdamWConfig(lr=2e-3, warmup_steps=10,
                                           total_steps=60),
                       log_every=59)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, hist


def test_launcher_trains_and_smokes_on_the_cpu(tmp_path, capsys):
    """``main`` with ``--device cpu``: a short reasoner run writes lm.npz,
    prm.npz and config.json that load back bit-equal; ``--arch X
    --smoke`` runs one finite train step of a smoke variant (MoE here)."""
    out = str(tmp_path / "r")
    launch_train.main(["--device", "cpu", "--steps", "3", "--prm-steps",
                       "2", "--out", out, "--d-model", "64"])
    params = load_checkpoint(os.path.join(out, "lm.npz"))
    again = load_checkpoint(os.path.join(out, "lm.npz"), like=params)
    for a, b in zip(_flatten(params).values(), _flatten(again).values()):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(out, "prm.npz"))
    launch_train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                       "--device", "cpu"])
    assert "train step ok" in capsys.readouterr().out


def test_k4_wrapper_refuses_grad():
    """The CUDA SSD scan (K4) is forward-only: an input that requires grad
    raises before any other check (here before the CPU-tensor refusal),
    rather than returning an output that carries no gradient."""
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    dt = torch.rand(1, 8, 2)
    a = -torch.rand(2)
    b = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    for grad_on in ("x", "dt", "a", "b"):
        args = {"x": x, "dt": dt, "a": a, "b": b, "c": b.clone()}
        args[grad_on] = args[grad_on].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="forward-only"):
            ssd_scan(**args, chunk=4)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_scan(x, dt, a, b, b, chunk=4,
                 initial_state=torch.zeros(1, 2, 16, 4, requires_grad=True))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, a, b, b, chunk=4)


def test_ssm_trains_on_the_cpu_through_the_plain_scan():
    """On the CPU the ssm mixer's scan is the plain version, which autograd
    differentiates: one train step gives the mixer's in-projection a
    nonzero gradient (on the card the scan is K4 through ``SsdScanFn``,
    its hand-written backward)."""
    tm = Model(ModelConfig(**dataclasses.asdict(tiny_config(
        arch_type="ssm", d_ff=0, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=8))), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, 97, (2, 16))
    from repro_torch.training.train_loop import lm_loss_fn, trainable
    with trainable(tp):
        total, _ = lm_loss_fn(tm, tp, to_batch({"tokens": toks,
                                                "labels": toks,
                                                "mask": np.ones((2, 16))},
                                               "cpu"))
        (g,) = torch.autograd.grad(total,
                                   [tp["layers"]["mamba"]["in_proj"]])
    assert float(g.abs().max()) > 0
