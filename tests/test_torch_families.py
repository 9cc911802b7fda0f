"""The families ported last — MoE (dbrx-132b, qwen3-moe-235b-a22b),
M-RoPE (qwen2-vl-72b) and sinusoidal positions (musicgen-medium) —
against the JAX package, on the CPU.

The position layers take numpy inputs drawn from a seed. ``Model`` and
the serving ``Engine`` run the configs' smoke variants (2 layers,
d_model 256, 4 experts top-2 at the configs' own capacity factor 1.25)
on the JAX ``init_params`` weights through the weight bridge, greedy.
fp32 throughout. Tolerances: 1e-5 for the position layers (one fp32
rounding of sin/cos apart; 3e-4 for sinusoidal embeddings out to
position 4,099, where the libraries' exp rounds a frequency one ulp
apart), 1e-4 for logits and hidden states (two
frameworks summing in different orders through 2 layers and an LM
head); tokens equal.

Under MoE a row's output depends on the other rows of its step: the
capacity counts every row, empty slots and chunk pad rows included, and
rows take it in row order. The port keeps that, and reads what the
reference reads for an empty slot (page ``num_pages - 1``, where the
reference's gather clamps the sentinel), so every row of the step,
empty ones included, matches the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.configs import smoke
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import layers
from repro_torch.serving import Engine, EngineConfig, SamplingParams

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_POS = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b", "qwen2-vl-72b",
         "musicgen-medium"]
PROMPT = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10, 12, 14]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _models(arch):
    """(jax model, jax params, port model, port params) of a smoke
    variant, equal weights."""
    cfg = smoke(arch)
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(_port_cfg(cfg), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    tm.load_params(tp)
    return jm, jp, tm, tp


def _engines(arch, **ecfg):
    """(jax engine, port engine) of a smoke variant, greedy."""
    jm, jp, tm, tp = _models(arch)
    base = dict(page_size=4, num_pages=96, max_slots=4,
                max_pages_per_branch=16, eos_id=1, seed=0, prefill_chunk=8)
    base.update(ecfg)
    return (JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0),
                                    **base)),
            Engine(tm, tp, EngineConfig(
                sampling=SamplingParams(temperature=0.0), **base)))


# ------------------------------------------------------- position layers


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_mrope_matches_jax(hd, rng):
    """Three distinct position streams (temporal, height, width), each
    rotating its own section of the frequencies, at head_dim 16 (the
    tests' vlm), 64 (the smoke variant) and 128 (qwen2-vl-72b)."""
    cfg = smoke("qwen2-vl-72b").replace(head_dim=hd)
    x = rng.normal(size=(2, 7, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7, 3)).astype(np.int32)
    want = jlayers.apply_mrope(cfg, jnp.asarray(x), jnp.asarray(pos))
    got = layers.apply_mrope(_port_cfg(cfg), torch.from_numpy(x),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_POS)


def test_mrope_of_equal_streams_is_rope(rng):
    """With the three streams equal, M-RoPE is 1-D RoPE."""
    cfg = _port_cfg(smoke("qwen2-vl-72b"))
    x = torch.from_numpy(rng.normal(size=(1, 5, 4, 64)).astype(np.float32))
    pos = torch.arange(5)[None] * 7
    got = layers.apply_mrope(cfg, x, layers.positions_for(cfg, pos))
    np.testing.assert_allclose(_np(got), _np(layers.apply_rope(cfg, x, pos)),
                               **TOL_POS)


def test_mrope_keeps_bf16(rng):
    """bf16 in, bf16 out, within bf16 rounding of the fp32 rotation."""
    cfg = _port_cfg(smoke("qwen2-vl-72b"))
    x = torch.from_numpy(rng.normal(size=(1, 5, 4, 64)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 99, (1, 5, 3)))
    got = layers.apply_mrope(cfg, x.to(torch.bfloat16), pos)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(layers.apply_mrope(cfg, x, pos)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dim", [64, 256, 1536])
def test_sinusoidal_embedding_matches_jax(dim):
    """Positions 0..4,099 and a [B, S] grid, at the tests' width, the
    smoke variant's and musicgen-medium's."""
    pos = np.arange(4100, dtype=np.int32)
    want = jlayers.sinusoidal_embedding(jnp.asarray(pos), dim)
    got = layers.sinusoidal_embedding(torch.from_numpy(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4100, dim)
    # the two libraries' fp32 exp may round a frequency one ulp apart
    # (at most 6e-8 here), which position 4,099 turns into 2.5e-4 of angle
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-4, rtol=0)
    grid = pos[:12].reshape(3, 4)
    np.testing.assert_allclose(
        _np(layers.sinusoidal_embedding(torch.from_numpy(grid), dim)),
        _np(jlayers.sinusoidal_embedding(jnp.asarray(grid), dim)),
        **TOL_POS)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_positions_for_matches_jax(family):
    """[B, S] positions become three equal streams for M-RoPE, stay as
    they are otherwise; [B, S, 3] ones are left alone."""
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    for p in (pos, np.stack([pos, pos + 1, pos + 2], -1)):
        want = jlayers.positions_for(cfg, jnp.asarray(p))
        got = layers.positions_for(_port_cfg(cfg), torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_matches_jax(arch):
    """``forward`` (logits and the MoE aux loss), ``prefill`` (last
    logits and the dense cache) and three ``decode_step``s (logits,
    hidden states, cache) of the smoke variant equal the reference's."""
    jm, jp, tm, tp = _models(arch)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 14)).astype(np.int32)
    jl, jaux = jm.forward(jp, tokens=jnp.asarray(toks))
    tl, aux = tm.forward(tp, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == tm.cfg.uses_moe
    jlg, jc = jm.prefill(jp, tokens=jnp.asarray(toks[:, :11]), max_len=32)
    tlg, tc = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :11]),
                         max_len=32)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    for t in range(11, 14):
        pos = np.full((2,), t, np.int32)
        jl2, jc, jh = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc,
                                     jnp.asarray(pos))
        tl2, tc, th = tm.decode_step(tp, torch.from_numpy(toks[:, t]), tc,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL)
        np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_embeds_inputs_match_jax(arch):
    """The stubbed frontends' path: ``embeds`` [B, S, D] in place of
    token ids, for vlm also with three distinct [B, S, 3] position
    streams; forward and prefill equal the reference's."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(3)
    emb = (rng.normal(size=(2, 9, jm.cfg.d_model)) * 0.02).astype(
        np.float32)
    kw_j, kw_t = {}, {}
    if jm.cfg.pos_embedding == "mrope":
        pos = np.stack([np.broadcast_to(np.arange(9), (2, 9)),
                        rng.integers(0, 4, (2, 9)),
                        rng.integers(0, 4, (2, 9))], -1).astype(np.int32)
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    jl, _ = jm.forward(jp, embeds=jnp.asarray(emb), **kw_j)
    tl, _ = tm.forward(tp, embeds=torch.from_numpy(emb), **kw_t)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jlg, jc = jm.prefill(jp, embeds=jnp.asarray(emb), max_len=16, **kw_j)
    tlg, tc = tm.prefill(tp, embeds=torch.from_numpy(emb), max_len=16,
                         **kw_t)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("slots", [4, 8, 16])
def test_moe_prefill_depends_on_max_slots_as_jax(slots):
    """The reference's MoE prefill logits of one prompt change with
    ``max_slots``: the empty slots ride every chunk step and take expert
    capacity first. The port gives the reference's logits at 4, 8 and 16
    slots, and they differ between slot counts in both."""
    je, te = _engines("qwen3-moe-235b-a22b", max_slots=slots)
    _, jl, _ = je.prefill(PROMPT)
    _, tl, _ = te.prefill(PROMPT)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # 16 and 32 slots give the same logits: the empty rows fill both of
    # their experts' capacity either way
    _, other = _engines("qwen3-moe-235b-a22b",
                        max_slots={4: 8, 8: 16, 16: 4}[slots])
    _, ol, _ = other.prefill(PROMPT)
    assert float(np.abs(_np(ol) - _np(tl)).max()) > 1e-2


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_empty_slot_rows_match_jax(arch):
    """Two branches in 16 slots, 8 greedy steps: every row of the step's
    hidden states, the 14 empty slots' included, is the reference's (an
    empty slot attends page ``num_pages - 1``, as the reference's clamped
    gather reads), so the experts' capacity sees the reference's rows."""
    je, te = _engines(arch, max_slots=16)
    hidden = []
    for eng in (je, te):
        blocks, lg, _ = eng.prefill(PROMPT)
        hs = [eng.spawn_branch(0, blocks, lg, None, len(PROMPT))
              for _ in range(2)]
        for _ in range(8):
            eng.decode_step()
        hidden.append((_np(eng._last_hidden), [h.tokens for h in hs]))
    (jh, jt), (th, tt) = hidden
    assert tt == jt
    np.testing.assert_allclose(th, jh, **TOL)


def test_weight_bridge_carries_moe_leaves():
    """``params_from_numpy`` carries the reference's ``layers/moe/*``
    leaves with their stacked shapes ([L, D, E] router, [L, E, D, F] and
    [L, E, F, D] experts) in the model dtype, norms in fp32, and a bf16
    model on them runs forward to finite logits."""
    jm, jp, _, _ = _models("qwen3-moe-235b-a22b")
    flat = _flatten(jp)
    tp = params_from_numpy(flat, device="cpu", dtype=torch.bfloat16)
    cfg = jm.cfg
    L, D, E, F = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    moe_p = tp["layers"]["moe"]
    assert {k: tuple(v.shape) for k, v in moe_p.items()} == {
        "router": (L, D, E), "w_up": (L, E, D, F), "w_gate": (L, E, D, F),
        "w_down": (L, E, F, D)}
    assert all(v.dtype == torch.bfloat16 for v in moe_p.values())
    assert tp["layers"]["norm2"]["scale"].dtype == torch.float32
    for key, arr in flat.items():
        if key.startswith("layers/moe/"):
            np.testing.assert_allclose(
                _np(moe_p[key.split("/")[-1]]), np.asarray(arr, np.float32),
                atol=1e-2, rtol=1e-2)
    model = Model(_port_cfg(cfg), dtype=torch.bfloat16, device="cpu")
    model.load_params(tp)
    logits, aux = model.forward(tp, tokens=torch.tensor([PROMPT]))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all()) and float(aux) > 0
