"""The port's ``Model`` (forward, prefill, decode_step over the dense
cache) against the JAX package's, on the CPU.

Both get the same weights (JAX ``init_params`` -> slash-keyed numpy ->
``params_from_numpy``) and the same seeded token ids. Logits, hidden
states and the caches they leave must agree to 1e-4 (fp32, two frameworks
summing in different orders through 2 layers and an LM head). The port's
full-sequence causal attention runs the plain version of K5 here. The
checks follow ``tests/test_model.py``: prefill's last logits equal
forward's, decode continues forward, several decode steps in a row;
sliding-window prompts longer than the window exercise the ring cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.models import Model as JModel
from repro.models.attention import attention_train as jax_attention_train
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import attention

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["dense", "swa", "ssm", "hybrid"]
# the gemma-like family at gemma-7b's head_dim of 256
WIDE = {"gemma256": dict(FAMILY_CONFIGS["gemma_like"], head_dim=256)}


def _both(family, **kw):
    """(jax model, jax params, port model, port params), equal weights."""
    cfg = tiny_config(**{**FAMILY_CONFIGS.get(family, WIDE.get(family, {})),
                         **kw})
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    tm.load_params(tp)
    return jm, jp, tm, tp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close_caches(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("family", FAMILIES + ["gemma_like", "gemma256"])
def test_forward_prefill_decode_match_jax(family):
    """B=2, S=20 (longer than the swa window of 8): forward logits,
    prefill's last logits and cache, one decode step's logits, hidden and
    cache equal the reference's; within the port prefill equals forward
    at S-2 and decode at S-1 (``tests/test_model.py:23``); forward's
    aux loss is the reference's (0 without MoE). Under MoE the within-port
    checks are left out: the capacity depends on the call's rows."""
    jm, jp, tm, tp = _both(family)
    B, S = 2, 20
    toks = _tokens(jm.cfg, B, S)
    jl, jaux = jm.forward(jp, tokens=jnp.asarray(toks))
    tl, aux = tm.forward(tp, tokens=torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == tm.cfg.uses_moe
    jlg, jcache = jm.prefill(jp, tokens=jnp.asarray(toks[:, :S - 1]),
                             max_len=64)
    tlg, tcache = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :S - 1]),
                             max_len=64)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    # under MoE the experts' capacity comes from the call's row count, so
    # prefill (B x (S-1) rows) and decode (B rows) need not repeat forward
    # (B x S rows), in the reference too
    moe = tm.cfg.uses_moe
    if not moe:
        np.testing.assert_allclose(_np(tlg), _np(tl)[:, S - 2], **TOL)
    _close_caches(tcache, jcache)
    pos = np.full((B,), S - 1, np.int32)
    jl2, jcache, jh = jm.decode_step(jp, jnp.asarray(toks[:, S - 1]), jcache,
                                     jnp.asarray(pos))
    tl2, tcache2, th = tm.decode_step(tp, torch.from_numpy(toks[:, S - 1]),
                                      tcache, torch.from_numpy(pos))
    assert tcache2 is tcache                      # updated in place
    np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    if not moe:
        np.testing.assert_allclose(_np(tl2), _np(tl)[:, S - 1], atol=5e-4)
    _close_caches(tcache, jcache)


@pytest.mark.parametrize("family", FAMILIES + ["gemma256"])
def test_multi_step_decode_matches_jax(family):
    """A 12-token prefill, then 6 decode steps fed the true next tokens:
    each step's logits equal the reference's step and the port's own
    forward (``tests/test_model.py:48``); the swa ring wraps twice."""
    jm, jp, tm, tp = _both(family)
    B, S, extra = 1, 12, 6
    toks = _tokens(jm.cfg, B, S + extra)
    tl, _ = tm.forward(tp, tokens=torch.from_numpy(toks))
    _, jcache = jm.prefill(jp, tokens=jnp.asarray(toks[:, :S]), max_len=64)
    _, tcache = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :S]),
                           max_len=64)
    for t in range(S, S + extra):
        jl2, jcache, _ = jm.decode_step(jp, jnp.asarray(toks[:, t]), jcache,
                                        jnp.full((B,), t))
        tl2, tcache, _ = tm.decode_step(tp, torch.from_numpy(toks[:, t]),
                                        tcache, torch.full((B,), t))
        np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tl2), _np(tl)[:, t], atol=1e-3,
                                   err_msg=f"step {t}")
    _close_caches(tcache, jcache)


def test_swa_ring_cache_wraps():
    """A 13-token prompt into a window-8 cache keeps the last 8 tokens
    rolled to their ring slots (``pos % 8``), as the reference's; greedy
    decoding from it gives the reference's tokens."""
    jm, jp, tm, tp = _both("swa")
    toks = _tokens(jm.cfg, 1, 13, seed=4)
    jlg, jcache = jm.prefill(jp, tokens=jnp.asarray(toks), max_len=64)
    tlg, tcache = tm.prefill(tp, tokens=torch.from_numpy(toks), max_len=64)
    assert tcache["k"].shape[2] == 8 == jcache["k"].shape[2]
    _close_caches(tcache, jcache)
    jt, tt = [int(jnp.argmax(jlg[0]))], [int(torch.argmax(tlg[0]))]
    for pos in range(13, 20):
        jl2, jcache, _ = jm.decode_step(jp, jnp.asarray([jt[-1]]), jcache,
                                        jnp.asarray([pos]))
        tl2, tcache, _ = tm.decode_step(tp, torch.tensor([tt[-1]]), tcache,
                                        torch.tensor([pos]))
        jt.append(int(jnp.argmax(jl2[0])))
        tt.append(int(torch.argmax(tl2[0])))
    assert tt == jt


@pytest.mark.parametrize("family,s", [("dense", 2100), ("swa", 2100)])
def test_long_sequence_attention_matches_jax(family, s):
    """Past the 2,048-token threshold: dense attention stays on K5's
    path, sliding-window attention takes the chunked formulation; both
    give the reference's ``attention_train``."""
    jm, jp, tm, tp = _both(family)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, s, jm.cfg.d_model)).astype(np.float32)
    pos = np.arange(s)[None]
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want = jax_attention_train(jm.cfg, lp, jnp.asarray(x), jnp.asarray(pos))
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    got = attention.attention_train(tm.cfg, tlp, torch.from_numpy(x),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kw,flash", [
    ({}, True), (dict(qkv_bias=True), True),
    (dict(sliding_window=8), False), (dict(attn_logit_softcap=30.0), False)])
def test_attention_dispatch_follows_the_config(monkeypatch, rng, kw, flash):
    """Plain causal attention goes through ``ops.flash_attention`` (K5 on
    the card), a window or a soft-cap through the ported ``_attend``; the
    choice depends on the config only. Either way the output is the
    reference's."""
    jm, jp, tm, tp = _both("dense", **kw)
    calls = []
    orig = attention.flash_attention

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(attention, "flash_attention", spy)
    x = rng.normal(size=(2, 11, jm.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    want = jax_attention_train(jm.cfg, lp, jnp.asarray(x), jnp.asarray(pos))
    got = attention.attention_train(tm.cfg, tlp, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert bool(calls) == flash


def test_segment_ids_match_jax(rng):
    """Packed sequences: the segment mask joins the causal one
    (``_attend``, never K5)."""
    jm, jp, tm, tp = _both("dense")
    x = rng.normal(size=(2, 10, jm.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).copy()
    seg = np.array([[0] * 4 + [1] * 6, [0] * 7 + [1] * 3], np.int32)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    want = jax_attention_train(jm.cfg, lp, jnp.asarray(x), jnp.asarray(pos),
                               segment_ids=jnp.asarray(seg))
    got = attention.attention_train(tm.cfg, tlp, torch.from_numpy(x),
                                    torch.from_numpy(pos),
                                    segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_init_cache_shapes_match_jax():
    """Cache keys, shapes and dtypes as the reference's, zeros."""
    for family in FAMILIES:
        jm, _, tm, _ = _both(family)
        jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert all(v.dtype == torch.float32 and not v.any()
                   for v in tc.values())


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_later_families_raise(family):
    """MoE layers, M-RoPE (vlm) and sinusoidal positions (audio), which
    raised ``NotImplementedError`` before they were ported, now run:
    forward (with the MoE aux loss), prefill and decode_step at the tiny
    widths give the reference's logits, hidden states and caches, as
    ``test_forward_prefill_decode_match_jax`` checks them."""
    test_forward_prefill_decode_match_jax(family)
