"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same weights (JAX ``init_params`` -> slash-keyed
numpy -> ``params_from_numpy``) and greedy sampling, and are driven by
the same calls. Tokens must be equal; prefill logits and the decode rows'
hidden states must agree to 1e-4 (fp32, two frameworks summing in
different orders through 2 layers and an LM head); both must return
every page. The port's CPU path runs the plain versions of K1/K2.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams

TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(cfg_kw=None, **ecfg):
    """(jax engine, port engine) over equal weights, greedy."""
    cfg = tiny_config(**(cfg_kw or {}))
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    tm.load_params(tp)
    base = dict(page_size=4, num_pages=96, max_slots=4,
                max_pages_per_branch=16, eos_id=1, seed=0, prefill_chunk=8)
    base.update(ecfg)
    je = JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0),
                                 **base))
    te = Engine(tm, tp, EngineConfig(sampling=SamplingParams(temperature=0.0),
                                     **base))
    return je, te


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _fork_and_decode(eng, prompt, n_branches, steps):
    blocks, logits, _ = eng.prefill(prompt)
    hs = [eng.spawn_branch(0, blocks, logits, None, len(prompt))
          for _ in range(n_branches)]
    for _ in range(steps):
        eng.decode_step()
    out = ([h.tokens for h in hs], _np(logits),
           _np(eng._last_hidden)[:n_branches])
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    return out


@pytest.mark.parametrize("family", ["dense", "dense_bias", "gemma_like",
                                    "nemotron_like", "stablelm_like"])
def test_forked_branches_match_jax(family):
    """Chunked admission of a 13-token prompt (chunks 8 + 5, a partial
    last page), three forked branches, 10 greedy steps across page
    boundaries with CoW of the shared partial page."""
    je, te = _pair(FAMILY_CONFIGS[family])
    prompt = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10, 12, 14]
    jt, jl, jh = _fork_and_decode(je, prompt, 3, 10)
    tt, tl, th = _fork_and_decode(te, prompt, 3, 10)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.allocator.used_pages == 0 == je.allocator.used_pages
    assert te.decode_steps_executed == je.decode_steps_executed
    assert te.mixed_steps_executed == je.mixed_steps_executed


def test_long_prompt_chunks_match_jax():
    """A prompt of 5 chunks (buckets 4 and 8, pos0 mid-page on every
    chunk after the first) gives the reference's last-position logits."""
    je, te = _pair(page_size=3)
    prompt = [int(x) for x in np.random.default_rng(3).integers(2, 97, 37)]
    jb, jl, _ = je.prefill(prompt)
    tb, tl, _ = te.prefill(prompt)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tb.pages == jb.pages and tb.length == jb.length
    assert te.prefill_chunk_steps == je.prefill_chunk_steps == 5
    assert te.prefill_compile_count == je.prefill_compile_count


def _drive_lanes(eng, prompts, steps):
    """One decoding request plus queued prefills riding its steps as
    chunk lanes; each finished prefill spawns a branch."""
    blocks, logits, _ = eng.prefill(prompts[0])
    hs = [eng.spawn_branch(0, blocks, logits, None, len(prompts[0]))]
    owned = [blocks]
    states = [eng.begin_prefill(p) for p in prompts[1:]]
    first_logits = []
    for _ in range(steps):
        eng.decode_step()
        for i, st in enumerate(states):
            if st.done and not st.harvested:
                b, lg, _ = eng.finish_prefill(st)
                owned.append(b)
                first_logits.append(_np(lg))
                hs.append(eng.spawn_branch(i + 1, b, lg, None,
                                           len(st.prompt)))
    out = ([h.tokens for h in hs], first_logits,
           (eng.mixed_steps_executed, eng.prefill_chunk_steps,
            eng.prefill_compile_count))
    for h in hs:
        eng.free_branch(h)
    for b in owned:
        eng.release_prefix(b)
    return out


def test_token_budget_lanes_match_jax():
    """step_token_budget=24 packs up to three chunk lanes per mixed step
    (one shared bucket); tokens, first-token logits and the lane
    counters equal the reference's."""
    je, te = _pair(step_token_budget=24, max_slots=6)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(2, 97, n)]
               for n in (6, 11, 19, 5, 9)]
    jt, jl, jc = _drive_lanes(je, prompts, 12)
    tt, tl, tc = _drive_lanes(te, prompts, 12)
    assert tt == jt
    assert tc == jc
    assert te.admission_capacity == je.admission_capacity == 3
    assert len(tl) == len(jl) == 4
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert te.allocator.used_pages == 0


def test_decode_fallback_matches_fused_and_jax():
    """mixed_step_kernel="decode" (K1 per chunk row) gives the fused
    path's results (K2 per lane), and the reference's decode path's."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    _, fused = _pair()
    je, dec = _pair(mixed_step_kernel="decode")
    ft, fl, fh = _fork_and_decode(fused, prompt, 2, 6)
    dt, dl, dh = _fork_and_decode(dec, prompt, 2, 6)
    jt, jl, _ = _fork_and_decode(je, prompt, 2, 6)
    assert ft == dt == jt
    np.testing.assert_allclose(dl, fl, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dh, fh, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dl, jl, **TOL)


def test_step_variants_match_jax():
    """Same declared step shapes: names and lane tuples."""
    je, te = _pair(step_token_budget=32, prefill_buckets=(4, 8))
    assert [(v.name, v.lane_buckets) for v in te.step_variants()] == \
        [(v.name, v.lane_buckets) for v in je.step_variants()]


def test_abort_and_harvest_ownership():
    """abort_prefill releases a queued state's pages; on a harvested
    state it only detaches (no double release)."""
    _, te = _pair()
    st = te.begin_prefill([2, 3, 4, 5, 6])
    assert te.allocator.used_pages == 2
    te.abort_prefill(st)
    assert te.allocator.used_pages == 0 and not te.has_pending_prefill
    blocks, logits, _ = te.prefill([2, 3, 4, 5, 6])
    st2 = te.begin_prefill([7, 8])
    while not st2.done:
        te.decode_step()
    b2, _, _ = te.finish_prefill(st2)
    te.abort_prefill(st2)
    assert te.allocator.refcount(b2.pages[0]) == 1
    te.release_prefix(b2)
    te.release_prefix(blocks)
    assert te.allocator.used_pages == 0


@pytest.mark.parametrize("later", ["ssm", "hybrid", "moe", "vlm", "audio",
                                   "prefix_cache", "tree",
                                   "chunked_prefill_off"])
def test_later_slices_raise(later):
    """Families and options of later slices raise NotImplementedError
    instead of running a half-ported path."""
    kw, ecfg = {}, {}
    if later in FAMILY_CONFIGS:
        kw = FAMILY_CONFIGS[later]
    elif later == "prefix_cache":
        ecfg = dict(prefix_cache=True)
    elif later == "tree":
        ecfg = dict(decode_kernel="tree")
    else:
        ecfg = dict(chunked_prefill=False)
    cfg = ModelConfig(**dataclasses.asdict(tiny_config(**kw)))
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(model, {"layers": {}}, EngineConfig(**ecfg))
