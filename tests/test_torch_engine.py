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
                                   "chunked_prefill_off"])
def test_later_slices_raise(later):
    """Families and options of later slices raise NotImplementedError
    instead of running a half-ported path."""
    kw, ecfg = {}, {}
    if later in FAMILY_CONFIGS:
        kw = FAMILY_CONFIGS[later]
    else:
        ecfg = dict(chunked_prefill=False)
    cfg = ModelConfig(**dataclasses.asdict(tiny_config(**kw)))
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(model, {"layers": {}}, EngineConfig(**ecfg))


# ------------------------------------------ prefix cache and tree decode

CACHE_TREE = {"cache": dict(prefix_cache=True),
              "tree": dict(decode_kernel="tree"),
              "cache_tree": dict(prefix_cache=True, decode_kernel="tree")}


def _header_requests(eng, steps=6, warm_lane=True):
    """A cold request (an 8-token header + 7 of its own, a partial last
    page) forks 3 branches; a warm request sharing the header rides the
    decode steps as a chunk lane (or, without ``warm_lane``, prefills
    alone, so a warm hit's fewer chunks do not shift the decode steps)
    and forks 2 more; a mid-generation fork joins the group. Returns
    (tokens, both prefill logits, live rows' hidden, the K/V of every
    live branch, the warm request's cached tokens)."""
    header = [2, 5, 9, 13, 7, 3, 11, 4]
    cold, warm = header + [8, 6, 10, 12, 3, 7, 9], header + [14, 6, 2]
    blocks, lg_cold, _ = eng.prefill(cold)
    hs = [eng.spawn_branch(0, blocks, lg_cold, None, len(cold),
                           prompt_tokens=cold) for _ in range(3)]
    for _ in range(steps):
        eng.decode_step()
    st = eng.begin_prefill(warm)
    while not st.done:
        if warm_lane:
            eng.decode_step()
        else:
            eng._advance_chunks([st], piggyback=False)
    b2, lg_warm, _ = eng.finish_prefill(st)
    hs += [eng.spawn_branch(1, b2, lg_warm, None, len(warm),
                            prompt_tokens=warm) for _ in range(2)]
    hs.append(eng.fork_branch(hs[0]))
    for _ in range(steps):
        eng.decode_step()
    kv = [_kv_of(eng, h.blocks) for h in hs]
    out = ([list(h.tokens) for h in hs], [_np(lg_cold), _np(lg_warm)],
           _np(eng._last_hidden)[[h.slot for h in hs]], kv, st.cached_tokens)
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    eng.release_prefix(b2)
    assert eng.allocator.used_pages == 0
    eng.allocator.check_invariants()
    return out


def _kv_of(eng, blocks):
    """The K/V a branch's pages hold over its length, [L, kv, n, hd]."""
    ps = eng.cfg.page_size
    out = []
    for key in ("k_pages", "v_pages"):
        pages = _np(eng.state[key]) if isinstance(eng.state[key],
                                                  torch.Tensor) \
            else np.asarray(eng.state[key], np.float32)
        g = pages[:, :, blocks.pages]                 # [L, kv, n, ps, hd]
        g = g.reshape(g.shape[0], g.shape[1], -1, g.shape[-1])
        out.append(g[:, :, :blocks.length])
    return out


@pytest.mark.parametrize("mode", sorted(CACHE_TREE))
def test_cache_and_tree_match_jax(mode):
    """Port vs JAX with the prefix cache, tree decode, or both: equal
    greedy tokens and warm hits, logits and hidden states within 1e-4."""
    je, te = _pair(max_slots=8, **CACHE_TREE[mode])
    jt, jl, jh, _, jc = _header_requests(je)
    tt, tl, th, _, tc = _header_requests(te)
    assert tt == jt
    assert tc == jc
    if "prefix_cache" in CACHE_TREE[mode]:
        assert tc == 8
        assert te.prefix_cache_stats() == je.prefix_cache_stats()
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.decode_steps_executed == je.decode_steps_executed


@pytest.mark.parametrize("mode", sorted(CACHE_TREE))
def test_cache_and_tree_bit_exact_within_the_port(mode):
    """Cache on vs off and tree on vs off give the same tokens, logits,
    hidden states and K/V bytes, bit for bit (the plain tree version
    rebuilds the per-branch tables; warm pages hold the very K/V the cold
    prefill wrote). The tree alone keeps seeded stochastic sampling
    bit-exact; with the cache, a warm hit runs fewer steps and so draws
    fewer random numbers, so those modes decode greedily."""
    temperature = 0.8 if mode == "tree" else 0.0

    def port(**kw):
        cfg = tiny_config()
        tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
        tp = tm.init_params(torch.Generator().manual_seed(5))
        return Engine(tm, tp, EngineConfig(
            page_size=4, num_pages=96, max_slots=8, max_pages_per_branch=16,
            prefill_chunk=8, seed=3,
            sampling=SamplingParams(temperature=temperature), **kw))
    bt, bl, bh, bkv, bc = _header_requests(port(), warm_lane=False)
    t, lg, hid, kv, c = _header_requests(port(**CACHE_TREE[mode]),
                                         warm_lane=False)
    assert t == bt
    assert c == (8 if "prefix_cache" in CACHE_TREE[mode] else 0) and bc == 0
    for a, b in zip(lg, bl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hid, bh)
    for (k, v), (bk, bv) in zip(kv, bkv):
        np.testing.assert_array_equal(k, bk)
        np.testing.assert_array_equal(v, bv)


def test_tree_groups_rows_across_requests():
    """Rows of two requests that share the cached header form one fork
    group of the tree map, whose span is the header's pages."""
    _, te = _pair(max_slots=8, prefix_cache=True, decode_kernel="tree")
    header = [2, 5, 9, 13, 7, 3, 11, 4]
    sts = []
    for tail in ([8, 6], [1, 9, 5]):    # the second admits warm
        sts.append(te.begin_prefill(header + tail))
        while te.has_pending_prefill:
            te.decode_step()
    assert sts[1].cached_tokens == 8
    hs = []
    for i, st in enumerate(sts):
        b, lg, _ = te.finish_prefill(st)
        hs += [te.spawn_branch(i, b, lg, None, len(st.prompt))
               for _ in range(2)]
    rg, _, sl, _ = te._tree_map([h.blocks for h in hs])
    assert len(set(rg.tolist())) == 1 and sl[rg[0]] == 8
    for h in hs:
        te.free_branch(h)
    for st in sts:
        te.release_prefix(st.blocks)
    assert te.allocator.used_pages == 0


def test_generated_prefix_resample_admits_warm():
    """A finished branch inserts prompt + generated full pages; re-admitting
    that trajectory serves the generated prefix from the very same pages
    (resurrected, never rewritten), and its logits agree with the JAX
    engine doing the same and with a cold port prefill (to 1e-4: the
    warm pages were written by decode steps, the cold ones by a chunked
    prefill, which sum in another order)."""
    prompt = [2, 5, 9, 13, 7, 3, 11, 4]
    outs = []
    for eng in _pair(prefix_cache=True):
        blocks, lg, _ = eng.prefill(prompt)
        h = eng.spawn_branch(0, blocks, lg, None, len(prompt),
                             prompt_tokens=prompt)
        for _ in range(10):
            eng.decode_step()
        gen = list(h.tokens)
        written = h.blocks.length - len(prompt)
        branch_pages = list(h.blocks.pages)
        eng.free_branch(h)
        eng.release_prefix(blocks)
        assert eng.allocator.used_pages == 0
        resample = prompt + gen[:written] + [95]
        probe = eng.match_cached_tokens(resample)
        res_before = eng.prefix_cache_stats()["resurrections"]
        st = eng.begin_prefill(resample)
        cap = (len(resample) - 1) // eng.cfg.page_size * eng.cfg.page_size
        assert st.cached_tokens == cap == probe > len(prompt)
        assert st.next_pos == st.cached_tokens
        n_cached = cap // eng.cfg.page_size
        assert st.blocks.pages[:n_cached] == branch_pages[:n_cached]
        assert eng.prefix_cache_stats()["resurrections"] - res_before \
            == n_cached
        while not st.done:
            eng.decode_step()
        b2, lg2, _ = eng.finish_prefill(st)
        eng.release_prefix(b2)
        eng.allocator.check_invariants()
        outs.append((gen, resample, _np(lg2)))
    (jgen, jres, jlg), (tgen, tres, tlg) = outs
    assert tgen == jgen and tres == jres
    np.testing.assert_allclose(tlg, jlg, **TOL)
    _, cold = _pair()
    _, lgc, _ = cold.prefill(tres)
    np.testing.assert_allclose(tlg, _np(lgc), **TOL)


@pytest.mark.parametrize("ecfg,match", [
    (dict(decode_kernel="tree", mixed_step_kernel="decode"),
     "decode_kernel='tree' requires"),
    (dict(prefix_cache=True, chunked_prefill=False),
     "prefix_cache requires chunked_prefill")])
def test_config_errors_match_jax(ecfg, match):
    """The reference's two configuration errors, raised before the port's
    not-ported check (chunked_prefill=False alone raises
    NotImplementedError)."""
    cfg = tiny_config()
    with pytest.raises(ValueError, match=match):
        JEngine(JModel(cfg), {}, JConfig(**ecfg))
    model = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    with pytest.raises(ValueError, match=match):
        Engine(model, {"layers": {}}, EngineConfig(**ecfg))


def test_step_variants_with_tree_match_jax():
    """With the tree on, the declared step shapes carry the map's four
    arrays at the reference's shapes."""
    je, te = _pair(step_token_budget=16, prefill_buckets=(4, 8),
                   decode_kernel="tree")
    jv, tv = je.step_variants(), te.step_variants()
    assert [(v.name, v.lane_buckets) for v in tv] == \
        [(v.name, v.lane_buckets) for v in jv]
    for j, t in zip(jv, tv):
        jtree = j.args[-1]
        assert sorted(jtree) == sorted(k for k in t.args
                                       if k in jtree) and len(jtree) == 4
        for key, sds in jtree.items():
            assert t.args[key] == (tuple(sds.shape), str(sds.dtype))
        for i, key in enumerate(("tokens", "positions", "block_tables",
                                 "lengths")):
            assert t.args[key][0] == tuple(j.args[i].shape)
    _, plain = _pair(step_token_budget=16, prefill_buckets=(4, 8))
    assert all("row_group" not in v.args for v in plain.step_variants())
