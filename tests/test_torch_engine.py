"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same weights (JAX ``init_params`` -> slash-keyed
numpy -> ``params_from_numpy``) and greedy sampling, and are driven by
the same calls. Tokens must be equal; prefill logits and the decode rows'
hidden states must agree to 1e-4 (fp32, two frameworks summing in
different orders through 2 layers and an LM head); both must return
every page. The port's CPU path runs the plain versions of K1/K2. The
forked-branch, exact and tree cases also run the smoke variants of the
MoE, vlm and audio configs (``repro.configs.smoke``: 2 layers, d_model
256, 4 experts top-2 at the configs' own capacity factor).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.configs import smoke
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams

TOL = dict(atol=1e-4, rtol=1e-4)
# the smoke variants of the MoE, vlm and audio configs
SMOKE = ["dbrx-132b", "qwen3-moe-235b-a22b", "qwen2-vl-72b",
         "musicgen-medium"]


def _pair(cfg_kw=None, cfg=None, **ecfg):
    """(jax engine, port engine) over equal weights, greedy: the tiny
    config with ``cfg_kw``, or ``cfg``."""
    cfg = cfg or tiny_config(**(cfg_kw or {}))
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
    blocks, logits, ssm = eng.prefill(prompt)
    hs = [eng.spawn_branch(0, blocks, logits, ssm, len(prompt))
          for _ in range(n_branches)]
    for _ in range(steps):
        eng.decode_step()
    out = ([h.tokens for h in hs], _np(logits),
           _np(eng._last_hidden)[:n_branches])
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    return out


def _family(name):
    """``_pair``'s config of a conftest family or a smoke variant."""
    if name in SMOKE:
        return dict(cfg=smoke(name))
    return dict(cfg_kw=FAMILY_CONFIGS[name])


@pytest.mark.parametrize("family", ["dense", "dense_bias", "gemma_like",
                                    "nemotron_like", "stablelm_like"]
                         + SMOKE)
def test_forked_branches_match_jax(family):
    """Chunked admission of a 13-token prompt (chunks 8 + 5, a partial
    last page), three forked branches, 10 greedy steps across page
    boundaries with CoW of the shared partial page."""
    je, te = _pair(**_family(family))
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
    blocks, logits, ssm = eng.prefill(prompts[0])
    hs = [eng.spawn_branch(0, blocks, logits, ssm, len(prompts[0]))]
    owned = [blocks]
    states = [eng.begin_prefill(p) for p in prompts[1:]]
    first_logits = []
    for _ in range(steps):
        eng.decode_step()
        for i, st in enumerate(states):
            if st.done and not st.harvested:
                b, lg, ssm = eng.finish_prefill(st)
                owned.append(b)
                first_logits.append(_np(lg))
                hs.append(eng.spawn_branch(i + 1, b, lg, ssm,
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


@pytest.mark.parametrize("later", ["moe", "vlm", "audio"])
def test_later_slices_raise(later):
    """The families that raised ``NotImplementedError`` before they were
    ported (MoE layers, M-RoPE, sinusoidal positions) now serve at the
    tiny widths: a 13-token prompt, three forked branches and 10 greedy
    steps give the reference's tokens, prefill logits and hidden states."""
    je, te = _pair(FAMILY_CONFIGS[later])
    prompt = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10, 12, 14]
    jt, jl, jh = _fork_and_decode(je, prompt, 3, 10)
    tt, tl, th = _fork_and_decode(te, prompt, 3, 10)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.allocator.used_pages == 0


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
    blocks, lg_cold, ssm_cold = eng.prefill(cold)
    hs = [eng.spawn_branch(0, blocks, lg_cold, ssm_cold, len(cold),
                           prompt_tokens=cold) for _ in range(3)]
    for _ in range(steps):
        eng.decode_step()
    st = eng.begin_prefill(warm)
    while not st.done:
        if warm_lane:
            eng.decode_step()
        else:
            eng._advance_chunks([st], piggyback=False)
    b2, lg_warm, ssm_warm = eng.finish_prefill(st)
    hs += [eng.spawn_branch(1, b2, lg_warm, ssm_warm, len(warm),
                            prompt_tokens=warm) for _ in range(2)]
    hs.append(eng.fork_branch(hs[0]))
    for _ in range(steps):
        eng.decode_step()
    kv = ([_kv_of(eng, h.blocks) for h in hs]
          if eng.model.cfg.uses_attention else [])
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


@pytest.mark.parametrize("mode", sorted(CACHE_TREE)
                         + [f"cache_tree@{arch}" for arch in SMOKE])
def test_cache_and_tree_match_jax(mode):
    """Port vs JAX with the prefix cache, tree decode, or both: equal
    greedy tokens and warm hits, logits and hidden states within 1e-4
    (``mode@arch``: on a smoke variant)."""
    mode, _, arch = mode.partition("@")
    je, te = _pair(**(_family(arch) if arch else {}), max_slots=8,
                   **CACHE_TREE[mode])
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
     "prefix_cache requires chunked_prefill"),
    (dict(step_token_budget=16, chunked_prefill=False),
     "step_token_budget requires chunked_prefill")])
def test_config_errors_match_jax(ecfg, match):
    """The reference's configuration errors, raised by the port too."""
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


# ------------------------------------------------ ssm and hybrid families

SSM_FAMILIES = ["ssm", "hybrid"]


def _slot_states(eng, hs):
    """The (conv, ssd) rows of the branches' slots, [L, n, ...] each."""
    slots = [h.slot for h in hs]
    return [_np(eng.state[k])[:, slots] for k in ("conv", "ssd")]


def _ssm_run(eng, prompt):
    """Chunked admission, three forked branches, 6 greedy steps, a
    mid-generation fork of the second branch, 4 more steps."""
    blocks, logits, ssm = eng.prefill(prompt)
    hs = [eng.spawn_branch(0, blocks, logits, ssm, len(prompt))
          for _ in range(3)]
    for _ in range(6):
        eng.decode_step()
    hs.append(eng.fork_branch(hs[1]))
    for _ in range(4):
        eng.decode_step()
    out = ([list(h.tokens) for h in hs], _np(logits),
           _np(eng._last_hidden)[[h.slot for h in hs]],
           _slot_states(eng, hs))
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    assert eng.allocator.used_pages == 0
    return out


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_forked_branches_match_jax(family):
    """A 13-token prompt through the masked-dt chunk lane (chunks 8 + 5),
    three branches and a mid-generation fork: the reference's greedy
    tokens; prefill logits, hidden states and every branch's final (conv,
    ssd) state within 1e-4."""
    je, te = _pair(FAMILY_CONFIGS[family])
    prompt = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10, 12, 14]
    jt, jl, jh, (jc, js) = _ssm_run(je, prompt)
    tt, tl, th, (tc, ts) = _ssm_run(te, prompt)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    assert te.mixed_steps_executed == je.mixed_steps_executed == 2


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_token_budget_lanes_match_jax(family):
    """Up to three concurrent SSM chunk lanes in one batched masked-dt
    scan, riding decode steps: the reference's tokens, first-token logits
    and lane counters."""
    je, te = _pair(FAMILY_CONFIGS[family], step_token_budget=24, max_slots=6)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(2, 97, n)]
               for n in (6, 11, 19, 5, 9)]
    jt, jl, jc = _drive_lanes(je, prompts, 12)
    tt, tl, tc = _drive_lanes(te, prompts, 12)
    assert tt == jt
    assert tc == jc
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert te.allocator.used_pages == 0


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_cache_and_tree_match_jax(family):
    """Prefix cache and tree decode on: the warm request is seeded from
    the cold one's page-aligned ``ssm_snaps`` boundary (8 tokens) in both
    packages; equal tokens and cache counters, logits and hidden states
    within 1e-4."""
    je, te = _pair(FAMILY_CONFIGS[family], max_slots=8, prefix_cache=True,
                   decode_kernel="tree")
    jt, jl, jh, _, jc = _header_requests(je)
    tt, tl, th, _, tc = _header_requests(te)
    assert tt == jt
    assert tc == jc == 8
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)


def test_ssm_step_variants_match_jax():
    """The declared step shapes carry the reference's chunk-state shapes
    (per-layer conv and ssd stacked along the lane axis)."""
    je, te = _pair(FAMILY_CONFIGS["hybrid"], step_token_budget=16,
                   prefill_buckets=(4, 8))
    jv, tv = je.step_variants(), te.step_variants()
    assert [(v.name, v.lane_buckets) for v in tv] == \
        [(v.name, v.lane_buckets) for v in jv]
    for j, t in zip(jv, tv):
        chunk_state = j.args[5]
        assert ("chunk_conv" in t.args) == bool(chunk_state)
        for key in chunk_state:
            assert t.args[f"chunk_{key}"] == (
                tuple(chunk_state[key].shape), str(chunk_state[key].dtype))
        assert t.args["slot_valid"] == ((te.cfg.max_slots,), "bool")
        assert t.args["chunk_lens"][0] == tuple(j.args[6].shape)


def _port(family, **ecfg):
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(5))
    base = dict(page_size=4, num_pages=128, max_slots=4,
                max_pages_per_branch=24, eos_id=1, prefill_chunk=8, seed=0,
                sampling=SamplingParams(temperature=0.0))
    base.update(ecfg)
    return Engine(tm, tp, EngineConfig(**base))


def _equal_states(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("family", ["dense", "dense_bias"])
def test_dense_multi_lane_matches_single_lane(family):
    """Two chunk lanes per mixed step (K2 once over both lanes, each lane's
    pos0 and length read from the step's device arrays) give each prompt
    the single-lane FIFO's first-token logits and K/V pages bit for bit,
    and the same greedy tokens when a branch of each decodes."""
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, 97, size=s)]
               for s in (13, 9, 17)]
    single = _port(family)
    want = [single.prefill(p) for p in prompts]
    multi = _port(family, step_token_budget=16)
    assert multi.admission_capacity == 2
    sts = [multi.begin_prefill(p) for p in prompts]
    steps = 0
    while any(not st.done for st in sts):
        multi.decode_step()
        steps += 1
    assert steps < sum(-(-len(p) // 8) for p in prompts)
    got = [multi.finish_prefill(st) for st in sts]
    for (b_m, lg_m, _), (b_w, lg_w, _) in zip(got, want):
        assert torch.equal(lg_m, lg_w)
        for a, b in zip(_kv_of(multi, b_m), _kv_of(single, b_w)):
            np.testing.assert_array_equal(a, b)
    tokens = []
    for eng, res in ((single, want), (multi, got)):
        hs = [eng.spawn_branch(i, b, lg, ssm, len(p))
              for i, ((b, lg, ssm), p) in enumerate(zip(res, prompts))]
        for _ in range(4):
            eng.decode_step()
        tokens.append([h.tokens for h in hs])
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_multi_lane_matches_single_lane(family):
    """Two lanes per mixed step (one batched scan) give each prompt the
    single-lane FIFO's logits, SSM state and K/V pages bit for bit, though
    the lanes run at another bucket and row count than the single lane."""
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, 97, size=s)]
               for s in (13, 9, 17)]
    single = _port(family)
    want = [single.prefill(p) for p in prompts]
    multi = _port(family, step_token_budget=16)
    assert multi.admission_capacity == 2
    sts = [multi.begin_prefill(p) for p in prompts]
    steps = 0
    while any(not st.done for st in sts):
        multi.decode_step()
        steps += 1
    assert steps < sum(-(-len(p) // 8) for p in prompts)
    for st, p, (b_w, lg_w, ssm_w) in zip(sts, prompts, want):
        b_m, lg_m, ssm_m = multi.finish_prefill(st)
        assert torch.equal(lg_m, lg_w)
        _equal_states(ssm_m, ssm_w)
        if multi.model.cfg.uses_attention:
            for got, exp in zip(_kv_of(multi, b_m), _kv_of(single, b_w)):
                np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_suspend_resume_roundtrip_bit_exact(family):
    """suspend_branch keeps a copy of the slot's (conv, ssd); resume
    restores it bit for bit after another branch dirtied the slot, and
    the branch then decodes what it would have decoded unsuspended."""
    eng = _port(family, max_slots=2)
    prompt = [2, 5, 9, 13]
    blocks, lg, ssm = eng.prefill(prompt)
    h = eng.spawn_branch(0, blocks, lg, ssm, 4)
    for _ in range(3):
        eng.decode_step()
    before = [torch.clone(eng.state[k][:, h.slot]) for k in ("conv", "ssd")]
    eng.suspend_branch(h)
    other = eng.spawn_branch(1, blocks, lg, ssm, 4)   # dirty the slot rows
    for _ in range(2):
        eng.decode_step()
    eng.free_branch(other)
    assert eng.resume_branch(h)
    for key, b in zip(("conv", "ssd"), before):
        assert torch.equal(eng.state[key][:, h.slot], b)
    for _ in range(3):
        eng.decode_step()

    ref = _port(family, max_slots=2)
    rb, rlg, rssm = ref.prefill(prompt)
    rh = ref.spawn_branch(0, rb, rlg, rssm, 4)
    for _ in range(6):
        ref.decode_step()
    assert h.tokens == rh.tokens
    for key in ("conv", "ssd"):
        assert torch.equal(eng.state[key][:, h.slot],
                           ref.state[key][:, rh.slot])
    eng.free_branch(h)
    eng.release_prefix(blocks)
    assert eng.allocator.used_pages == 0


@pytest.mark.parametrize("family", SSM_FAMILIES)
def test_ssm_cache_on_vs_off_bit_exact(family):
    """Cache on reproduces cache off bit for bit — harvested logits, SSM
    state and K/V pages — while the second prompt resumes from the first
    one's 8-token boundary snapshot (fewer chunk steps, hit tokens)."""
    rng = np.random.default_rng(3)
    header = [int(t) for t in rng.integers(2, 97, size=10)]
    prompts = [header + [3, 7, 2, 9], header + [5, 2, 8, 4, 6]]

    def run(cache):
        eng = _port(family, prefix_cache=cache)
        outs, steps = [], 0
        for p in prompts:
            st = eng.begin_prefill(p)
            while not st.done:
                eng.decode_step()
                steps += 1
            eng.finish_prefill(st)
            kv = (_kv_of(eng, st.blocks) if eng.model.cfg.uses_attention
                  else None)
            outs.append((st.last_logits, st.ssm_state, kv))
        return eng, outs, steps

    _, off, steps_off = run(False)
    eng_on, on, steps_on = run(True)
    assert steps_on < steps_off
    assert eng_on.prefix_cache_stats()["hit_tokens"] == 8
    for (lg_a, ssm_a, kv_a), (lg_b, ssm_b, kv_b) in zip(off, on):
        assert torch.equal(lg_a, lg_b)
        _equal_states(ssm_a, ssm_b)
        if kv_a is not None:
            for x, y in zip(kv_a, kv_b):
                np.testing.assert_array_equal(x, y)


def test_ssm_snapshots_survive_later_steps():
    """Boundary snapshots (prefill chunks and decode steps) are copies:
    steps that update the per-slot pools in place leave them unchanged."""
    eng = _port("hybrid", prefix_cache=True)
    prompt = list(range(2, 14))                  # 12 tokens: chunks 8 + 4
    st = eng.begin_prefill(prompt)
    while not st.done:
        eng.decode_step()
    blocks, lg, ssm = eng.finish_prefill(st)
    assert sorted(st.ssm_snaps) == [8, 12]
    h = eng.spawn_branch(0, blocks, lg, ssm, len(prompt),
                         prompt_tokens=prompt)
    for _ in range(4):                           # a decode boundary at 16
        eng.decode_step()
    assert sorted(h.ssm_snaps) == [16]
    kept = {k: [t.clone() for t in v]
            for k, v in list(st.ssm_snaps.items()) + list(
                h.ssm_snaps.items())}
    for _ in range(5):
        eng.decode_step()
    snaps = {**st.ssm_snaps, **h.ssm_snaps}
    assert sorted(snaps) == [8, 12, 16, 20]
    for k, want in kept.items():
        for got, exp in zip(snaps[k], want):
            assert torch.equal(got, exp)
    eng.free_branch(h)
    eng.release_prefix(blocks)


# ------------------------------------------------ exact-length prefill


def _gather_prefix(eng, blocks, s):
    """Dense [L, s, kv, hd] view of the first s tokens of a prefix's
    pages (the reference test's helper, for either package)."""
    k = _np(eng.state["k_pages"])[:, :, blocks.pages]  # [L,kv,n,ps,hd]
    v = _np(eng.state["v_pages"])[:, :, blocks.pages]
    k = np.moveaxis(k, 1, 3).reshape(k.shape[0], -1, k.shape[1], k.shape[-1])
    v = np.moveaxis(v, 1, 3).reshape(v.shape[0], -1, v.shape[1], v.shape[-1])
    return k[:, :s], v[:, :s]


def _ssm_close(a, b, **tol):
    assert (a is None) == (b is None)
    for x, y in zip(a or (), b or ()):
        np.testing.assert_allclose(_np(x), _np(y), **tol)


EXACT_FAMILIES = ["dense", "ssm", "hybrid"]


@pytest.mark.parametrize("family", EXACT_FAMILIES + SMOKE)
@pytest.mark.parametrize("s", [5, 13])
def test_exact_prefill_matches_jax(family, s):
    """``prefill(exact=True)``: the reference's last logits, pages, page
    contents (K/V of every prompt token) and final (conv, ssd) state; one
    exact pass each, no mixed step. Under MoE the pass's rows are exactly
    the prompt's, as the reference's per-length program."""
    je, te = _pair(**_family(family))
    prompt = [int(x) for x in np.random.default_rng(s).integers(2, 97, s)]
    jb, jl, js = je.prefill(prompt, exact=True)
    tb, tl, ts = te.prefill(prompt, exact=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tb.pages == jb.pages and tb.length == jb.length == s
    if te.model.cfg.uses_attention:
        for a, b in zip(_gather_prefix(te, tb, s), _gather_prefix(je, jb, s)):
            np.testing.assert_allclose(a, b, **TOL)
    _ssm_close(ts, js, **TOL)
    assert te.exact_prefills == 1 == len(je._prefill_cache)
    assert te.mixed_steps_executed == 0 == te.prefill_chunk_steps
    te.release_prefix(tb)
    assert te.allocator.used_pages == 0


@pytest.mark.parametrize("s", [1, 3, 4, 5, 8, 9, 13, 23])
def test_chunked_matches_exact_within_the_port(s):
    """The chunked-bucketed path reproduces the exact pass's last logits
    and K/V page contents across page (4), chunk (8) and bucket (4/8)
    boundaries (``tests/test_chunked_prefill.py:54``)."""
    _, exact = _pair()
    _, chunk = _pair()
    prompt = [int(x) for x in np.random.default_rng(s).integers(2, 97, s)]
    be, le, _ = exact.prefill(prompt, exact=True)
    bc, lc, _ = chunk.prefill(prompt)
    np.testing.assert_allclose(_np(le), _np(lc), atol=1e-4, rtol=1e-4)
    for a, b in zip(_gather_prefix(exact, be, s), _gather_prefix(chunk, bc,
                                                                 s)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    assert chunk.exact_prefills == 0 and exact.exact_prefills == 1


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("s", [1, 5, 8, 17])
def test_chunked_matches_exact_ssm_within_the_port(family, s):
    """ssm/hybrid: the masked-dt chunk lanes reproduce the exact pass's
    last logits, final (conv, ssd) state and K/V pages
    (``tests/test_chunked_prefill.py:80``)."""
    _, exact = _pair(FAMILY_CONFIGS[family])
    _, chunk = _pair(FAMILY_CONFIGS[family])
    prompt = [int(x) for x in np.random.default_rng(s).integers(2, 97, s)]
    be, le, se = exact.prefill(prompt, exact=True)
    bc, lc, sc = chunk.prefill(prompt)
    np.testing.assert_allclose(_np(le), _np(lc), atol=1e-4, rtol=1e-4)
    _ssm_close(se, sc, atol=1e-5, rtol=1e-4)
    if exact.model.cfg.uses_attention:
        for a, b in zip(_gather_prefix(exact, be, s),
                        _gather_prefix(chunk, bc, s)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", EXACT_FAMILIES)
def test_exact_then_decode_matches_chunked_then_decode(family):
    """Greedy generation after an exact prefill equals generation after
    a chunked one (``tests/test_chunked_prefill.py:109``), and both equal
    the reference's after its exact prefill."""
    prompt = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10]   # 11 tokens: 2 chunks

    def gen(eng, exact):
        blocks, lg, ssm = eng.prefill(prompt, exact=exact)
        h = eng.spawn_branch(0, blocks, lg, ssm, len(prompt))
        for _ in range(8):
            eng.decode_step()
        toks = list(h.tokens)
        eng.free_branch(h)
        eng.release_prefix(blocks)
        assert eng.allocator.used_pages == 0
        return toks

    je, te = _pair(FAMILY_CONFIGS[family])
    _, tc = _pair(FAMILY_CONFIGS[family])
    assert gen(te, True) == gen(tc, False) == gen(je, True)


@pytest.mark.parametrize("family", EXACT_FAMILIES)
def test_chunked_prefill_disabled_is_synchronous(family):
    """``chunked_prefill=False``: ``begin_prefill`` runs the exact pass
    and returns a done state (logits, pages and SSM state), queueing
    nothing (``tests/test_chunked_prefill.py:624``); forked branches then
    decode the reference's tokens."""
    je, te = _pair(FAMILY_CONFIGS[family], chunked_prefill=False)
    out = []
    for eng in (je, te):
        st = eng.begin_prefill([2, 5, 9, 13, 7])
        assert st.done and not eng.has_pending_prefill
        assert (st.ssm_state is not None) == eng.model.cfg.uses_ssm
        out.append(_fork_and_decode_state(eng, st))
    assert out[1][0] == out[0][0]
    np.testing.assert_allclose(out[1][1], out[0][1], **TOL)
    assert te.exact_prefills == 1 and te.mixed_steps_executed == 0
    assert te.allocator.used_pages == 0 == je.allocator.used_pages


def _fork_and_decode_state(eng, st):
    """Harvest a done state, fork two branches, 6 greedy steps."""
    blocks, logits, ssm = eng.finish_prefill(st)
    hs = [eng.spawn_branch(0, blocks, logits, ssm, len(st.prompt))
          for _ in range(2)]
    for _ in range(6):
        eng.decode_step()
    out = ([h.tokens for h in hs], _np(logits))
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    return out


def test_exact_prefill_out_of_pages_allocates_nothing():
    """A prompt the pool cannot hold raises OutOfPagesError before the
    exact pass runs, holding no page."""
    from repro_torch.kv import OutOfPagesError
    _, te = _pair(num_pages=3, chunked_prefill=False)
    with pytest.raises(OutOfPagesError):
        te.begin_prefill(list(range(2, 19)))            # 17 tokens, 5 pages
    assert te.allocator.used_pages == 0 and te.exact_prefills == 0


@pytest.mark.parametrize("family", EXACT_FAMILIES)
def test_paged_decode_matches_dense_cache_model_greedy(family):
    """The engine's paged greedy decode (after an exact prefill) gives
    the tokens of the port's dense-cache ``Model.prefill`` +
    ``decode_step`` loop (``tests/test_engine.py:47``)."""
    _, te = _pair(FAMILY_CONFIGS[family], chunked_prefill=False)
    model, params = te.model, te.params
    prompt = [2, 5, 9, 13, 7, 3, 11]        # crosses a page boundary (ps=4)
    steps = 10
    lg, cache = model.prefill(params, tokens=torch.tensor([prompt]),
                              max_len=len(prompt) + steps)
    ref, cur, pos = [], int(torch.argmax(lg[0])), len(prompt)
    for _ in range(steps):
        ref.append(cur)
        lg, cache, _ = model.decode_step(params, torch.tensor([cur]), cache,
                                         torch.tensor([pos]))
        cur, pos = int(torch.argmax(lg[0])), pos + 1
    blocks, logits, ssm = te.prefill(prompt)
    h = te.spawn_branch(0, blocks, logits, ssm, len(prompt))
    for _ in range(steps - 1):
        te.decode_step()
    assert h.tokens[:steps] == ref
    te.free_branch(h)
    te.release_prefix(blocks)
    assert te.allocator.used_pages == 0


# ------------------------------------------- head_dim 256 (gemma-7b)


def _gemma256(**ecfg):
    """``_pair`` on gemma-7b's smoke widths at its own head_dim of 256
    (2 layers, d_model 256, 4/4 heads of 256, GeGLU, tied embeddings
    scaled by sqrt(d)), the width the card's head_dim-256 kernels take."""
    return _pair(cfg=smoke("gemma-7b").replace(head_dim=256), **ecfg)


def _suspend_resume_run(eng, prompt):
    """The prompt forks 3 branches that decode 3 greedy steps; a
    mid-generation fork joins them (CoW of the shared partial page); the
    second branch is suspended for 2 steps, then resumed; 4 more steps.
    Returns (tokens, prefill logits, live rows' hidden)."""
    blocks, logits, ssm = eng.prefill(prompt)
    hs = [eng.spawn_branch(0, blocks, logits, ssm, len(prompt))
          for _ in range(3)]
    for _ in range(3):
        eng.decode_step()
    hs.append(eng.fork_branch(hs[0]))
    eng.suspend_branch(hs[1])
    for _ in range(2):
        eng.decode_step()
    assert eng.resume_branch(hs[1])
    for _ in range(4):
        eng.decode_step()
    out = ([list(h.tokens) for h in hs], _np(logits),
           _np(eng._last_hidden)[[h.slot for h in hs]])
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    return out


@pytest.mark.parametrize("mode", ["chunked", "exact"])
def test_head_dim_256_forks_and_suspend_match_jax(mode):
    """head_dim 256 with chunked admission (chunks 8 + 5) or exact
    admission (``chunked_prefill=False``): forked branches, CoW and a
    suspend/resume round trip give the reference's greedy tokens (not all
    one id), prefill logits and hidden states within 1e-4, and return
    every page."""
    exact = mode == "exact"
    je, te = _gemma256(**({"chunked_prefill": False} if exact else {}))
    # a prompt whose greedy tokens move (the tied head of a random model
    # tends to repeat the last token)
    prompt = [415, 45, 93, 122, 94, 410, 445, 298, 22, 50, 171, 222, 318]
    jt, jl, jh = _suspend_resume_run(je, prompt)
    tt, tl, th = _suspend_resume_run(te, prompt)
    assert tt == jt
    assert len({t for toks in tt for t in toks}) > 1
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.allocator.used_pages == 0 == je.allocator.used_pages
    assert te.decode_steps_executed == je.decode_steps_executed
    assert te.exact_prefills == (1 if exact else 0)


def test_head_dim_256_cache_and_tree_match_jax():
    """head_dim 256 with the prefix cache and tree decode: the warm
    request hits the cached header, and tokens, cache stats, both prefill
    logits and the live rows' hidden states equal the reference's."""
    je, te = _gemma256(max_slots=8, **CACHE_TREE["cache_tree"])
    jt, jl, jh, _, jc = _header_requests(je)
    tt, tl, th, _, tc = _header_requests(te)
    assert tt == jt
    assert len({t for toks in tt for t in toks}) > 1
    assert tc == jc == 8
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.decode_steps_executed == je.decode_steps_executed
