"""The serve step as one static body per step variant, on the CPU.

On the card each ``Engine.step_variants()`` entry runs as the replay of
one CUDA graph (``repro_torch.serving.step_graph``); the CPU runs the
same ``StepGraph`` eagerly over the same static buffers. These tests
hold what capture needs to the CPU path, at ``tiny_config()`` widths:
one host array of one length per variant (the copy-on-write pairs padded
to ``max_slots``, no tree span), sentinel CoW pairs that write only the
spare page, K3's split layout from the table's shape alone, a step body
with no host read of a value (run under ``FakeTensorMode``, where any
such read raises: the port's counterpart of stepcheck's no-host-sync
rule), outputs kept past a step as copies, and only declared variants
run. The static path is held to the JAX engine with greedy sampling,
tokens equal and logits within 1e-4 (fp32, two frameworks), and the
plain tree path to the JAX Pallas pair in interpret mode within 2e-4.
The card's replay against its eager step is a ``gpu`` test, skipped
here (``chip_smoke.py`` phase 9 runs it at full size).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import FAMILY_CONFIGS, tiny_config
from repro.kernels.paged_attention.tree_decode import \
    paged_tree_attention_fwd as j_tree_pallas
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.kernels.paged_attention import tree_decode
from repro_torch.kernels.paged_attention.ops import paged_tree_attention
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.sampling import sample
from repro_torch.serving.step_graph import launch_counts
from repro_torch.stepcheck.tracing import fake_inputs, is_host_read

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_PALLAS = dict(atol=2e-4, rtol=0)
BASE = dict(page_size=4, num_pages=96, max_slots=4, max_pages_per_branch=16,
            eos_id=1, seed=0, prefill_chunk=8)
# the engines of these tests: per-branch decode, the tree map with the
# prefix cache, the two SSM families, and MoE, M-RoPE (vlm) and
# sinusoidal positions (audio)
KINDS = {"dense": ("dense", {}),
         "tree": ("dense", dict(decode_kernel="tree", prefix_cache=True)),
         "ssm": ("ssm", {}), "hybrid": ("hybrid", {}),
         "moe": ("moe", {}), "vlm": ("vlm", {}), "audio": ("audio", {})}


def _port(kind, temperature=0.0, **ecfg):
    family, extra = KINDS[kind]
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(5))
    return Engine(tm, tp, EngineConfig(
        sampling=SamplingParams(temperature=temperature),
        **dict(BASE, **extra, **ecfg)))


def _pair(kind, **ecfg):
    """(jax engine, port engine) over equal weights, greedy."""
    family, extra = KINDS[kind]
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    tm.load_params(tp)
    kw = dict(BASE, **extra, **ecfg)
    return (JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0),
                                    **kw)),
            Engine(tm, tp, EngineConfig(
                sampling=SamplingParams(temperature=0.0), **kw)))


def _np(x):
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _layout_len(eng, lane_buckets):
    """The host array's length the variant's layout gives: five row
    arrays and the rows' tables; the tree map's four; the slot-validity
    mask; the lanes' chunk lengths; two CoW arrays of max_slots."""
    cfg, mc = eng.cfg, eng.model.cfg
    nS, w = cfg.max_slots, cfg.max_pages_per_branch
    rows = nS + sum(lane_buckets)
    n = 5 * rows + rows * w + len(lane_buckets) + 2 * nS
    if cfg.decode_kernel == "tree" and mc.uses_attention:
        n += 2 * nS + 2 * nS * w
    if mc.uses_ssm:
        n += nS
    return n


def _host(eng, lane_buckets, cows=(), tree=None):
    """A variant's host array over empty slots (sentinel tables)."""
    cfg = eng.cfg
    nS = cfg.max_slots
    rows = nS + sum(lane_buckets)
    if tree is None:
        tree = eng._tree_map([None] * nS)
    return eng._host_array(
        np.zeros((rows,), np.int32), np.zeros((rows,), np.int32),
        np.full((rows, cfg.max_pages_per_branch), cfg.num_pages, np.int32),
        np.zeros((rows,), np.int32), lane_buckets,
        [0] * len(lane_buckets), cows, tree, np.zeros((nS,), bool))


# ---------------------------------------- (a) one host array per variant


@pytest.mark.parametrize("n_cows", [0, 1, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("lane_buckets", [(), (8,), (4, 4)])
def test_host_array_has_one_length_per_variant(kind, lane_buckets, n_cows):
    """Whether a step copies-on-write 0, 1 or max_slots pages, its host
    array has the variant's one length, the layout's: the CoW pairs are
    padded to max_slots with sentinel pairs, and a tree step carries no
    span (no int past the map's four arrays)."""
    eng = _port(kind, step_token_budget=8)
    cows = [(i, 40 + i) for i in range(n_cows)]
    host = _host(eng, lane_buckets, cows)
    assert host.dtype == np.int32
    assert host.shape == (_layout_len(eng, lane_buckets),)
    fields = {name: slice(a, b)
              for name, a, b in eng.host_layout(lane_buckets)}
    assert eng.host_layout(lane_buckets)[-1][2] == host.shape[0]
    nS, sentinel = eng.cfg.max_slots, eng.cfg.num_pages
    src, dst = host[-2 * nS:-nS], host[-nS:]
    assert (src == host[fields["cow_src"]]).all()
    assert (dst == host[fields["cow_dst"]]).all()
    assert src[:n_cows].tolist() == [c[0] for c in cows]
    assert dst[:n_cows].tolist() == [c[1] for c in cows]
    assert (src[n_cows:] == sentinel).all()
    assert (dst[n_cows:] == sentinel).all()


def test_tree_calls_take_no_span():
    """No host int of a step's map reaches K3: neither the dispatcher nor
    the card's wrappers take a span, and the split rule takes only the
    table's shape and dtype."""
    for fn in (paged_tree_attention, tree_decode.paged_tree_attention_fwd,
               tree_decode.paged_tree_shared_fwd):
        assert "span" not in inspect.signature(fn).parameters
    params = inspect.signature(tree_decode.shared_splits).parameters
    assert list(params) == ["page_size", "width", "dtype"]


# --------------------------------------------- (b) the static path vs JAX


def _tree_lanes_run(eng):
    """A 13-token prompt (a partial last page) forks three branches that
    decode across page boundaries (CoW of the shared page) while two
    queued prompts ride the steps as concurrent chunk lanes; a
    mid-generation fork joins; the lanes' requests fork two branches
    each. Returns every branch's tokens, the lanes' first logits and the
    live rows' hidden states."""
    prompt = [2, 5, 9, 13, 7, 3, 11, 4, 8, 6, 10, 12, 14]
    blocks, lg, ssm = eng.prefill(prompt)
    hs = [eng.spawn_branch(0, blocks, lg, ssm, len(prompt),
                           prompt_tokens=prompt) for _ in range(3)]
    owned = [blocks]
    sts = [eng.begin_prefill(prompt[:8] + [1 + i, 9, 4, 7, 2, 5][:3 + i])
           for i in range(2)]
    firsts = []
    for step in range(10):
        eng.decode_step()
        if step == 2:
            hs.append(eng.fork_branch(hs[0]))
        for i, st in enumerate(sts):
            if st.done and not st.harvested:
                b, lg2, ssm2 = eng.finish_prefill(st)
                owned.append(b)
                firsts.append(_np(lg2))
                hs += [eng.spawn_branch(1 + i, b, lg2, ssm2, len(st.prompt),
                                        prompt_tokens=st.prompt)
                       for _ in range(2)]
    out = ([list(h.tokens) for h in hs], firsts,
           _np(eng._last_hidden)[[h.slot for h in hs]])
    for h in hs:
        eng.free_branch(h)
    for b in owned:
        eng.release_prefix(b)
    assert eng.allocator.used_pages == 0
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_static_path_matches_jax(kind):
    """Forked branches with CoW, the tree map (with the cache), and
    multi-lane chunks through the variants' static buffers give the JAX
    engine's greedy tokens; first-token logits and hidden states within
    1e-4; the variants run are the reference's shapes."""
    je, te = _pair(kind, step_token_budget=16, max_slots=8)
    jt, jl, jh = _tree_lanes_run(je)
    tt, tl, th = _tree_lanes_run(te)
    assert tt == jt
    assert len(tl) == len(jl) == 2
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(th, jh, **TOL)
    assert te.mixed_steps_executed == je.mixed_steps_executed
    assert te.prefill_compile_count == je.prefill_compile_count
    assert set(te.step_graphs) == {"decode"} | {
        f"mixed:b{b}xl{n}" for b, n in te._buckets_used}


@pytest.mark.parametrize("n_real", [0, 1, 2])
@pytest.mark.parametrize("kind", ["dense", "tree"])
def test_sentinel_cow_pairs_write_only_the_spare_page(kind, n_real):
    """The CoW copy runs on every step: the sentinel pairs that pad it
    copy the spare page onto itself, so with empty slots (their K/V
    writes also go to the spare page) every page but the spare one and
    the real pairs' destinations is bit-equal before and after."""
    eng = _port(kind)
    gen = torch.Generator().manual_seed(3)
    for key in ("k_pages", "v_pages"):
        eng.state[key].copy_(torch.randn(eng.state[key].shape,
                                         generator=gen))
    before = {k: eng.state[k].clone() for k in ("k_pages", "v_pages")}
    cows = [(10 + i, 30 + i) for i in range(n_real)]
    graph = eng._step_graph(())
    graph.run(_host(eng, (), cows))
    spare = eng.cfg.num_pages
    for key, old in before.items():
        new = eng.state[key]
        keep = [p for p in range(spare) if p not in [d for _, d in cows]]
        assert torch.equal(new[:, :, keep], old[:, :, keep])
        for s, d in cows:
            assert torch.equal(new[:, :, d], old[:, :, s])


# ------------------------------------------ (c) K3's shape-only splits


@pytest.mark.parametrize("width", [3, 16, 40])
def test_shared_splits_follow_the_table_not_the_span(width):
    """Two maps over tables of one shape but with group spans of one page
    and of the whole table take one split layout (``shared_splits`` of
    the shape), and the plain tree path equals the JAX Pallas pair in
    interpret mode on both."""
    rng = np.random.default_rng(width)
    ps, kvh, qh, hd, b = 4, 2, 4, 32, 4
    pages = 2 * width + 2
    kp = rng.normal(size=(kvh, pages, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(kvh, pages, ps, hd)).astype(np.float32)
    q = rng.normal(size=(b, qh, hd)).astype(np.float32)
    layouts = []
    for shared in (1, width - 1):
        sbt = np.full((b, width), pages, np.int32)
        sbt[0, :shared] = np.arange(shared)
        bbt = np.full((b, width), pages, np.int32)
        lens = np.zeros((b,), np.int32)
        for r in range(b):
            bbt[r, 0] = shared + r
            lens[r] = shared * ps + 1 + r % ps
        rg = np.zeros((b,), np.int32)
        sl = np.zeros((b,), np.int32)
        sl[0] = shared * ps
        args = (q, kp, vp, rg, sbt, sl, bbt, lens)
        got = paged_tree_attention(*(torch.from_numpy(a) for a in args))
        want = np.asarray(j_tree_pallas(*(jnp.asarray(a) for a in args),
                                        interpret=True))
        np.testing.assert_allclose(got.numpy(), want, **TOL_PALLAS)
        layouts.append(tree_decode.shared_splits(ps, sbt.shape[1],
                                                 torch.bfloat16))
    assert layouts[0] == layouts[1]
    keys, n_split = layouts[0]
    assert (n_split - 1) * keys < ps * width <= n_split * keys


# --------------------------------- (d) no host read of a value in the body


class _NoHostReads(TorchDispatchMode):
    """Raises on the ops that read a tensor's value on the host or give a
    shape that depends on values: stepcheck's STEP004 list
    (``repro_torch.stepcheck.tracing.is_host_read``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if is_host_read(str(func)):
            raise AssertionError(f"host read in the step body: {func}")
        return func(*args, **(kwargs or {}))


def _variants(eng):
    return [v.lane_buckets for v in eng.step_variants()]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_step_body_runs_on_fake_tensors(kind):
    """Every declared variant's body runs with its inputs as fake tensors
    (``FakeTensorMode``: any host read of a value raises, the MoE
    dispatch's included) and gives outputs of the variant's shapes; the
    engine's real state is left bit-equal."""
    eng = _port(kind, step_token_budget=16)
    state = {k: v.clone() for k, v in eng.state.items()}
    nS, V = eng.cfg.max_slots, eng.model.cfg.vocab_size
    for lane_buckets in _variants(eng):
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        dev, lane = fake_inputs(eng, lane_buckets, mode)   # stepcheck's
        with mode:
            out = eng._step_body(dev, lane, lane_buckets)
        rows = nS + sum(lane_buckets)
        assert tuple(dev.shape) == (eng.host_layout(lane_buckets)[-1][2],)
        assert tuple(out[0].shape) == (rows,)
        assert tuple(out[1].shape) == (nS, eng.model.cfg.d_model)
        assert tuple(out[2].shape) == (rows, V)
        assert len(out) == (5 if lane is not None else 3)
    for k, v in eng.state.items():
        assert torch.equal(v, state[k])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stochastic_step_body_reads_no_value_on_the_host(kind):
    """With top-p sampling from the engine's generator (which fake
    tensors do not take), a serve's every step body dispatches no op that
    reads a value on the host: the draw is argmax(p / E), E ~ Exp(1)."""
    eng = _port(kind, temperature=0.9, step_token_budget=16)
    body = eng._step_body

    def checked(*args, **kw):
        with _NoHostReads():
            return body(*args, **kw)
    eng._step_body = checked
    blocks, lg, ssm = eng.prefill([3, 1, 4, 1, 5, 9, 2, 6, 5, 3])
    hs = [eng.spawn_branch(0, blocks, lg, ssm, 10) for _ in range(2)]
    sts = [eng.begin_prefill([7, 2, 8, 4, 6]) for _ in range(2)]
    for _ in range(4):
        eng.decode_step()
    assert all(st.done for st in sts) and eng.mixed_steps_executed >= 2
    for h in hs:
        eng.free_branch(h)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_draws_what_multinomial_draws(seed):
    """``sample``'s draw argmax(p / E) equals ``torch.multinomial(p, 1)``
    from the same generator state, and leaves the generator where
    multinomial leaves it."""
    from repro_torch.serving.sampling import apply_top_p
    logits = torch.randn((6, 97), generator=torch.Generator().manual_seed(9))
    mine, ref = (torch.Generator().manual_seed(seed) for _ in range(2))
    got = sample(mine, logits, SamplingParams(temperature=0.7, top_p=0.9))
    probs = torch.softmax(apply_top_p(logits / 0.7, 0.9), -1)
    want = torch.multinomial(probs, 1, generator=ref)[:, 0]
    assert torch.equal(got, want.to(torch.int32))
    assert torch.equal(mine.get_state(), ref.get_state())


# ------------------------------ (e) outputs kept past a step are copies


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kept_outputs_survive_the_next_step(kind):
    """Two mixed steps of one variant in a row: the first step's
    ``last_logits`` (a finished lane's), ``_last_hidden`` and a running
    lane's SSM state are unchanged by the second, which rewrites the
    variant's static outputs."""
    eng = _port(kind, step_token_budget=16, prefill_buckets=(8,))
    blocks, lg, ssm = eng.prefill([2, 5, 9, 13, 7, 3])
    h = eng.spawn_branch(0, blocks, lg, ssm, 6)
    short = eng.begin_prefill([4, 8, 6, 10, 3])
    longs = [eng.begin_prefill([int(t) for t in range(2 + i, 22 + i)])
             for i in range(2)]
    eng.decode_step()                  # lanes: short, longs[0]
    assert short.done and not longs[0].done
    kept = {"last_logits": short.last_logits, "hidden": eng._last_hidden}
    if longs[0].ssm_state is not None:
        kept.update(conv=longs[0].ssm_state[0], ssd=longs[0].ssm_state[1])
    copies = {k: v.clone() for k, v in kept.items()}
    graph = eng.step_graphs["mixed:b8xl2"]
    runs = graph.eager_runs
    eng.decode_step()                  # lanes: longs[0], longs[1]
    assert graph.eager_runs == runs + 1      # the same variant again
    for k, v in kept.items():
        assert torch.equal(v, copies[k]), k
    assert all(o.untyped_storage().data_ptr()
               != v.untyped_storage().data_ptr()
               for o in graph.outputs for v in kept.values())
    while eng.has_pending_prefill:
        eng.decode_step()
    eng.free_branch(h)
    for st in [short] + longs:
        eng.release_prefix(eng.finish_prefill(st)[0])
    eng.release_prefix(blocks)
    assert eng.allocator.used_pages == 0


def test_static_outputs_are_one_set_per_variant():
    """On the CPU a variant's outputs are copied into one set of static
    buffers, rewritten by each of its steps (as a graph's are)."""
    eng = _port("dense")
    graph = eng._step_graph(())
    first = graph.run(_host(eng, ()))
    second = graph.run(_host(eng, ()))
    assert all(a is b for a, b in zip(first, second))
    assert graph.eager_runs == 2 and graph.replays == 0
    assert graph.graph is None and eng.graphs_captured == 0
    assert graph.captures == 0


# ------------------------------------ (f) only declared variants run


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_variants_run_are_declared(kind):
    """Under ragged multi-lane traffic every variant the engine ran is
    declared by ``step_variants()`` (as ``tests/test_stepcheck.py`` checks
    for the reference), and the mixed ones are the chunk shapes it
    counts."""
    eng = _port(kind, step_token_budget=16, num_pages=128,
                max_pages_per_branch=24)
    declared = {v.name for v in eng.step_variants()}
    rng = np.random.default_rng(3)
    blocks, lg, ssm = eng.prefill([5, 3, 8])
    h = eng.spawn_branch(0, blocks, lg, ssm, 3)
    sts = [eng.begin_prefill([int(t) for t in rng.integers(2, 97, size=s)])
           for s in (13, 9, 17, 3)]
    while any(not st.done for st in sts):
        eng.decode_step()
    eng.decode_step()
    ran = set(eng.step_graphs)
    assert "decode" in ran and len(ran) >= 3
    assert ran <= declared, f"undeclared variants: {ran - declared}"
    assert ran - {"decode"} == {f"mixed:b{b}xl{n}"
                                for b, n in eng._buckets_used}
    assert eng.prefill_compile_count <= len(declared) - 1
    eng.free_branch(h)
    for st in sts:
        eng.release_prefix(eng.finish_prefill(st)[0])
    eng.release_prefix(blocks)
    assert eng.allocator.used_pages == 0


# --------------------------------------------- counts and eager block


def test_launches_run_are_recorded_times_replays():
    """A variant's launches on the device are its launches recorded at
    capture times its replays plus its eager steps'; the engine sums its
    variants'."""
    eng = _port("dense")
    a, b = eng._step_graph(()), eng._step_graph((8,))
    a.recorded, a.replays = {"paged_decode": 2}, 5
    b.recorded, b.replays = {"paged_decode": 2, "paged_prefill": 2}, 3
    b.eager_launches = {"paged_prefill": 4}
    assert a.launches_run() == {"paged_decode": 10}
    assert eng.step_launches() == {"paged_decode": 16, "paged_prefill": 10}
    assert eng.graph_replays == 8
    assert set(launch_counts()) == {
        "paged_decode", "paged_prefill", "paged_tree_shared",
        "paged_tree_branch", "ssd_scan", "ssd_scan_bwd", "flash_prefill",
        "flash_prefill_bwd", "adamw", "sample_top_p"}


def test_eager_block_nests_and_restores():
    """``Engine.eager()`` sets eager steps for its block only, nested
    blocks included, and restores on an exception."""
    eng = _port("dense")
    assert eng._eager is False
    with eng.eager():
        with eng.eager():
            assert eng._eager
        assert eng._eager
    assert eng._eager is False
    with pytest.raises(RuntimeError):
        with eng.eager():
            raise RuntimeError("boom")
    assert eng._eager is False


# ------------------------------------------------------------- the card


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graph capture has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graph_replay_matches_eager_on_card(cuda, kind):
    """On the card the graph steps give the eager steps' tokens and
    hidden states bit for bit, every step after a variant's first use is
    a replay, and no more graphs are captured than variants declared."""
    runs = []
    for eager in (True, False):
        eng = _port(kind, step_token_budget=16)
        model = Model(eng.model.cfg, device=cuda)
        params = _to(eng.params, cuda)
        model.load_params(params)
        eng = Engine(model, params, eng.cfg)
        if eager:
            with eng.eager():
                runs.append(_tree_lanes_run(eng))
            assert eng.graph_replays == 0
        else:
            runs.append(_tree_lanes_run(eng))
            assert eng.graph_replays >= eng.decode_steps_executed
            assert 0 < eng.graphs_captured <= len(eng.step_variants())
            assert all(g.captures == 1 for g in eng.step_graphs.values())
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


@pytest.mark.gpu
def test_capture_survives_dead_engines_graphs(cuda):
    """A dead engine whose graphs sit in an unreachable reference cycle
    (engine -> step graph -> bound body -> engine) is collected before
    the next capture, not during it: destroying a graph mid-capture is
    forbidden and would invalidate the capture."""
    import gc
    for _ in range(3):
        eng = _port("moe")
        model = Model(eng.model.cfg, device=cuda)
        params = _to(eng.params, cuda)
        model.load_params(params)
        eng = Engine(model, params, eng.cfg)
        blocks, lg, _ = eng.prefill([3, 1, 4, 1, 5])
        eng.spawn_branch(0, blocks, lg, None, 5)
        for _ in range(3):
            eng.decode_step()
        assert eng.graphs_captured >= 1
        del eng                    # a cycle: left to the collector
    gc.collect()
