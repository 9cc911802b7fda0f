"""The port's tracer (``repro_torch.spans``): spans nest with their
parents, carry request ids and counters, wrap in a fixed ring, cost
nothing recorded while off, open ``record_function`` ranges only under an
active profiler, record collections; device marks are a no-op on the CPU;
the scheduler's wall-clock stamps are ordered; and a decode step's parts
add up to the step."""
import gc
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
from repro_torch.data import tasks
from repro_torch.data import tokenizer as tk
from repro_torch.models import Model, ModelConfig
from repro_torch.serving import Engine, EngineConfig, SamplingParams

STEP_PARTS = ("engine.pages", "engine.pack", "engine.host_array",
              "engine.launch", "engine.sync", "engine.commit")


@pytest.fixture
def no_auto_gc():
    """Automatic collections off: they would add ``host.gc`` records
    where a test counts records exactly (``gc.collect`` still runs)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture
def tracer(no_auto_gc):
    spans.enable()
    try:
        yield
    finally:
        spans.disable()


def _records(snap, name):
    return np.flatnonzero(snap["name"] == name)


def test_spans_nest_with_parent_indices(tracer):
    with spans.span("engine.decode_step") as outer:
        with spans.span("engine.pages") as a:
            pass
        with spans.span("engine.pack"):
            with spans.span("engine.host_array"):
                pass
    snap = spans.snapshot()
    assert list(snap["name"]) == ["engine.decode_step", "engine.pages",
                                  "engine.pack", "engine.host_array"]
    assert snap["parent"].tolist() == [-1, outer.seq, outer.seq, 2]
    assert snap["seq"].tolist() == [0, 1, 2, 3] and a.seq == 1
    assert np.all(snap["t1_ns"] >= snap["t0_ns"])
    # a child lies inside its parent
    assert snap["t0_ns"][0] <= snap["t0_ns"][1] <= snap["t1_ns"][3] <= \
        snap["t1_ns"][0]


def test_request_ids_and_counters(tracer):
    with spans.span("sched.prm", 7) as sp:
        sp.set(branches=5)
    with spans.span("engine.decode_step") as sp:
        sp.set(ctx=11, pages_used=3)
    with spans.span("sched.fill"):
        pass
    snap = spans.snapshot()
    assert snap["req"].tolist() == [7, -1, -1]
    assert snap["counters"].tolist() == [[5, 0, 0, 0], [0, 11, 0, 3],
                                         [0, 0, 0, 0]]
    assert snap["counter_names"]["engine.decode_step"] == (
        "rows", "ctx", "chunk_tokens", "pages_used")
    with pytest.raises(ValueError):
        with spans.span("sched.prm") as sp:
            sp.set(no_such_counter=1)


def test_the_ring_wraps_and_counts_what_it_drops(no_auto_gc):
    spans.enable(capacity=8)
    try:
        for i in range(20):
            with spans.span("sched.prm", i):
                pass
        for _ in range(3):
            with spans.span("engine.decode_step") as sp:
                pass
            sp.device(np.arange(len(spans.KINDS), dtype=float))
        snap = spans.snapshot()
        assert len(snap["name"]) == 8 and snap["dropped"] == 15
        assert snap["seq"].tolist() == list(range(15, 23))
        assert snap["req"].tolist()[:5] == [15, 16, 17, 18, 19]
        assert snap["device"]["dropped"] == 1
        assert snap["device"]["seq"].tolist() == [21, 22]
        # a span overwritten while it was open is dropped, not corrupted
        with spans.span("engine.decode_step") as outer:
            for _ in range(9):
                with spans.span("engine.pack"):
                    pass
        snap = spans.snapshot()
        assert outer.seq not in snap["seq"].tolist()
        assert np.all(snap["t1_ns"] >= snap["t0_ns"])
    finally:
        spans.disable()


def test_a_disabled_span_is_the_shared_noop_and_records_nothing():
    assert not spans.enabled()
    sp = spans.span("engine.decode_step", 3)
    assert sp is spans.NOOP and spans.span("sched.fill") is sp
    assert not sp
    with sp as inner:
        inner.set(rows=1)
    assert spans.snapshot() == {}
    spans.device_mark("dense")           # unarmed: nothing to record into
    spans.enable()
    spans.disable()
    assert spans.span("engine.pages") is spans.NOOP
    assert spans._on_gc not in gc.callbacks


def test_record_function_only_under_an_active_profiler(tracer):
    from torch.profiler import ProfilerActivity, profile
    with spans.span("engine.commit"):
        assert not torch.autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("engine.sync"):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "engine.sync" in names and "engine.commit" not in names
    assert len(_records(spans.snapshot(), "engine.sync")) == 1


def test_a_collection_is_a_host_gc_span(tracer):
    with spans.span("sched.window") as outer:
        gc.collect(1)
    snap = spans.snapshot()
    i = _records(snap, "host.gc")
    assert len(i) == 1
    assert snap["parent"][i[0]] == outer.seq
    assert snap["counters"][i[0], 0] == 1          # the generation
    assert snap["t0_ns"][i[0]] < snap["t1_ns"][i[0]] <= \
        snap["t1_ns"][_records(snap, "sched.window")[0]]
    spans.disable()
    gc.collect()                                   # the hook is gone
    assert spans.snapshot() == {}


def _engine(**kw):
    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                      d_model=64, vocab_size=tk.VOCAB_SIZE, num_heads=4,
                      num_kv_heads=2, d_ff=128)
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return Engine(model, params, EngineConfig(
        page_size=8, num_pages=256, max_slots=8, max_pages_per_branch=16,
        eos_id=tk.EOS, seed=1, sampling=SamplingParams(temperature=0.9),
        **kw))


def _serve(engine, n_requests=3):
    prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=2)
    sch = Scheduler(engine, prm, SchedulerConfig(policy="sart", n=4,
                                                 window=4, max_tokens=16),
                    answer_fn=tasks.extract_answer)
    rng = np.random.default_rng(3)
    for i in range(n_requests):
        prob = tasks.gen_problem(rng)
        sch.submit(prob.prompt_tokens(), payload=prob, arrival=i * 3)
    sch.run(max_steps=5000)
    return sch


def test_device_marks_are_a_noop_on_the_cpu(tracer):
    engine = _engine()
    _serve(engine, 1)
    assert engine.step_graphs
    assert all(g.marks is None for g in engine.step_graphs.values())
    snap = spans.snapshot()
    assert len(snap["device"]["seq"]) == 0
    assert len(_records(snap, "engine.decode_step")) == \
        engine.decode_steps_executed


def test_request_stamps_are_ordered():
    sch = _serve(_engine())
    for req in sch.requests.values():
        assert req.done
        assert req.arrival_s <= req.admitted_s <= req.first_branch_s \
            <= req.finish_s
    t = time.perf_counter()
    req = sch.submit([5, 6, 7])
    assert t <= req.arrival_s <= time.perf_counter()
    assert np.isnan(req.admitted_s)


def test_decode_step_parts_add_up_to_the_step(tracer):
    engine = _engine()
    sch = _serve(engine)
    snap = spans.snapshot()
    steps = _records(snap, "engine.decode_step")
    assert len(steps) == engine.decode_steps_executed > 0
    dur = snap["t1_ns"] - snap["t0_ns"]
    parent = snap["parent"]
    seq = snap["seq"]
    counters = snap["counters"]
    names = set(snap["name"][np.isin(parent, seq[steps])])
    assert set(STEP_PARTS) <= names <= set(STEP_PARTS) | {"host.gc"}
    self_ns = np.array([dur[i] - dur[parent == seq[i]].sum() for i in steps])
    # the step's own time outside its parts (span boundaries, the copy of
    # the hidden state, the lanes' bookkeeping) is a small share of it
    assert np.all(self_ns >= 0)
    assert self_ns.sum() < 0.1 * dur[steps].sum()
    # counters: rows sampled and the pages held after the step's accounting
    assert counters[steps, 0].sum() == engine.tokens_generated
    assert np.all(counters[steps, 3] > 0)
    # the tracer's read-out: one a step, after it and inside no span
    readout = _records(snap, "host.tracer")
    assert len(readout) == len(steps) and np.all(parent[readout] == -1)
    assert np.all(snap["t0_ns"][readout] >= snap["t1_ns"][steps])
    # every sched span lies outside the steps; each prune and prm names
    # its request
    for name in ("sched.fill", "sched.poll", "sched.completions",
                 "sched.window", "sched.prm", "sched.finalize"):
        i = _records(snap, name)
        assert len(i) > 0, name
        assert not np.isin(parent[i], seq[steps]).any()
    assert set(snap["req"][_records(snap, "sched.prm")]) <= set(sch.requests)
    fin = _records(snap, "sched.finalize")
    assert sorted(snap["req"][fin].tolist()) == sorted(sch.requests)


@pytest.mark.gpu
def test_device_marks_time_a_replayed_graph():
    """Two marked intervals timed in a replayed graph as when recorded
    eagerly (the same events, external timing events in the capture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    out = torch.empty_like(a)
    marks = spans.DeviceMarks()

    def body():
        spans.device_mark("dense")
        torch.matmul(a, a, out=out)
        spans.device_mark("attention")
        torch.matmul(out, a, out=out)
        torch.matmul(out, a, out=out)
        spans.device_mark(spans.END)

    with spans.armed(marks):
        body()
    torch.cuda.synchronize()
    eager = marks.elapsed_ms()[:2]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), spans.armed(marks):
        body()
    graph.replay()
    torch.cuda.synchronize()
    replayed = marks.elapsed_ms()[:2]
    assert np.allclose(replayed, eager, rtol=0.25)
