"""The port's fault injection against the JAX package's.

``repro_torch.serving.faults`` is a copy of ``repro.serving.faults``: the
same plan draws the same faults in the same order in both packages. The
chaos cases of ``tests/test_faults.py`` run here on the port's
``SimEngine`` + ``FaultInjector`` + ``Scheduler``; each asserts the
reference test's own property and that the run's trajectory digest and
``metrics()["faults"]`` equal those of the same setup on the JAX
package's simulator. The live-engine cases run on the port's CPU engine:
an empty plan is bit-exact with no injector, and greedy, noise-free runs
under fault plans equal the JAX engine's on the same weights.
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.kv as jkv
import repro.serving.faults as jfaults
import repro.serving.simulator as jsim
import repro_torch.core as tcore
import repro_torch.kv as tkv
import repro_torch.serving.faults as tfaults
import repro_torch.serving.simulator as tsim
from conftest import tiny_config
from prop import given, settings, st
from repro.data import tasks as jtasks
from repro.data import tokenizer as jtk
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.data import tasks as ttasks
from repro_torch.data import tokenizer as tk
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.faults import (CorruptedLogitsFault,
                                        EngineCrashFault, FaultInjector,
                                        FaultPlan, InjectedStepFault)

POISON = tk.STEP       # never appears in a normal prompt


def _pkg(core, sim, faults, kv, tasks):
    return SimpleNamespace(
        Scheduler=core.Scheduler, SchedulerConfig=core.SchedulerConfig,
        SchedulerFaultError=core.SchedulerFaultError,
        SimEngine=sim.SimEngine, SimEngineConfig=sim.SimEngineConfig,
        SimWorkload=sim.SimWorkload, SimPRM=sim.SimPRM, SimTask=sim.SimTask,
        run_sim_experiment=sim.run_sim_experiment,
        FaultInjector=faults.FaultInjector, FaultPlan=faults.FaultPlan,
        OutOfPagesError=kv.OutOfPagesError,
        extract_answer=tasks.extract_answer)


J = _pkg(jcore, jsim, jfaults, jkv, jtasks)
T = _pkg(tcore, tsim, tfaults, tkv, ttasks)


def _digest(m, acc=None):
    """Trajectory fingerprint for bit-exactness comparisons (the
    reference test's)."""
    recs = tuple(
        (r["request_id"], r["arrival"], r["first_service"], r["ttfb"],
         r["finish"], r["e2e"], r["num_completed"], r["num_pruned"],
         r["answer"], tuple(r["response_lengths"]))
        for r in m["requests"])
    return (m["clock"], m["decode_steps"],
            None if acc is None else round(acc, 6), recs)


def _sim_setup(p, num_requests=8, seed=0, plan=None, poison_idx=None,
               engine_kw=None, sched_kw=None, mean_len=80):
    """SimEngine + Scheduler of package ``p`` (optionally fault-injected
    with ``plan``, a dict of ``FaultPlan`` fields) with submitted
    requests; returns (inner_engine, scheduler)."""
    w = p.SimWorkload(mean_len=mean_len, sigma_len=0.5, prompt_len=64,
                      prm_drift=6.0, prm_noise=0.05)
    ec = p.SimEngineConfig(**{**dict(max_slots=32, page_size=8,
                                     num_pages=8192, prefill_chunk=32),
                              **(engine_kw or {})})
    eng = p.SimEngine(ec, w, seed=seed)
    driven = (p.FaultInjector(eng, p.FaultPlan(**plan))
              if plan is not None else eng)
    cfg = p.SchedulerConfig(policy="sart", n=4, window=20,
                            **(sched_kw or {}))
    sch = p.Scheduler(driven, p.SimPRM(eng), cfg, answer_fn=p.extract_answer)
    rng = np.random.default_rng(seed + 1)
    for i in range(num_requests):
        task = p.SimTask(answer=int(rng.integers(0, 10)))
        prompt = [tk.BOS] + [tk.digit(i % 10)] * 62 + [tk.EQUALS]
        if i == poison_idx:
            prompt[1] = POISON
        req = sch.submit(prompt, payload=task, arrival=i * 5)
        eng.tasks[req.request_id] = task
    return eng, sch


def _run_both(**kw):
    """The same setup run on both packages: the port's (engine,
    scheduler, metrics), after asserting that its digest and fault
    counters equal the reference's."""
    out = {}
    for name, p in (("jax", J), ("port", T)):
        eng, sch = _sim_setup(p, **kw)
        out[name] = (eng, sch, sch.run())
    mj, mt = out["jax"][2], out["port"][2]
    assert _digest(mt) == _digest(mj)
    assert mt["faults"] == mj["faults"]
    return out["port"]


# ----------------------------------------------------------------- FaultPlan
def test_faultplan_parse_roundtrip():
    spec = ("seed=3,step_rate=0.1,oop_rate=0.05,crash_at=50+120,"
            "poison_token=5,slow_rate=0.2,slow_penalty=4,admit_fail_rate=0.3")
    plan = FaultPlan.parse(spec)
    assert plan == FaultPlan(seed=3, step_rate=0.1, oop_rate=0.05,
                             crash_at=(50, 120), poison_token=5,
                             slow_rate=0.2, slow_penalty=4,
                             admit_fail_rate=0.3)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        J.FaultPlan.parse(spec))
    assert plan.enabled
    assert not FaultPlan().enabled
    with pytest.raises(ValueError):
        FaultPlan.parse("no_such_field=1")


def _injector_outcomes(p, plan):
    """30 decode steps of one seated branch behind ``p``'s injector: the
    outcome of each (``ok`` or the raised class's name)."""
    w = p.SimWorkload(mean_len=50, prompt_len=16)
    eng = p.SimEngine(p.SimEngineConfig(max_slots=4, page_size=8,
                                        num_pages=512, prefill_chunk=8),
                      w, seed=0)
    inj = p.FaultInjector(eng, p.FaultPlan(**plan))
    assert inj.cfg is eng.cfg and inj.allocator is eng.allocator
    st_ = inj.begin_prefill([tk.BOS] * 8)
    while not st_.done:
        try:
            inj.decode_step()
        except Exception:
            pass
    blocks, lg, ssm = inj.finish_prefill(st_)
    inj.spawn_branch(0, blocks, lg, ssm, 8)
    run = []
    for _ in range(30):
        try:
            inj.decode_step()
            run.append("slow" if inj.last_step_penalty else "ok")
        except Exception as exc:  # every injected class, by name
            run.append(type(exc).__name__)
    return tuple(run), inj.fault_stats()


def test_injector_is_deterministic_and_delegates():
    """Same plan + same call sequence => same injected faults; all
    non-intercepted attributes resolve on the wrapped engine."""
    plan = dict(seed=5, step_rate=0.3)
    a, b = (_injector_outcomes(T, plan)[0] for _ in range(2))
    assert a == b
    assert "InjectedStepFault" in a and "ok" in a


@pytest.mark.parametrize("plan", [
    dict(seed=5, step_rate=0.3),
    dict(seed=1, oop_rate=0.2, step_rate=0.2, nan_rate=0.2, slow_rate=0.2),
    dict(seed=9, nan_rate=0.5, slow_rate=0.5, crash_at=(20,)),
], ids=["step", "all_rates", "nan_slow_crash"])
def test_injector_draws_match_jax(plan):
    """Four uniform draws a step in the order oop, step, nan, slow from
    ``default_rng(seed)``: the port injects what the reference injects,
    step for step, with the same tallies."""
    port, ref = _injector_outcomes(T, plan), _injector_outcomes(J, plan)
    assert port == ref
    assert len(set(port[0])) > 1


def test_injector_crash_then_restart():
    w = tsim.SimWorkload(mean_len=50, prompt_len=16)
    eng = tsim.SimEngine(tsim.SimEngineConfig(
        max_slots=4, page_size=8, num_pages=512, prefill_chunk=8), w, seed=0)
    inj = FaultInjector(eng, FaultPlan(crash_at=(1,)))
    st_ = inj.begin_prefill([tk.BOS] * 8)
    inj.decode_step()                      # step 0: chunk advances
    assert st_.done
    with pytest.raises(EngineCrashFault):
        inj.decode_step()                  # step 1: planned crash
    with pytest.raises(EngineCrashFault):
        inj.decode_step()                  # still down
    inj.restart()
    inj.decode_step()                      # back up
    assert inj.fault_stats()["crash"] == 1
    assert inj.fault_stats()["restarts"] == 1


def test_injector_raises_the_ports_out_of_pages_error():
    """An oop storm raises ``repro_torch.kv.OutOfPagesError``, the class
    the port's scheduler catches for eviction, not the reference's."""
    eng = tsim.SimEngine(tsim.SimEngineConfig(max_slots=2, page_size=8,
                                              num_pages=64),
                         tsim.SimWorkload(mean_len=50, prompt_len=16))
    inj = FaultInjector(eng, FaultPlan(oop_rate=1.0))
    with pytest.raises(tkv.OutOfPagesError) as ei:
        inj.decode_step()
    assert not isinstance(ei.value, J.OutOfPagesError)
    assert inj.fault_stats()["oop"] == 1


def test_oop_storm_lands_in_eviction_not_engine_fault(monkeypatch):
    """Every injected oop storm reaches ``_evict_longest``; the engine
    fault path sees only the eviction stalls it reports, never the storm
    itself."""
    evictions, faults = [], []
    orig_evict = tcore.Scheduler._evict_longest
    orig_fault = tcore.Scheduler._on_engine_fault

    def evict(self):
        freed = orig_evict(self)
        evictions.append(freed)
        return freed

    def fault(self, exc):
        faults.append(exc)
        return orig_fault(self, exc)

    monkeypatch.setattr(tcore.Scheduler, "_evict_longest", evict)
    monkeypatch.setattr(tcore.Scheduler, "_on_engine_fault", fault)
    eng, sch = _sim_setup(T, num_requests=6,
                          plan=dict(seed=2, oop_rate=0.2))
    m = sch.run()
    oop = m["faults"]["injected"]["oop"]
    assert oop > 0 and len(evictions) == oop
    assert all(isinstance(e, tcore.EvictionStallError) for e in faults)
    assert len(faults) == evictions.count(False)
    assert m["unfinished_requests"] == 0
    eng.allocator.check_invariants()
    assert eng.allocator.used_pages == 0


# ----------------------------------------------------- fault-free bit-exact
def test_chaos_disabled_injector_is_bit_exact_sim():
    """With the injector disabled (empty plan), tokens and metrics are
    bit-exact with a no-injector run, and with the reference's."""
    runs = []
    for p, plan in ((T, None), (T, FaultPlan()), (J, J.FaultPlan())):
        m, acc = p.run_sim_experiment(
            "sart", 4, num_requests=10, workload=p.SimWorkload(
                mean_len=120, sigma_len=0.5, prompt_len=128, prompt_tail=16),
            engine_cfg=p.SimEngineConfig(max_slots=32, num_pages=65536,
                                         prefill_chunk=64,
                                         step_token_budget=128,
                                         prefix_cache=True),
            window=50, seed=0, arrival_times=[0, 0, 0, 20, 20, 40, 40,
                                              40, 60, 60],
            fault_plan=plan)
        runs.append(_digest(m, acc))
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0] > 0


# ------------------------------------------ chaos cases against the reference
def _check_poisoned(eng, sch, m):
    """A poisoned prompt ends terminally quarantined with bounded
    retries; every other request completes untouched."""
    bad = m["requests"][2]
    assert bad["quarantined"] and bad["finish"] is None
    assert bad["retries"] == sch.cfg.retry_budget + 1
    assert "PoisonedRequestFault" in sch.requests[2].quarantine_reason
    for r in m["requests"]:
        if r["request_id"] != 2:
            assert not r["quarantined"] and r["finish"] is not None
    f = m["faults"]
    assert f["quarantined"] == 1 and f["quarantined_requests"] == 1
    assert f["retries"] == sch.cfg.retry_budget
    assert eng.allocator.used_pages == 0


def _check_transient(eng, sch, m):
    """A transient admission failure retries with backoff and admits."""
    assert m["unfinished_requests"] == 0
    f = m["faults"]
    assert f["retries"] > 0 and f["quarantined"] == 0
    assert f["recovered"] >= 1
    retried = [r for r in m["requests"] if r["retries"] > 0]
    assert retried and all(r["finish"] is not None for r in retried)


def _check_storm(eng, sch, m):
    """Step faults >= 10% plus a hard crash: every non-poisoned request
    completes, the poisoned one is quarantined, one restart at least."""
    assert len(m["requests"]) == 8
    for r in m["requests"]:
        if r["request_id"] == 5:
            assert r["quarantined"]
        else:
            assert r["finish"] is not None
    f = m["faults"]
    for key in ("quarantined", "retries", "engine_restarts", "recovered",
                "step_faults", "requeued"):
        assert key in f
    assert f["engine_restarts"] >= 1 and f["recovered"] >= 1
    assert f["injected"]["crash"] == 1
    assert eng.allocator.used_pages == 0


def _check_crash_restart(eng, sch, m):
    """Branches completed before the crash are kept; lost in-flight work
    resamples until every request completes."""
    assert m["unfinished_requests"] == 0
    assert m["faults"]["engine_restarts"] >= 1
    for r in m["requests"]:
        assert r["num_completed"] >= 1


CHAOS = {
    "poisoned_admission_quarantines": (
        dict(num_requests=6, plan=dict(seed=1, poison_token=POISON),
             poison_idx=2), _check_poisoned),
    "transient_admission_retries": (
        dict(num_requests=6, plan=dict(seed=4, admit_fail_rate=0.5),
             sched_kw=dict(retry_budget=10)), _check_transient),
    "step_fault_storm_with_crash": (
        dict(num_requests=8, plan=dict(seed=3, step_rate=0.15,
                                       crash_at=(60,), poison_token=POISON),
             poison_idx=5), _check_storm),
    "crash_restart_keeps_completed": (
        dict(num_requests=6, plan=dict(seed=2, crash_at=(100,)),
             mean_len=150), _check_crash_restart),
}


@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_case_matches_jax(case):
    """One chaos case of the reference's tests on the port: its property
    holds, the allocator's invariants hold at exit, and the digest and
    fault counters equal the reference simulator's."""
    kw, check = CHAOS[case]
    eng, sch, m = _run_both(**kw)
    check(eng, sch, m)
    eng.allocator.check_invariants()


def test_chaos_slow_steps_charge_clock():
    """Slow-step injection charges its penalty to the clock: the same
    workload finishes later, on both packages alike."""
    clocks = {}
    for tag, plan in (("clean", None), ("slow", dict(seed=6, slow_rate=0.5,
                                                     slow_penalty=8))):
        ms = [p.run_sim_experiment(
            "sart", 4, num_requests=6,
            workload=p.SimWorkload(mean_len=80, sigma_len=0.4,
                                   prompt_len=64),
            engine_cfg=p.SimEngineConfig(max_slots=32, num_pages=8192,
                                         page_size=8, prefill_chunk=32),
            window=20, seed=0,
            fault_plan=None if plan is None else p.FaultPlan(**plan))[0]
            for p in (J, T)]
        assert _digest(ms[1]) == _digest(ms[0])
        assert ms[1]["faults"] == ms[0]["faults"]
        clocks[tag] = ms[1]["clock"]
        assert ms[1]["unfinished_requests"] == 0
    assert clocks["slow"] > clocks["clean"]


def test_chaos_restart_budget_exhaustion_raises_diagnosable():
    """A fault that persists across max_engine_restarts propagates as
    SchedulerFaultError with the cause chained, after as many restarts
    and step faults as the reference's."""
    counters = []
    for p in (J, T):
        eng, sch = _sim_setup(p, num_requests=2,
                              plan=dict(seed=0, step_rate=1.0),
                              sched_kw=dict(max_engine_restarts=2))
        with pytest.raises(p.SchedulerFaultError) as ei:
            sch.run()
        counters.append((sch.clock, dict(sch.fault_counters),
                         type(ei.value.__cause__).__name__))
    assert isinstance(ei.value.__cause__, InjectedStepFault)
    assert sch.fault_counters["engine_restarts"] == 2
    assert counters[1] == counters[0]


def test_chaos_backoff_is_exponential():
    """not_before grows as retry_backoff * 2**(retries-1) from the clock
    of each failure, then the request is quarantined."""
    eng, sch = _sim_setup(T, num_requests=1)
    req = sch.requests[0]
    for k, clock in enumerate((100, 200, 300)):
        sch.clock = clock
        sch._quarantine_or_requeue(req, RuntimeError("x"))
        assert req.retries == k + 1
        assert req.not_before == clock + (1 << k) * sch.cfg.retry_backoff
    assert not req.quarantined
    sch._quarantine_or_requeue(req, RuntimeError("x"))  # budget exhausted
    assert req.quarantined


# ------------------------------------------------------- eviction escalation
def _evict_scenario(p, *, num_pages, fork):
    """The reference's eviction scenarios on package ``p``: one request,
    two branches whose pages are all shared (through a fork of the parent
    at a page boundary, or with the prefix), and no free page. Returns
    the observations: OutOfPages raised, both ``_evict_longest`` results,
    the completed and truncated counts, free pages after."""
    w = p.SimWorkload(mean_len=10_000, sigma_len=0.1, prompt_len=16)
    eng = p.SimEngine(p.SimEngineConfig(max_slots=4, page_size=8,
                                        num_pages=num_pages,
                                        prefill_chunk=16), w, seed=0)
    sch = p.Scheduler(eng, p.SimPRM(eng), p.SchedulerConfig(
        policy="sart", n=2, m=2, window=4, max_tokens=1 << 20),
        answer_fn=p.extract_answer)
    req = sch.submit([tk.BOS] * 16, payload=p.SimTask())
    eng.tasks[0] = p.SimTask()
    blocks, lg, ssm = eng.prefill(req.prompt)
    if fork:
        parent = eng.spawn_branch(0, blocks, lg, ssm, 16)
        for _ in range(8):
            eng.decode_step()
        assert parent.blocks.length == 24 and len(parent.blocks.pages) == 3
        pair = (parent, eng.fork_branch(parent))   # shares all 3 pages
    else:
        pair = tuple(eng.spawn_branch(0, blocks, lg, ssm, 16)
                     for _ in range(2))
    req.live = {h.branch_id: h for h in pair}
    req.prefix_blocks = blocks
    req.meta = sch.pruner.new_meta(4, 4)            # don't finalize at 2
    req.pending = 2
    assert eng.allocator.free_pages == 0
    oop = False
    if fork:
        try:
            eng.decode_step()
        except p.OutOfPagesError:
            oop = True
    first = sch._evict_longest()
    second = sch._evict_longest() if not fork else None
    obs = (oop, first, second, req.meta.num_completed,
           req.meta.num_truncated, eng.allocator.free_pages)
    eng.release_prefix(blocks)
    eng.allocator.check_invariants()
    return obs


def test_evict_longest_escalates_past_shared_victim():
    """Force-completing the longest branch frees nothing (all its pages
    shared), so eviction escalates to the next victim."""
    obs = _evict_scenario(T, num_pages=3, fork=True)
    assert obs == _evict_scenario(J, num_pages=3, fork=True)
    oop, freed, _, completed, truncated, free = obs
    assert oop and freed is True
    assert completed == 2 and truncated == 2 and free > 0


def test_evict_longest_reports_stall_when_nothing_freeable():
    """No victim frees a page (every page shared with the prefix):
    ``_evict_longest`` reports the stall, twice."""
    obs = _evict_scenario(T, num_pages=2, fork=False)
    assert obs == _evict_scenario(J, num_pages=2, fork=False)
    _, first, second, _, truncated, _ = obs
    assert first is False and second is False and truncated == 2


# ----------------------------------------------------------- truncated drain
def test_chaos_truncated_run_drains_prefilling():
    """A run stopped at max_steps mid-prefill aborts the pending prefills
    and requeues the requests, as the reference's does."""
    queued = []
    for p in (J, T):
        w = p.SimWorkload(mean_len=400, sigma_len=0.4, prompt_len=256)
        eng = p.SimEngine(p.SimEngineConfig(max_slots=8, page_size=8,
                                            num_pages=65536,
                                            prefill_chunk=16), w, seed=0)
        sch = p.Scheduler(eng, p.SimPRM(eng), p.SchedulerConfig(
            policy="sart", n=4, window=10, max_tokens=1 << 20),
            answer_fn=p.extract_answer)
        for i in range(4):
            t = p.SimTask()
            r = sch.submit([tk.BOS] + [tk.digit(i)] * 254 + [tk.EQUALS],
                           payload=t, arrival=i * 4)
            eng.tasks[r.request_id] = t
        m = sch.run(max_steps=8)                 # cap hits mid-prefill
        queued.append((_digest(m),
                       sorted(r.request_id for r in sch.request_queue)))
    assert queued[1] == queued[0]
    assert m["unfinished_requests"] > 0
    assert not sch.prefilling and not eng.has_pending_prefill
    eng.allocator.check_invariants()
    for r in m["requests"]:
        if r["finish"] is None:
            assert r["request_id"] in queued[1][1]


# ---------------------------------------------------------- snapshot/restore
def _snapshot_run(p):
    """Half a run, a JSON snapshot, a restore onto a fresh engine and the
    rest of the run; returns (snapshot, final metrics, sched, engine)."""
    w = p.SimWorkload(mean_len=120, sigma_len=0.5, prompt_len=64,
                      prm_drift=6.0, prm_noise=0.05)
    ec = p.SimEngineConfig(max_slots=16, page_size=8, num_pages=8192,
                           prefill_chunk=32)
    eng = p.SimEngine(ec, w, seed=0)
    cfg = p.SchedulerConfig(policy="sart", n=4, window=20)
    sch = p.Scheduler(eng, p.SimPRM(eng), cfg, answer_fn=p.extract_answer)
    rng = np.random.default_rng(1)
    task_by_id = {}
    for i in range(6):
        t = p.SimTask(answer=int(rng.integers(0, 10)))
        r = sch.submit([tk.BOS] + [tk.digit(i)] * 62 + [tk.EQUALS],
                       payload=t, arrival=i * 5)
        eng.tasks[r.request_id] = t
        task_by_id[r.request_id] = t
    sch.run(max_steps=80)                    # half-done "crash point"
    snap = json.loads(json.dumps(sch.snapshot()))   # wire round-trip
    eng2 = p.SimEngine(ec, w, seed=7)        # fresh engine: KV pages gone
    for rid, t in task_by_id.items():
        eng2.tasks[rid] = t
    sch2 = p.Scheduler.restore(snap, eng2, p.SimPRM(eng2), cfg,
                               p.extract_answer)
    assert sch2.clock == snap["clock"]
    return snap, sch2.run(), sch2, eng2


def test_chaos_snapshot_restore_roundtrip_completes():
    """Snapshot a half-done run, restore it onto a fresh engine and
    finish: completed branches survive, nothing is dropped; the snapshot
    and the finished run equal the reference's."""
    snap_j, m_j, _, _ = _snapshot_run(J)
    snap, m, sch2, eng2 = _snapshot_run(T)
    assert snap == snap_j
    assert _digest(m) == _digest(m_j) and m["faults"] == m_j["faults"]
    assert snap["version"] == 1 and snap["clock"] >= 80
    assert m["unfinished_requests"] == 0 and len(m["requests"]) == 6
    eng2.allocator.check_invariants()
    assert eng2.allocator.used_pages == 0
    for rec in snap["requests"]:
        kept = [tuple(t_) for t_, _, _ in
                sch2.requests[rec["request_id"]].completed]
        for c in rec["completed"]:
            assert tuple(c[0]) in kept
    assert sch2._next_request_id == snap["next_request_id"]


def test_chaos_snapshot_rejects_unknown_version():
    eng, sch = _sim_setup(T, num_requests=1)
    snap = sch.snapshot()
    snap["version"] = 99
    with pytest.raises(ValueError):
        tcore.Scheduler.restore(snap, eng, tsim.SimPRM(eng), sch.cfg,
                                ttasks.extract_answer)


# -------------------------------------------------------- property: sim chaos
@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000),
       st.floats(0.0, 0.25),
       st.floats(0.0, 0.2),
       st.booleans(),
       st.booleans())
def test_chaos_property_sim_interleavings(seed, step_rate, oop_rate,
                                          crash, cached):
    """Random fault interleavings on the port's SimEngine: allocator
    invariants hold at exit and every request is terminally accounted;
    the run (or its escape through SchedulerFaultError) equals the
    reference's."""
    plan = dict(seed=seed, step_rate=step_rate, oop_rate=oop_rate,
                nan_rate=step_rate / 2, slow_rate=oop_rate,
                crash_at=(40 + seed % 60,) if crash else (),
                poison_token=POISON)
    outcomes = []
    for p in (J, T):
        eng, sch = _sim_setup(
            p, num_requests=6, seed=seed % 7, plan=plan,
            poison_idx=seed % 6 if seed % 3 == 0 else None,
            engine_kw=dict(prefix_cache=cached, num_pages=4096))
        try:
            m = sch.run(max_steps=100_000)
        except p.SchedulerFaultError:
            eng.allocator.check_invariants()
            outcomes.append(("escaped", sch.clock, dict(sch.fault_counters)))
            continue
        outcomes.append((_digest(m), m["faults"]))
    assert outcomes[1] == outcomes[0]
    if outcomes[1][0] == "escaped":
        return
    assert len(m["requests"]) == 6
    for r in m["requests"]:
        assert r["finish"] is not None or r["quarantined"], \
            f"request {r['request_id']} dropped"
    eng.allocator.check_invariants()
    assert eng.allocator.used_pages == 0
    f = m["faults"]
    assert f["quarantined_requests"] == sum(
        1 for r in m["requests"] if r["quarantined"])


# ------------------------------------------------------- live engine (CPU)
LIVE_ECFG = dict(page_size=8, num_pages=128, max_slots=4,
                 max_pages_per_branch=8, eos_id=tk.EOS, seed=1,
                 prefill_chunk=8)


@pytest.fixture(scope="module")
def live_weights():
    """The tiny dense model's weights in both packages (the bridge of
    ``tests/test_torch_scheduler.py``)."""
    cfg = tiny_config(vocab_size=jtk.VOCAB_SIZE)
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    return jm, jp, tm, params_from_numpy(_flatten(jp), device="cpu")


def _live_run(eng, plan, seed, injector, core, tasks, noise):
    """The reference test's live scheduler over ``eng`` (3 problems, SART
    n=2, m=1, window 8, 24 tokens), optionally behind ``injector``."""
    driven = injector(eng, plan) if plan is not None else eng
    prm = core.OraclePRM(tasks.oracle_grader, noise=noise, seed=2)
    sch = core.Scheduler(driven, prm, core.SchedulerConfig(
        policy="sart", n=2, m=1, window=8, max_tokens=24),
        answer_fn=tasks.extract_answer)
    rng = np.random.default_rng(seed + 3)
    for i in range(3):
        prob = tasks.gen_problem(rng)
        sch.submit(prob.prompt_tokens(), payload=prob, arrival=i * 2)
    return sch.run(max_steps=50_000)


def test_chaos_disabled_injector_is_bit_exact_live_engine(live_weights):
    """On the port's engine, sampling at temperature 1 with a noisy
    oracle, an empty-plan injector run matches the bare-engine run token
    for token."""
    _, _, tm, tp = live_weights
    runs = []
    for plan in (None, FaultPlan()):
        eng = Engine(tm, tp, EngineConfig(
            sampling=SamplingParams(temperature=1.0), **LIVE_ECFG))
        m = _live_run(eng, plan, 0, FaultInjector, tcore, ttasks, 0.05)
        runs.append(_digest(m))
        assert eng.allocator.used_pages == 0
    assert runs[0] == runs[1]


@pytest.mark.parametrize("seed,crash_at", [(0, (30,)), (1, ()), (2, (30,)),
                                           (0, (8,))])
def test_chaos_live_engine_interleavings_match_jax(live_weights, seed,
                                                   crash_at):
    """Step, oop and crash interleavings on the port's CPU engine with the
    prefix cache, greedy and noise-free: the restart tears down real KV
    state, every request is terminally accounted, and the digest and
    fault counters equal the JAX engine's on the same weights. The
    reference's three plans end before a crash at step 30 here; the
    fourth crashes at step 8, mid-run."""
    jm, jp, tm, tp = live_weights
    spec = dict(seed=seed, step_rate=0.1, oop_rate=0.05, crash_at=crash_at)
    je = JEngine(jm, jp, JEngineConfig(
        sampling=JSampling(temperature=0.0), prefix_cache=True, **LIVE_ECFG))
    te = Engine(tm, tp, EngineConfig(
        sampling=SamplingParams(temperature=0.0), prefix_cache=True,
        **LIVE_ECFG))
    mj = _live_run(je, J.FaultPlan(**spec), seed, J.FaultInjector, jcore,
                   jtasks, 0.0)
    m = _live_run(te, FaultPlan(**spec), seed, FaultInjector, tcore, ttasks,
                  0.0)
    assert _digest(m) == _digest(mj)
    assert m["faults"] == mj["faults"]
    assert m["faults"]["injected"]["step"] > 0
    assert len(m["requests"]) == 3
    for r in m["requests"]:
        assert r["finish"] is not None or r["quarantined"]
    te.allocator.check_invariants()
    assert all(s is None for s in te.slots)
    assert te.allocator.used_pages == je.allocator.used_pages
    if m["faults"]["injected"]["crash"]:
        assert m["faults"]["engine_restarts"] >= 1
        assert m["faults"]["requeued"] >= 1
    if crash_at == (8,):
        assert m["faults"]["injected"]["crash"] == 1


def test_corrupted_logits_fault_follows_a_step_that_ran(live_weights):
    """A nan fault raises after the inner step ran: the engine counted
    the step and its chunk lane advanced."""
    _, _, tm, tp = live_weights
    eng = Engine(tm, tp, EngineConfig(
        sampling=SamplingParams(temperature=0.0), **LIVE_ECFG))
    inj = FaultInjector(eng, FaultPlan(nan_rate=1.0))
    st_ = inj.begin_prefill([tk.BOS] + [tk.digit(3)] * 10)
    with pytest.raises(CorruptedLogitsFault):
        inj.decode_step()
    assert eng.decode_steps_executed == 1 and inj.fault_stats()["nan"] == 1
    assert st_.next_pos == 8
    eng.abort_prefill(st_)
    eng.allocator.check_invariants()


def test_run_serving_with_fault_plan_on_cpu():
    """``fault_plan`` passes through the launcher's run function: the
    scheduler drives a ``FaultInjector``, the summary's ``faults`` dict
    carries its tallies, and the engine returned is the inner one."""
    from repro_torch.launch.serve import load_reasoner, run_serving
    model, params, prm = load_reasoner(None, device="cpu")
    out, engine = run_serving(
        model, params, prm, policy="sart", n=4, num_requests=4, rate_gap=4,
        prm_kind="oracle", window=8, max_tokens=32, max_slots=8, seed=0,
        temperature=0.9, fault_plan="seed=3,step_rate=0.1,crash_at=20")
    assert isinstance(engine, Engine)
    inj = out["faults"]["injected"]
    assert inj["crash"] == 1 and inj["step"] > 0
    assert out["faults"]["engine_restarts"] >= 1
    assert out["completed_requests"] == 4
    assert engine.allocator.used_pages == 0
    assert all(s is None for s in engine.slots)
    assert inj["steps_seen"] > out["decode_steps"] == \
        engine.decode_steps_executed
