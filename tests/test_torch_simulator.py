"""The port's trace-driven simulator against the JAX package's.

``repro_torch.serving.simulator`` is host-only numpy over the port's
engine helpers, allocator, prefix cache and scheduler. A run touches no
tensor, so it must equal the reference's bit for bit: the whole
``metrics()`` dict (timeline included) and the accuracy, for every policy
and every admission feature the experiments use. The six properties of
``tests/test_simulator.py`` are rerun on the port.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.scheduler import POLICIES as J_POLICIES
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import simulator as jsim
from repro_torch import baselines
from repro_torch.core.scheduler import POLICIES, percentile_latency
from repro_torch.serving import FaultPlan
from repro_torch.serving import simulator as tsim
from repro_torch.serving.engine import derive_lane_configs


def _fast_workload(sim, **kw):
    base = dict(mean_len=120, sigma_len=0.5, overthink_p=0.15,
                overthink_mult=4.0, prompt_len=16)
    base.update(kw)
    return sim.SimWorkload(**base)


def _cfg(sim, **kw):
    base = dict(max_slots=16, page_size=8, num_pages=4096)
    base.update(kw)
    return sim.SimEngineConfig(**base)


def _plain(m):
    """``metrics()`` with its timeline as a dict, comparable across the
    two packages' ``Timeline`` classes."""
    return dict(m, timeline=dataclasses.asdict(m["timeline"]))


def _policy(policy, n):
    def build(sim):
        return (policy, n), dict(num_requests=10, arrival_gap=20,
                                 workload=_fast_workload(sim),
                                 engine_cfg=_cfg(sim), window=25, seed=0)
    return build


def _prefix_cache(sim):
    return ("sart", 4), dict(
        num_requests=10, arrival_gap=6, window=25, seed=1,
        workload=_fast_workload(sim, prompt_len=128, prompt_tail=16),
        engine_cfg=_cfg(sim, prefill_chunk=32, prefix_cache=True))


def _token_budget(sim):
    return ("sart", 4), dict(
        num_requests=12, window=25, seed=2,
        arrival_times=sim.poisson_burst_arrivals(12, burst_gap=30,
                                                 burst_mean=2.0),
        workload=_fast_workload(sim, prompt_len=96),
        engine_cfg=_cfg(sim, prefill_chunk=32, step_token_budget=96))


def _edf(sim):
    times, deadlines = sim.mixed_deadline_workload(
        num_loose=6, num_tight=4, loose_slack=800, tight_slack=150)
    return ("sart", 4), dict(
        num_requests=10, window=25, seed=3, arrival_times=times,
        deadlines=deadlines, admission_policy="edf",
        workload=_fast_workload(sim, prompt_len=128),
        engine_cfg=_cfg(sim, prefill_chunk=16))


def _lpm(sim):
    prompts, times = sim.adversarial_shared_header_mix(
        num_warm=3, num_cold=4, prompt_len=128, header_len=96, burst_at=40)
    return ("sart", 4), dict(
        num_requests=len(prompts), window=25, seed=4, prompts=prompts,
        arrival_times=times, admission_policy="lpm",
        workload=_fast_workload(sim, prompt_len=128, mean_len=60),
        engine_cfg=_cfg(sim, page_size=16, num_pages=56, prefill_chunk=32,
                        prefix_cache=True))


def _faults(sim):
    plan = (FaultPlan if sim is tsim else JFaultPlan)(
        seed=5, step_rate=0.05, oop_rate=0.03, nan_rate=0.03,
        slow_rate=0.05, crash_at=(70,), admit_fail_rate=0.2)
    return ("sart", 4), dict(num_requests=10, arrival_gap=10, window=25,
                             seed=5, workload=_fast_workload(sim),
                             engine_cfg=_cfg(sim), fault_plan=plan)


CASES = {
    **{p: _policy(p, n) for p, n in (("sart", 8), ("sart_noprune", 8),
                                     ("sc", 4), ("rebase", 4),
                                     ("vanilla", 1))},
    "prefix_cache_prompt_tail": _prefix_cache,
    "token_budget_poisson_bursts": _token_budget,
    "edf_mixed_deadlines": _edf,
    "lpm_adversarial_header": _lpm,
    "fault_plan": _faults,
}


@pytest.mark.parametrize("case", list(CASES))
def test_sim_experiment_matches_jax(case):
    """The same experiment on both packages: equal metrics, bit for bit,
    and equal accuracy."""
    runs = []
    for sim in (jsim, tsim):
        args, kw = CASES[case](sim)
        m, acc = sim.run_sim_experiment(*args, **kw)
        runs.append((_plain(m), acc))
    (mj, aj), (mt, at) = runs
    assert mt == mj and at == aj
    assert len(mt["requests"]) == CASES[case](tsim)[1]["num_requests"]
    assert mt["clock"] > 0 and mt["decode_steps"] > 0
    if case == "prefix_cache_prompt_tail":
        assert mt["prefix_cache"]["hit_tokens"] > 0
    if case == "token_budget_poisson_bursts":
        assert max(mt["timeline"]["live_branches"]) > 0
    if case == "edf_mixed_deadlines":
        assert mt["admission_policy"] == "edf"
        assert mt["slo"]["with_deadline"] == 10
    if case == "lpm_adversarial_header":
        assert mt["admission_policy"] == "lpm"
        assert sum(r["cached_tokens"] for r in mt["requests"]) > 0
    if case == "fault_plan":
        inj = mt["faults"]["injected"]
        assert inj["step"] > 0 and inj["crash"] == 1
        assert mt["faults"]["engine_restarts"] >= 1


# ------------------------------------- tests/test_simulator.py on the port
@pytest.mark.parametrize("policy,n", [("vanilla", 1), ("sc", 4),
                                      ("sart", 8), ("sart_noprune", 8),
                                      ("rebase", 4)])
def test_sim_policies_complete(policy, n):
    m, acc = tsim.run_sim_experiment(
        policy, n, num_requests=10, arrival_gap=20,
        workload=_fast_workload(tsim), engine_cfg=_cfg(tsim), window=25,
        seed=0)
    assert len(m["requests"]) == 10
    assert 0.0 <= acc <= 1.0


def test_sart_beats_sc_latency_at_same_n():
    w = _fast_workload(tsim)
    m_sc, _ = tsim.run_sim_experiment("sc", 4, num_requests=20,
                                      arrival_gap=15, workload=w,
                                      engine_cfg=_cfg(tsim), window=25,
                                      seed=1)
    m_sart, _ = tsim.run_sim_experiment("sart", 8, num_requests=20,
                                        arrival_gap=15, workload=w,
                                        engine_cfg=_cfg(tsim), window=25,
                                        seed=1)
    assert percentile_latency(m_sart, 50) < percentile_latency(m_sc, 50)


def test_early_stopping_shortens_tail():
    """Paper Fig. 7: tail latency improves with redundant sampling,
    averaged over seeds as the reference's test does."""
    w = _fast_workload(tsim, overthink_p=0.3)

    def p97(policy, n, seed):
        m, _ = tsim.run_sim_experiment(
            policy, n, num_requests=30, arrival_gap=30, workload=w,
            engine_cfg=_cfg(tsim, max_slots=32), window=25, seed=seed)
        return percentile_latency(m, 97, "inference")

    seeds = (0, 1, 2)
    tail_vanilla = np.mean([p97("vanilla", 1, s) for s in seeds])
    tail_sart = np.mean([p97("sart", 8, s) for s in seeds])
    assert tail_sart < tail_vanilla


def test_pruning_reduces_queue_vs_noprune():
    """Paper Fig. 6: pruning shrinks queuing time under load."""
    kw = dict(num_requests=24, arrival_gap=5, workload=_fast_workload(tsim),
              engine_cfg=_cfg(tsim, max_slots=8), window=25, seed=3)
    m_np, _ = tsim.run_sim_experiment("sart_noprune", 8, **kw)
    m_p, _ = tsim.run_sim_experiment("sart", 8, **kw)
    assert percentile_latency(m_p, 90, "queue") <= \
        percentile_latency(m_np, 90, "queue")


def test_prm_discriminates_quality():
    eng = tsim.SimEngine(_cfg(tsim),
                         _fast_workload(tsim, prm_noise=0.0, prm_drift=6.0),
                         seed=0)
    blocks, lg, ssm = eng.prefill([0] * 16)
    goods, bads = [], []
    for _ in range(40):
        h = eng.spawn_branch(0, blocks, lg, ssm, 16)
        spec = eng._specs[h.branch_id]
        h.tokens = [0] * max(spec.length - 1, 1)
        (goods if spec.correct else bads).append(eng.reward_of(h))
        eng.free_branch(h)
    eng.release_prefix(blocks)
    assert goods and bads
    assert np.mean(goods) > np.mean(bads)


def test_sim_engine_memory_accounting():
    eng = tsim.SimEngine(_cfg(tsim, num_pages=64, max_slots=4),
                         _fast_workload(tsim), seed=0)
    blocks, lg, ssm = eng.prefill([0] * 16)
    hs = [eng.spawn_branch(0, blocks, lg, ssm, 16) for _ in range(3)]
    for _ in range(5):
        eng.decode_step()
    assert eng.live_tokens() == 3 * (16 + 5)
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    assert eng.allocator.used_pages == 0


# ------------------------------------------------------- the port's parts
def test_baselines_reexport_the_port_scheduler():
    """``repro_torch.baselines`` re-exports the port scheduler's policy
    table, the same policies as the reference's."""
    from repro_torch.core import Scheduler, SchedulerConfig
    assert baselines.POLICIES is POLICIES
    assert baselines.Scheduler is Scheduler
    assert baselines.SchedulerConfig is SchedulerConfig
    assert tuple(POLICIES) == tuple(J_POLICIES)


@pytest.mark.parametrize("budget", [0, 128, 256])
def test_sim_step_variants_match_jax(budget):
    """The simulator's variants are the reference simulator's, and a
    projection of the port engine's lane enumeration at one bucket."""
    variants = []
    for sim in (jsim, tsim):
        eng = sim.SimEngine(_cfg(sim, prefill_chunk=64,
                                 step_token_budget=budget),
                            _fast_workload(sim), seed=0)
        variants.append([(v.name, v.lane_buckets)
                         for v in eng.step_variants()])
    assert variants[1] == variants[0]
    lanes = derive_lane_configs((), budget, 64)
    assert variants[1] == [("decode", ())] + [
        (f"mixed:b64xl{n}", (64,) * n) for n in lanes]


def test_sim_step_token_budget_requires_chunking():
    """The simulator keeps the engine's configuration contract."""
    with pytest.raises(ValueError):
        tsim.SimEngine(_cfg(tsim, step_token_budget=128,
                            chunked_prefill=False),
                       _fast_workload(tsim))
    with pytest.raises(ValueError):
        tsim.SimEngine(_cfg(tsim, prefix_cache=True, chunked_prefill=False),
                       _fast_workload(tsim))
