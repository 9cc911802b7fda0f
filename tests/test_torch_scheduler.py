"""The port's SART scheduler on the port's engine against the JAX pair.

Same weights, greedy sampling and a noise-free ``OraclePRM`` make both
runs deterministic, so the whole control flow must coincide: answers,
decode steps, the scheduler clock, completions, prunes and latencies.
The serve launcher's run function is also driven end to end on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest

from conftest import tiny_config
from repro.core import OraclePRM as JOraclePRM
from repro.core import Scheduler as JScheduler
from repro.core import SchedulerConfig as JSchedulerConfig
from repro.data import tasks as jtasks
from repro.data import tokenizer as jtk
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import SamplingParams as JSampling
from repro.training.checkpoint import _flatten
from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
from repro_torch.data import tasks
from repro_torch.launch.serve import load_reasoner, run_serving
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams

ECFG = dict(page_size=8, num_pages=256, max_slots=8, max_pages_per_branch=16,
            eos_id=jtk.EOS, seed=1)


def _run(sch_cls, cfg_cls, prm_cls, task_mod, engine, policy, header=()):
    prm = prm_cls(task_mod.oracle_grader, noise=0.0, seed=2)
    sch = sch_cls(engine, prm, cfg_cls(policy=policy, n=4, window=8,
                                       max_tokens=24),
                  answer_fn=task_mod.extract_answer)
    rng = np.random.default_rng(3)
    for i in range(3):
        prob = task_mod.gen_problem(rng)
        sch.submit(list(header) + prob.prompt_tokens(), payload=prob,
                   arrival=i * 5)
    m = sch.run(max_steps=5000)
    return m, engine


def _summary(m):
    keys = ("request_id", "arrival", "first_service", "finish", "queue",
            "ttfb", "num_completed", "num_pruned", "num_truncated",
            "answer", "response_lengths")
    return ([{k: r[k] for k in keys} for r in m["requests"]],
            m["clock"], m["decode_steps"], m["completed_requests"],
            m["unfinished_requests"], m["faults"])


@pytest.mark.parametrize("policy", ["sart", "sart_noprune", "sc", "rebase"])
def test_scheduler_matches_jax(policy):
    """Greedy + noise-free oracle: identical per-request records, clock,
    decode steps and fault counters; both pools drain to zero."""
    cfg = tiny_config(vocab_size=jtk.VOCAB_SIZE)
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    je = JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0), **ECFG))
    te = Engine(tm, tp, EngineConfig(sampling=SamplingParams(temperature=0.0),
                                     **ECFG))
    jm_, je = _run(JScheduler, JSchedulerConfig, JOraclePRM, jtasks, je,
                   policy)
    tm_, te = _run(Scheduler, SchedulerConfig, OraclePRM, tasks, te, policy)
    assert _summary(tm_) == _summary(jm_)
    assert tm_["completed_requests"] == 3
    assert te.allocator.used_pages == 0 == je.allocator.used_pages
    te.allocator.check_invariants()


@pytest.mark.parametrize("policy", ["sart", "rebase"])
def test_scheduler_with_cache_and_tree_matches_jax(policy):
    """Prompts behind a shared 16-token header, prefix cache and tree
    decode on in both packages: the same per-request records (the later
    requests admit warm), clock and cache counters."""
    cfg = tiny_config(vocab_size=jtk.VOCAB_SIZE)
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    ecfg = dict(ECFG, prefix_cache=True, decode_kernel="tree")
    je = JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0), **ecfg))
    te = Engine(tm, tp, EngineConfig(sampling=SamplingParams(temperature=0.0),
                                     **ecfg))
    header = [3 + i % 10 for i in range(16)]
    jm_, je = _run(JScheduler, JSchedulerConfig, JOraclePRM, jtasks, je,
                   policy, header)
    tm_, te = _run(Scheduler, SchedulerConfig, OraclePRM, tasks, te, policy,
                   header)
    assert _summary(tm_) == _summary(jm_)
    assert [r["cached_tokens"] for r in tm_["requests"]] == \
        [r["cached_tokens"] for r in jm_["requests"]] == [0, 16, 16]
    assert tm_["prefix_cache"] == jm_["prefix_cache"]
    assert te.allocator.used_pages == 0 == je.allocator.used_pages
    te.allocator.check_invariants()


def test_run_serving_on_cpu_completes():
    """The launcher's run function (engine + scheduler + request loop)
    serves every request with no fault and returns every page; with the
    tracer on, each decode step is one ``engine.decode_step`` span."""
    from repro_torch import spans
    model, params, prm = load_reasoner(None, device="cpu")
    spans.enable()
    try:
        out, engine = run_serving(
            model, params, prm, policy="sart", n=4, num_requests=3,
            rate_gap=4, prm_kind="oracle", window=8, max_tokens=32,
            max_slots=8, seed=0, temperature=0.9)
        names = list(spans.snapshot()["name"])
    finally:
        spans.disable()
    assert out["completed_requests"] == 3
    assert out["unfinished_requests"] == 0
    assert out["faults"]["step_faults"] == 0
    assert out["clock"] == out["decode_steps"]
    assert engine.allocator.used_pages == 0
    assert engine.tokens_generated > 0
    assert names.count("engine.decode_step") == \
        engine.decode_steps_executed


def test_run_serving_with_prefix_cache_on_cpu():
    """``prefix_cache`` passes through the launcher's run function to the
    engine; the run completes with no fault and looks every prompt up."""
    model, params, prm = load_reasoner(None, device="cpu")
    out, engine = run_serving(
        model, params, prm, policy="sart", n=4, num_requests=3, rate_gap=4,
        prm_kind="oracle", window=8, max_tokens=32, max_slots=8, seed=0,
        temperature=0.9, prefix_cache=True)
    assert engine.cfg.prefix_cache
    assert out["completed_requests"] == 3
    assert out["faults"]["step_faults"] == 0
    assert out["prefix_cache"]["lookups"] == 3
    assert engine.allocator.used_pages == 0


def _ssm_pair(family, **ecfg):
    """(jax engine, port engine) of a FAMILY_CONFIGS family, equal
    weights, greedy, chunk 8."""
    from conftest import FAMILY_CONFIGS
    cfg = tiny_config(vocab_size=jtk.VOCAB_SIZE, **FAMILY_CONFIGS[family])
    jm = JModel(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_numpy(_flatten(jp), device="cpu")
    e = dict(ECFG, prefill_chunk=8, **ecfg)
    return (JEngine(jm, jp, JConfig(sampling=JSampling(temperature=0.0), **e)),
            Engine(tm, tp, EngineConfig(
                sampling=SamplingParams(temperature=0.0), **e)))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssm_scheduler_matches_jax(family):
    """The SART scheduler over ssm and hybrid engines: ``req.ssm_state``
    flows from ``finish_prefill`` to every ``spawn_branch``, and the
    per-request records, clock and decode steps equal the reference's."""
    je, te = _ssm_pair(family)
    jm_, je = _run(JScheduler, JSchedulerConfig, JOraclePRM, jtasks, je,
                   "sart")
    tm_, te = _run(Scheduler, SchedulerConfig, OraclePRM, tasks, te, "sart")
    assert _summary(tm_) == _summary(jm_)
    assert tm_["completed_requests"] == 3
    assert te.allocator.used_pages == 0 == je.allocator.used_pages


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssm_preemption_matches_jax(family):
    """Preemption with 3 slots for 4 branches per request: the scheduler
    suspends and resumes SSM branches through the port's
    ``suspend_branch``/``resume_branch`` as often as the reference does,
    with the same records; every request completes, no page leaks."""
    counts = []

    def run(sch_cls, cfg_cls, prm_cls, task_mod, engine):
        n = {"suspend": 0, "resume": 0}
        for name in n:
            orig = getattr(engine, f"{name}_branch")

            def spy(h, _orig=orig, _name=name):
                n[_name] += 1
                return _orig(h)
            setattr(engine, f"{name}_branch", spy)
        prm = prm_cls(task_mod.oracle_grader, noise=0.0, seed=2)
        sch = sch_cls(engine, prm, cfg_cls(policy="sart", n=4, window=8,
                                           max_tokens=24, preempt=True),
                      answer_fn=task_mod.extract_answer)
        rng = np.random.default_rng(3)
        for i in range(3):
            prob = task_mod.gen_problem(rng)
            sch.submit(prob.prompt_tokens(), payload=prob, arrival=i * 5)
        counts.append(n)
        return sch.run(max_steps=5000)

    je, te = _ssm_pair(family, max_slots=3)
    jm_ = run(JScheduler, JSchedulerConfig, JOraclePRM, jtasks, je)
    tm_ = run(Scheduler, SchedulerConfig, OraclePRM, tasks, te)
    assert counts[1] == counts[0] and counts[1]["suspend"] > 0
    assert _summary(tm_) == _summary(jm_)
    assert tm_["completed_requests"] == 3
    assert te.allocator.used_pages == 0


@pytest.mark.parametrize("arch", ["ssm", "hybrid"])
def test_run_serving_ssm_fallback_on_cpu(arch):
    """``load_reasoner(arch=...)`` builds the reference's fallback trunk
    of the family; the launcher's run serves every request with no fault
    and returns every page."""
    model, params, prm = load_reasoner(None, device="cpu", arch=arch)
    assert model.cfg.arch_type == arch and model.cfg.name == \
        f"untrained-{arch}"
    out, engine = run_serving(
        model, params, prm, policy="sart", n=4, num_requests=3, rate_gap=4,
        prm_kind="oracle", window=8, max_tokens=32, max_slots=8, seed=0,
        temperature=0.9)
    assert out["completed_requests"] == 3
    assert out["unfinished_requests"] == 0
    assert out["faults"]["step_faults"] == 0
    assert engine.allocator.used_pages == 0
    assert engine.mixed_steps_executed > 0


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_exact_prefill_scheduler_matches_jax(family):
    """``chunked_prefill=False``: every admission is one synchronous exact
    pass and one scheduler tick, so the clock runs ahead of the decode
    steps by the number of admissions; the per-request records, clock,
    decode steps and faults equal the reference's, with no mixed step."""
    je, te = _ssm_pair(family, chunked_prefill=False)
    jm_, je = _run(JScheduler, JSchedulerConfig, JOraclePRM, jtasks, je,
                   "sart")
    tm_, te = _run(Scheduler, SchedulerConfig, OraclePRM, tasks, te, "sart")
    assert _summary(tm_) == _summary(jm_)
    assert tm_["completed_requests"] == 3
    assert tm_["clock"] == tm_["decode_steps"] + 3
    assert te.exact_prefills == 3 and te.mixed_steps_executed == 0
    assert te.allocator.used_pages == 0 == je.allocator.used_pages
