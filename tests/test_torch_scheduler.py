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


def _run(sch_cls, cfg_cls, prm_cls, task_mod, engine, policy):
    prm = prm_cls(task_mod.oracle_grader, noise=0.0, seed=2)
    sch = sch_cls(engine, prm, cfg_cls(policy=policy, n=4, window=8,
                                       max_tokens=24),
                  answer_fn=task_mod.extract_answer)
    rng = np.random.default_rng(3)
    for i in range(3):
        prob = task_mod.gen_problem(rng)
        sch.submit(prob.prompt_tokens(), payload=prob, arrival=i * 5)
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


def test_run_serving_on_cpu_completes():
    """The launcher's run function (engine + scheduler + request loop)
    serves every request with no fault and returns every page."""
    model, params, prm = load_reasoner(None, device="cpu")
    out, engine = run_serving(
        model, params, prm, policy="sart", n=4, num_requests=3, rate_gap=4,
        prm_kind="oracle", window=8, max_tokens=32, max_slots=8, seed=0,
        temperature=0.9)
    assert out["completed_requests"] == 3
    assert out["unfinished_requests"] == 0
    assert out["faults"]["step_faults"] == 0
    assert out["clock"] == out["decode_steps"]
    assert engine.allocator.used_pages == 0
    assert engine.tokens_generated > 0
    assert len(engine.step_seconds) == engine.decode_steps_executed
