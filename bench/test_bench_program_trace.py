"""The program's trace over a run: idle time goes to the innermost program
span open on the host by exact interval intersection; on a tiny CPU run
with the tracer on the host readers read numbers and the device readers
nothing; a run without the tracer leaves it off, and the readers read
nothing from a program that has no tracer or stamps."""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import pytest

from bench import run as bench_run
from bench import trace_program
from bench.conftest import TINY_MOE, tiny_cell
from bench.lib import program_trace as pt
from bench.lib import spec

SEED = 2**31 + 91


def test_idle_goes_to_the_innermost_span_open_then():
    # a step (0-10) with its sync (6-9), the scheduler (10-14) around a
    # free_branch (11-12), then the next step's host work (14-18); the
    # device runs 1-9 and 17-20; the window is 0-20
    ranges = [(0, 10, "engine.decode_step"), (6, 9, "engine.sync"),
              (10, 14, "sched.window"), (11, 12, "engine.free_branch"),
              (14, 18, "engine.decode_step"),
              (15, 16, "engine.pages")]
    idle = pt.attribute_idle([(1, 5), (4, 9), (17, 20)], ranges, 0, 20)
    # the gap 9-17 is split: 9-10 the step's own commit time, 10-11 and
    # 12-14 the scheduler, 11-12 the engine's free_branch, 14-15 and
    # 16-17 the next step, 15-16 its page accounting; none to its
    # midpoint's owner alone
    assert idle == {"engine.decode_step": 1 + 1 + 1 + 1,
                    "sched.window": 3, "engine.free_branch": 1,
                    "engine.pages": 1, pt.OUTSIDE: 0}
    assert sum(idle.values()) == 20 - 8 - 3
    by_layer = {}
    for k, v in idle.items():
        by_layer[pt.layer_of(k)] = by_layer.get(pt.layer_of(k), 0) + v
    assert by_layer == {"engine": 6, "sched": 3, pt.OUTSIDE: 0}
    # time outside every range, and ranges that close out of turn
    idle = pt.attribute_idle([], [(2, 6, "a"), (3, 8, "b")], 0, 10)
    assert idle == {"a": 1, "b": 5, pt.OUTSIDE: 4}


def test_outside_is_the_idle_time_no_span_covers():
    # idle 0-3 and 6-12 of 0-12; spans cover 2-4 and 7-8 (nested 7.5-8),
    # and one opens before the window and ends inside a gap (-1 to 0.5)
    ranges = [(-1, 0.5, "sched.fill"), (2, 4, "engine.pages"),
              (7, 8, "engine.decode_step"), (7.5, 8, "engine.sync")]
    idle = pt.attribute_idle([(3, 6)], ranges, 0, 12)
    assert idle == {"sched.fill": 0.5, "engine.pages": 1,
                    "engine.decode_step": 0.5, "engine.sync": 0.5,
                    pt.OUTSIDE: 9 - 2.5}
    assert sum(idle.values()) == 9
    assert pt._overlap([(0, 3), (6, 12)], [(2, 4), (7, 8)]) == 2


def test_self_time_subtracts_direct_children():
    snap = {"seq": [0, 1, 2, 3], "parent": [-1, 0, 1, 0],
            "t0_ns": [0, 10, 20, 60], "t1_ns": [100, 50, 30, 90]}
    snap = {k: np.asarray(v) for k, v in snap.items()}
    own = pt.ProgramTrace(snap, None).self_ns()
    assert own.tolist() == [100 - 40 - 30, 40 - 10, 10, 30]


def _tiny_moe(**per_layer):
    cell = tiny_cell(TINY_MOE)
    return dataclasses.replace(cell, per_layer=[
        {"name": n, "unit": "s"} for n in per_layer])


def test_a_traced_cpu_run_reads_host_numbers_and_no_device_ones(one_thread):
    cell = tiny_cell(TINY_MOE)
    out, run, notes, prog = trace_program.trace_cell(
        cell, SEED, 2.0, "cpu", time.perf_counter())
    from repro_torch import spans
    assert not spans.enabled()
    m = prog["metrics"]
    for name in ("engine_host_ms.serve", "sched_host_ms.serve",
                 "queue_wait_p50_s", "first_branch_p90_s"):
        assert isinstance(m[name], float) and m[name] >= 0, name
    assert m["engine_host_ms.serve"] > 0 and m["sched_host_ms.serve"] > 0
    # no card: no device interval to lay idle time against, no marks
    for name in ("idle_engine.serve", "idle_sched.serve",
                 "device_ms.attention.serve", "device_ms.head.serve",
                 "device_ms.moe_route.serve"):
        assert m[name] is None, name
    n = prog["notes"]
    assert n["host_window_steps"] > 0 and n["records_dropped"] == 0
    assert 0 <= n["pruned_share"] <= 1 and n["branches_seated"] > 0
    assert 0 < n["pages_used_share"] < 1
    assert n["host_ms_by_span"]["engine.launch"] > 0
    # every counter and stamp feeds a note
    assert n["per_step"]["engine.decode_step.rows"] > 0
    assert n["per_step"]["engine.decode_step.ctx"] > 0
    assert n["per_step"]["sched.prm.branches"] > 0
    assert n["completed_per_answer"] >= 1 and n["finish_p90_s"] > 0
    # the engine's host work, its launches and syncs hold the step
    c = prog["checks"]
    assert c["engine_host_launch_sync_ms"] >= 0.95 * c["step_ms"]


def test_an_untraced_run_leaves_the_tracer_off(monkeypatch, one_thread):
    from repro_torch import spans
    from repro_torch.serving.engine import Engine
    seen = []
    inner = Engine.decode_step

    def step(self):
        seen.append(spans.enabled())
        return inner(self)
    monkeypatch.setattr(Engine, "decode_step", step)
    cell = _tiny_moe(queue_wait_p50_s=1, first_branch_p90_s=1)
    out, run, notes = bench_run.run_cell(cell, SEED, 2.0, True, "cpu",
                                         time.perf_counter(), check=False)
    assert seen and not any(seen)
    assert pt.program(run) is None
    # the scheduler's stamps need no tracer: run.py's traced line has them
    assert set(out["metrics"]) == {"queue_wait_p50_s", "first_branch_p90_s"}
    out, run, notes = bench_run.run_cell(tiny_cell(), SEED, 1.0, False,
                                         "cpu", time.perf_counter(),
                                         check=False)
    assert not any(seen)


class _OldRequest:          # a program whose scheduler stamps no wall time
    pass


@dataclasses.dataclass
class _Rec:
    req: object


@dataclasses.dataclass
class _Run:
    records: list
    window: tuple = (0.0, 10.0)
    host_window: tuple = (0.0, 8.0)


@pytest.mark.parametrize("name", [
    "engine_host_ms.serve", "sched_host_ms.batch", "idle_engine.serve",
    "idle_sched.batch", "device_ms.attention.serve", "device_ms.head.batch",
    "device_ms.moe_route.batch", "queue_wait_p50_s", "first_branch_p90_s"])
def test_readers_read_nothing_from_a_program_without_the_tracer(name):
    assert spec.read_metric(name, _Run([_Rec(_OldRequest())])) is None


def test_stamp_readers_count_a_waiting_request_at_its_age():
    class Req:
        def __init__(self, arrival, admitted):
            self.arrival_s, self.admitted_s = arrival, admitted
            self.first_branch_s = math.nan
    run = _Run([_Rec(Req(-1.0, 0.5)), _Rec(Req(1.0, 1.5)),
                _Rec(Req(2.0, 2.5)), _Rec(Req(4.0, math.nan)),
                _Rec(Req(7.0, 12.0))])
    # in the window: 1.0, 2.0, 4.0 (waiting at the close: 6 s) and 7.0
    # (admitted after the close: 3 s)
    assert pt.stamp_waits(run, "admitted_s") == [0.5, 0.5, 6.0, 3.0]
    assert spec.read_metric("queue_wait_p50_s", run) == pytest.approx(1.75)
    # never seated: 9, 8, 6 and 3 s
    assert spec.read_metric("first_branch_p90_s", run) == pytest.approx(
        8.7)
