"""Each arrival generator repeats exactly per seed, and every seed gets the
same amount of work in its own order."""
from __future__ import annotations

import json

import pytest

from bench.lib import spec


def _make(cell_name, seed, horizon=60.0):
    cell = spec.load_cell(cell_name)
    mod = spec.traffic_module(cell)
    return mod.make(cell.workload, cell.config["vocab_size"], seed, horizon)


def _sig(t, n=40):
    first = t.first()
    reqs = [t.requests.get(i) for _, i in first[:n]]
    return (json.dumps(first[:n]), [p for p, _ in reqs],
            [prob for _, prob in reqs])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_generators_repeat_per_seed(cell):
    big = 2**31 + 1234567
    assert _sig(_make(cell, big)) == _sig(_make(cell, big))
    a, b = _make(cell, big), _make(cell, big + 1)
    assert _sig(a) != _sig(b)
    # the same work for every seed: lengths (and gaps) as multisets
    assert sorted(a.requests.lengths) == sorted(b.requests.lengths)
    if hasattr(a, "due"):
        assert sorted(x - y for x, y in zip(a.due, [0] + a.due[:-1])) == \
            pytest.approx(sorted(x - y for x, y in
                                 zip(b.due, [0] + b.due[:-1])))


def test_open_loop_rate_and_prompt_shape():
    t = _make("r1-distill-14b.sart-steady", 5, horizon=100.0)
    due = [d for d, _ in t.first()]
    rate = spec.load_cell("r1-distill-14b.sart-steady").workload[
        "arrivals"]["rate_per_s"]
    assert len(due) / due[-1] == pytest.approx(rate, rel=1e-9)
    lengths = t.requests.lengths
    assert len(lengths) == len(due)
    assert min(lengths) == 64 and max(lengths) == 1024
    assert 230 <= sorted(lengths)[len(lengths) // 2] <= 280
    # the exponential's shape, not a smoothed one: a tenth of the gaps
    # under 0.105 / rate, a tenth over 2.3 / rate, and somewhere five
    # arrivals within one mean gap
    gaps = sorted(b - a for a, b in zip([0.0] + due, due))
    n = len(gaps)
    assert gaps[n // 10 - 1] < 0.106 / rate < gaps[n // 10 + 1]
    assert gaps[-n // 10 - 1] < 2.31 / rate < gaps[-n // 10 + 1]
    assert any(due[i + 4] - due[i] < 1.0 / rate
               for i in range(len(due) - 4))


def test_open_loop_blocks_hold_the_rate_on_every_seed():
    name = "r1-distill-14b.sart-shared-prefix"
    cell = spec.load_cell(name)
    arrivals = cell.workload["arrivals"]
    k, rate = arrivals["block"], arrivals["rate_per_s"]
    for seed in (2**31 + 11, 12):
        due = _make(name, seed, horizon=100.0).due
        assert len(due) % k == 0
        # every block of k arrivals spans k / rate seconds exactly
        ends = [0.0] + due[k - 1::k]
        assert [b - a for a, b in zip(ends, ends[1:])] == \
            pytest.approx([k / rate] * (len(due) // k), rel=1e-9)
    # the whole schedule as one block is the default, bit for bit
    mod = spec.traffic_module(cell)
    wl = dict(cell.workload, arrivals={"kind": "open_poisson",
                                       "rate_per_s": rate})
    whole = mod.make(wl, 97, 5, 100.0)
    n = len(whole.due)
    wl["arrivals"] = dict(wl["arrivals"], block=n)
    assert mod.make(wl, 97, 5, 100.0).due == whole.due


def test_shared_header_leads_every_prompt():
    name = "r1-distill-14b.sart-shared-prefix"
    p = spec.load_cell(name).workload["prompts"]
    assert (p["shared_header"], p["median"], p["min"], p["max"]) == \
        (2048, 128, 32, 512)
    t = _make(name, 9)
    n = len(t.requests)
    heads = {tuple(t.requests.get(i)[0][:2048]) for i in range(n)}
    assert len(heads) == 1
    questions = sorted(len(t.requests.get(i)[0]) - 2048 for i in range(n))
    assert 32 <= questions[0] and questions[-1] <= 512
    assert 118 <= questions[n // 2] <= 138
    # another seed draws another header
    assert _make(name, 10).requests.get(0)[0][:2048] != list(heads.pop())


def test_closed_loop_sends_on_answer():
    t = _make("qwen3-moe-235b-a22b.sart-batch", 3)
    first = t.first()
    assert len(first) == 64 and first[0][0] == 0.0
    assert t.answered(5, 12.5) == [(12.5, 5 + 64)]
