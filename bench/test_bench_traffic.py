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


@pytest.mark.parametrize("cell", ["r1-distill-14b.sart-steady",
                                  "qwen3-moe-235b-a22b.sart-batch",
                                  "r1-distill-14b.sart-batch"])
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


def test_shared_header_leads_every_prompt():
    wl = {"arrivals": {"kind": "open_poisson", "rate_per_s": 1.2},
          "prompts": {"median": 128, "sigma": 0.5, "min": 32, "max": 512,
                      "shared_header": 2048}}
    t = spec.traffic_module(spec.load_cell("r1-distill-14b.sart-steady")
                            ).make(wl, 152064, 9, 60.0)
    heads = {tuple(t.requests.get(i)[0][:2048]) for i in range(20)}
    assert len(heads) == 1
    assert all(32 <= len(t.requests.get(i)[0]) - 2048 <= 512
               for i in range(20))


def test_closed_loop_sends_on_answer():
    t = _make("qwen3-moe-235b-a22b.sart-batch", 3)
    first = t.first()
    assert len(first) == 64 and first[0][0] == 0.0
    assert t.answered(5, 12.5) == [(12.5, 5 + 64)]
