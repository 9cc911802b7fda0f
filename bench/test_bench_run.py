"""The harness end to end on the CPU, past its look for a card: a sound run
is correct, the float8 control is not, and each fault a serving cell can
have, planted under the timed path, makes ``correct`` false."""
from __future__ import annotations

import time

import pytest
import torch

from bench import run
from bench.conftest import TINY_MOE, TINY_WORKLOAD, tiny_cell
from bench.lib import spec

SEED = 2**31 + 77

# the shared-prefix cell's path: one header leads every prompt, served
# through the prefix cache and decoded by the tree kernel
TREE_PREFIX = dict(
    prompts=dict(TINY_WORKLOAD["prompts"], shared_header=16),
    engine=dict(TINY_WORKLOAD["engine"], max_pages_per_branch=24,
                decode_kernel="tree", prefix_cache=True))


def _serve(cell, seconds=2.0, control=False):
    return run.run_cell(cell, SEED, seconds, False, "cpu",
                        time.perf_counter(), control=control)


@pytest.mark.parametrize("config,workload", [
    (None, {}), (TINY_MOE, {}), (None, TREE_PREFIX)],
    ids=["dense", "moe", "tree-prefix"])
def test_sound_run_is_correct_and_the_control_is_not(config, workload,
                                                    one_thread):
    cell = tiny_cell(config, **workload)
    limit = cell.workload["check"]["limits"]["logit_gap_max"]
    out, rec, notes = _serve(cell)
    assert out["correct"], notes
    assert out["attempted"] > 0 and out["failed"] == 0
    assert notes["positions"] >= 20 and notes["program_agree"] == 1.0
    assert set(out["metrics"]) == {"answer_p90_s", "ttft_p90_s",
                                   "itl_p95_ms", "tokens_per_s", "setup_s"}
    hit = spec.read_metric("prefix_hit_rate", rec)
    if cell.workload["engine"]["prefix_cache"]:
        assert 0 < hit <= 1
    else:
        assert hit is None
    # K3's and K1's device time come from a trace, and there is none
    assert spec.read_metric("k3_roofline.serve", rec) is None
    assert list(out)[-1] == "check"
    assert out["check"]["logit_gap_max"] == {
        "value": notes["program_gap_max"], "limit": limit}
    # the control run: the float8 reference's tokens go through the same
    # comparison in the program's place, and fail it
    out, rec, notes = _serve(cell, control=True)
    assert not out["correct"], notes
    assert out["check"]["logit_gap_max"] == {
        "value": notes["control_fp8_gap_max"], "limit": limit}
    assert notes["control_fp8_gap_max"] > limit >= notes["program_gap_max"]


def _kv_unchanged(monkeypatch):
    """A step that returns its state unchanged: the K/V pools as they
    were before the step."""
    from repro_torch.serving.engine import Engine
    inner = Engine.decode_step

    def step(self):
        keep = {k: v.clone() for k, v in self.state.items()}
        out = inner(self)
        for k, v in keep.items():
            self.state[k].copy_(v)
        return out
    monkeypatch.setattr(Engine, "decode_step", step)


def _outputs(monkeypatch, edit):
    from repro_torch.serving.step_graph import StepGraph
    inner = StepGraph.run

    def run_(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        edit(out)
        return out
    monkeypatch.setattr(StepGraph, "run", run_)


def _half_batch(monkeypatch):
    """Half of the decode rows left out: each odd slot's outputs are the
    even slot's before it."""
    def edit(out):
        n = out[1].shape[0] // 2 * 2
        for t in (out[0], out[2]):
            t[1:n:2] = t[0:n:2]
    _outputs(monkeypatch, edit)


def _token_altered(monkeypatch):
    """The greedy token altered where the step produces it: each row's
    best and worst logits trade places."""
    def edit(out):
        lg = out[2]
        hi, lo = lg.argmax(-1, keepdim=True), lg.argmin(-1, keepdim=True)
        a, b = lg.gather(-1, hi), lg.gather(-1, lo)
        lg.scatter_(-1, hi, b)
        lg.scatter_(-1, lo, a)
        out[0].copy_(lg.argmax(-1).to(out[0].dtype))
    _outputs(monkeypatch, edit)


FAULTS = (_kv_unchanged, _half_batch, _token_altered)


@pytest.mark.parametrize("fault,workload", [
    pytest.param(f, w, id=f.__name__ + tag)
    for tag, w in (("", {}), ("-tree-prefix", TREE_PREFIX)) for f in FAULTS])
def test_each_fault_makes_the_run_incorrect(monkeypatch, fault, workload,
                                            one_thread):
    fault(monkeypatch)
    cell = tiny_cell(**workload)
    out, rec, notes = _serve(cell)
    assert not out["correct"], notes
    assert out["check"]["logit_gap_max"]["value"] > \
        cell.workload["check"]["limits"]["logit_gap_max"]


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "reprox", "jax_utils", "torch"]) == []
    assert run.forbidden_modules(["repro.models.moe", "jax", "jaxlib.xla",
                                  "flax.linen"]) == ["flax", "jax",
                                                     "jaxlib", "repro"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "r1-distill-14b.sart-steady", "--seed",
                     "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""
