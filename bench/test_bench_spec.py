"""Discovery by name: every cell of BENCHMARK.json resolves; an unknown
cell, traffic kind, model family or metric is refused; and a new cell,
configuration, architecture, traffic kind and metric are added by new
files and entries alone, no file that is there edited."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench.conftest import TINY
from bench.lib import spec
from bench.work import model_flops, step_bytes


def test_every_cell_resolves():
    bm = spec.load_benchmark()
    for w in bm["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        # each per-layer metric's end-to-end metric is reported there too
        e2e = {m["name"] for m in cell.end_to_end}
        assert {m["moves"] for m in cell.per_layer} <= e2e


def _copy(tmp_path):
    tmp_path.mkdir(parents=True, exist_ok=True)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _edit(root, fn):
    path = root / "BENCHMARK.json"
    bm = json.loads(path.read_text())
    fn(bm)
    path.write_text(json.dumps(bm))


STEADY = "r1-distill-14b.sart-steady"


def _edit_json(path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def _no_kind(root):
    _edit_json(root / "bench" / "workloads" / f"{STEADY}.json",
               lambda wl: wl["arrivals"].update(kind="no_such_kind"))


def _no_metric(root):
    _edit(root, lambda bm: bm["per_layer"].append(
        {"name": "no_such_metric", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "setup_s"}))


def _no_family(root):
    _edit_json(root / "bench" / "configs" / "r1-distill-14b.json",
               lambda c: c.update(family="no_such_family"))


def _half_family(root):
    # a family file without its work counts
    (root / "bench" / "families" / "half.py").write_text(
        "def model_config(config):\n    return None\n")
    _edit_json(root / "bench" / "configs" / "r1-distill-14b.json",
               lambda c: c.update(family="half"))


@pytest.mark.parametrize("break_,cell,match", [
    (None, "no-such.cell", "unknown workload"),
    (_no_kind, STEADY, "unknown traffic kind"),
    (_no_metric, STEADY, "unknown metric"),
    (_no_family, STEADY, "unknown model family"),
    (_half_family, STEADY, "model family 'half' lacks")],
    ids=["workload", "traffic-kind", "metric", "family", "family-exports"])
def test_unknown_names_are_refused(tmp_path, break_, cell, match):
    root = _copy(tmp_path)
    if break_ is not None:
        break_(root)
    with pytest.raises(spec.SpecError, match=match):
        spec.load_cell(cell, root)


# a family of its own: the decoder with an ungated squared-ReLU MLP
# (nemotron-4's), which neither ``dense`` nor ``moe`` builds
TOY_FAMILY = """
from bench.lib import model

DEVICE_MARKS = ("attention", "head")


def model_config(config):
    return model.decoder_config(config, arch_type="dense", mlp_gated=False,
                                d_ff=config["intermediate_size"])


def _mlp(cfg, draw):
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    return "mlp", {"w_up": draw((L, D, F), D ** -0.5),
                   "w_down": draw((L, F, D), F ** -0.5)}


def make_params(cfg, seed, device, dtype):
    return model.decoder_params(cfg, seed, device, dtype, _mlp)


def matmul_params(config):
    return model.decoder_matmul_params(
        config, 2 * config["hidden_size"] * config["intermediate_size"])


def context_flops(config):
    return model.decoder_context_flops(config)


def attention_layers(config):
    return config["num_hidden_layers"]


def state_bytes(config):
    return 0
"""

TOY_REFERENCE = """
def logits(config, params, seqs, last, precision="fp32"):
    raise NotImplementedError("the toy family's reference")
"""


def test_a_cell_config_kind_and_metric_come_as_new_files(tmp_path):
    from repro_torch.models import Model
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    b = root / "bench"
    cfg = json.loads((b / "configs" / "r1-distill-14b.json").read_text())
    cfg["name"] = "r1-distill-14b-short"
    (b / "configs" / "r1-distill-14b-short.json").write_text(json.dumps(cfg))
    (b / "traffic" / "bursty.py").write_text(
        "def make(workload, vocab, seed, horizon_s):\n    return None\n")
    (b / "metrics" / "pages_in_use.py").write_text(
        "def read(run, name):\n    return 1.0\n")
    wl = json.loads((b / "workloads" / "r1-distill-14b.sart-steady.json")
                    .read_text())
    wl.update(config="r1-distill-14b-short", traffic="bursty")
    wl["arrivals"] = {"kind": "bursty"}
    (b / "workloads" / "r1-distill-14b-short.bursty.json").write_text(
        json.dumps(wl))
    # an architecture: its family, its reference and a configuration
    (b / "families" / "toy.py").write_text(TOY_FAMILY)
    (b / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (b / "configs" / "toy.json").write_text(json.dumps(
        dict(TINY, name="toy", family="toy", hidden_act="relu2")))
    (b / "workloads" / "toy.bursty.json").write_text(
        json.dumps(dict(wl, config="toy")))

    def add(bm):
        bm["configs"].append({"name": "r1-distill-14b-short",
                              "source": "https://example.org",
                              "file": "bench/configs/r1-distill-14b-short"
                                      ".json", "reduced": [], "why": "x"})
        bm["workloads"].append({"name": "r1-distill-14b-short.bursty",
                                "config": "r1-distill-14b-short",
                                "traffic": "bursty", "chips": 1,
                                "why": "x"})
        bm["per_layer"].append({"name": "pages_in_use", "unit": "%",
                                "better": "lower", "source":
                                "program_counter", "layer": "KV pool",
                                "moves": "setup_s",
                                "workloads": ["r1-distill-14b-short.bursty"]})
        bm["configs"].append({"name": "toy", "source": "test",
                              "file": "bench/configs/toy.json",
                              "reduced": [], "why": "x"})
        bm["workloads"].append({"name": "toy.bursty", "config": "toy",
                                "traffic": "bursty", "chips": 1, "why": "x"})
    _edit(root, add)
    cell = spec.load_cell("r1-distill-14b-short.bursty", root)
    assert spec.traffic_module(cell).make({}, 1, 1, 1.0) is None
    assert "pages_in_use" in {m["name"] for m in cell.per_layer}
    assert spec.read_metric("pages_in_use", None, root) == 1.0
    # the toy resolves, builds its model and weights, and its family
    # counts its work: TINY's 4/2 heads of 16, D 64, F 96, 2 layers, V 97
    toy = spec.load_cell("toy.bursty", root)
    fam = spec.family_module(toy)
    mc = fam.model_config(toy.config)
    params = fam.make_params(mc, 3, "cpu", torch.float32)
    assert set(params["layers"]["mlp"]) == {"w_up", "w_down"}
    model = Model(mc, dtype=torch.float32, device="cpu")
    model.load_params(params)
    out = model.forward(params, torch.tensor([[1, 2, 3]]))
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == (1, 3, 97)
    # q and o 64 * 64 each, k and v 64 * 32 each: 12,288 a layer; the MLP
    # 2 * 64 * 96 = 12,288 (a gated one's would be 18,432); the LM head
    # 64 * 97 = 6,208; 2 FLOP * 3 tokens * 55,360 parameters, plus 4 * 4
    # heads * 16 * 2 layers = 512 FLOP for each of 10 keys
    assert fam.matmul_params(toy.config) == 2 * (12_288 + 12_288) + 6_208
    assert model_flops.step_flops(fam, toy.config, 3, 10) == \
        2 * 55_360 * 3 + 512 * 10
    # fp32 weights: a layer's 24,576 matrix and 128 bias parameters and
    # its two norm scales of 64; the final norm; the LM head; plus 10
    # keys' K and V (2 * 2 heads * 16 * 2 bytes) in both layers
    weights = 2 * (24_576 + 128 + 128) * 4 + 64 * 4 + 6_208 * 4
    assert step_bytes.weight_bytes(params) == weights
    assert step_bytes.step_bytes(fam, toy.config, params, 10, 3) == \
        weights + 10 * 128 * 2
    # the old cells still resolve, and no file that was there changed
    spec.load_cell("r1-distill-14b.sart-steady", root)
    assert all(p.read_bytes() == data for p, data in before.items())


def test_dotted_metrics_share_their_reader():
    assert spec.metric_module("step_ms.serve") is \
        spec.metric_module("step_ms.batch")
