"""Discovery by name: every cell of BENCHMARK.json resolves; an unknown
cell, traffic kind, reference family or metric is refused; and a new
cell, configuration, traffic kind and metric are added by new files and
entries alone, no file that is there edited."""
from __future__ import annotations

import json
import shutil

import pytest

from bench.lib import spec


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


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(spec.SpecError, match="unknown workload"):
        spec.load_cell("no-such.cell")
    root = _copy(tmp_path)
    name = "r1-distill-14b.sart-steady"
    wl_path = root / "bench" / "workloads" / f"{name}.json"
    wl = json.loads(wl_path.read_text())
    wl["arrivals"]["kind"] = "no_such_kind"
    wl_path.write_text(json.dumps(wl))
    with pytest.raises(spec.SpecError, match="unknown traffic kind"):
        spec.load_cell(name, root)
    root = _copy(tmp_path / "b")
    _edit(root, lambda bm: bm["per_layer"].append(
        {"name": "no_such_metric", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "setup_s"}))
    with pytest.raises(spec.SpecError, match="unknown metric"):
        spec.load_cell(name, root)


def test_a_cell_config_kind_and_metric_come_as_new_files(tmp_path):
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
    _edit(root, add)
    cell = spec.load_cell("r1-distill-14b-short.bursty", root)
    assert spec.traffic_module(cell).make({}, 1, 1, 1.0) is None
    assert "pages_in_use" in {m["name"] for m in cell.per_layer}
    assert spec.read_metric("pages_in_use", None, root) == 1.0
    # the old cells still resolve, and no file that was there changed
    spec.load_cell("r1-distill-14b.sart-steady", root)
    assert all(p.read_bytes() == data for p, data in before.items())


def test_dotted_metrics_share_their_reader():
    assert spec.metric_module("step_ms.serve") is \
        spec.metric_module("step_ms.batch")
