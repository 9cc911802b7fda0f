"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is the file ``bench/workloads/<cell>.json``;
its configuration is the ``file`` that ``BENCHMARK.json`` names for it;
its arrivals come from ``bench/traffic/<kind>.py``; its model, weights
and work counts from ``bench/families/<family>.py``, its reference from
``bench/reference/<family>.py``; each metric from
``bench/metrics/<metric>.py``, or from the file of the metric's name up
to its first dot (``step_ms.py`` reads ``step_ms.serve`` and
``step_ms.batch``). Adding a cell, a configuration, an architecture, a
traffic kind or a metric is adding files and an entry: nothing here
names one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


class SpecError(ValueError):
    """A name in ``BENCHMARK.json`` or a cell's files that the harness
    cannot resolve."""


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the cell's entry of ``workloads``
    config: dict                # the configuration file
    workload: dict              # ``bench/workloads/<cell>.json``
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: every cell without
    a ``workloads`` key, else the cells it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files read; raises ``SpecError`` for a
    name that ``BENCHMARK.json`` does not hold or files that disagree
    with it."""
    bm = load_benchmark(root)
    entries = {w["name"]: w for w in bm["workloads"]}
    if name not in entries:
        raise SpecError(f"unknown workload {name!r}; known: "
                        f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bm["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"workload {name!r} names unknown config "
                        f"{entry['config']!r}")
    config = _read_json(root / configs[entry["config"]]["file"],
                        f"config {entry['config']!r}")
    workload = _read_json(root / "bench" / "workloads" / f"{name}.json",
                          f"workload {name!r}")
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise SpecError(f"workload {name!r}: its file says {key} "
                            f"{workload.get(key)!r}, BENCHMARK.json "
                            f"{entry[key]!r}")
    cell = Cell(name, entry, config, workload,
                [m for m in bm["end_to_end"] if reports(m, name)],
                [m for m in bm["per_layer"] if reports(m, name)], root)
    # every piece the cell will need is found now, before any work
    traffic_module(cell)
    family_module(cell)
    reference_module(cell)
    for m in cell.end_to_end + cell.per_layer:
        metric_module(m["name"], root)
    return cell


_loaded: Dict[str, ModuleType] = {}


def _load(path: Path) -> ModuleType:
    """A module from a file, under a name made from its path (two
    checkouts' files never share a module)."""
    key = str(path.resolve())
    if key not in _loaded:
        tag = hashlib.sha1(key.encode()).hexdigest()[:10]
        mod_name = f"bench_file_{path.stem.replace('.', '_')}_{tag}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def _find(folder: Path, name: str, what: str) -> Path:
    for stem in (name, name.split(".", 1)[0]):
        path = folder / f"{stem}.py"
        if path.is_file():
            return path
    raise SpecError(f"unknown {what} {name!r}: no {folder}/{name}.py")


def traffic_module(cell: Cell) -> ModuleType:
    kind = cell.workload["arrivals"]["kind"]
    return _load(_find(cell.root / "bench" / "traffic", kind,
                       "traffic kind"))


# what a family file exports (bench/families/__init__.py)
FAMILY_EXPORTS = ("model_config", "make_params", "matmul_params",
                  "context_flops", "attention_layers", "state_bytes",
                  "DEVICE_MARKS")


def family_module(cell: Cell) -> ModuleType:
    mod = _load(_find(cell.root / "bench" / "families",
                      cell.config["family"], "model family"))
    missing = [n for n in FAMILY_EXPORTS if not hasattr(mod, n)]
    if missing:
        raise SpecError(f"model family {cell.config['family']!r} lacks "
                        f"{missing}")
    return mod


def reference_module(cell: Cell) -> ModuleType:
    return _load(_find(cell.root / "bench" / "reference",
                       cell.config["family"], "reference family"))


def metric_module(name: str, root: Path = ROOT) -> ModuleType:
    return _load(_find(root / "bench" / "metrics", name, "metric"))


def read_metric(name: str, run, root: Path = ROOT) -> Optional[float]:
    """The metric's reader over a finished run: a number, or None where
    the run holds nothing for it to read."""
    return metric_module(name, root).read(run, name)
