"""The step-graph manifest: STEP001 (the bound) and STEP002 (the ratchet).

Counterpart of ``tools/stepcheck/manifest.py``. ``manifest.json`` (beside
this file) commits, per cache-off engine target, every step variant's
signature: the length of its host array, the shapes and dtypes of its
lane states and static outputs, and their sha256-16 digest — what one
captured CUDA graph takes and gives. The ratchet holds in both
directions: a variant missing from the file (a new graph shape) and an
entry no longer traced (a stale file) are findings. ``--write-manifest``
regenerates it after an intended change; the diff is reviewed like code.

STEP001 is the bound itself, independent of the file:

  * variants per target == 1 + len(buckets) x len(lane_configs), the
    mixed names exactly the bucket x lane-config product;
  * cache-on twins trace to identical signatures (the prefix cache is
    admission plumbing and never adds a graph);
  * the simulator's variants are a subset of the engine's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

from .findings import HERE, Finding
from .tracing import TracedVariant, variant_signature

MANIFEST_PATH = HERE / "manifest.json"


def signatures_for(traced: Sequence[TracedVariant]) -> Dict[str, dict]:
    """variant name -> signature record for one target."""
    out: Dict[str, dict] = {}
    for tv in traced:
        digest, ins, outs = variant_signature(tv)
        out[tv.variant.name] = {
            "sig": digest,
            "lane_buckets": list(tv.variant.lane_buckets),
            "host_len": tv.host_len,
            "in": ins,
            "out": outs,
        }
    return out


def build_manifest(per_target: Dict[str, Dict[str, dict]]) -> dict:
    some = next(iter(per_target.values()))
    return {
        "_doc": ("stepcheck manifest of the port's step graphs: the "
                 "signature of every Engine.step_variants() entry (host "
                 "array length, lane states, static outputs). Regenerate "
                 "with `python -m repro_torch.stepcheck --write-manifest` "
                 "and review the diff; an unreviewed change is exactly "
                 "the silent new graph this file exists to catch."),
        "variants_per_target": len(some),
        "targets": per_target,
    }


def load_manifest(path: Path = MANIFEST_PATH) -> dict:
    if not path.exists():
        return {}
    return json.loads(path.read_text(encoding="utf-8"))


def write_manifest(manifest: dict, path: Path = MANIFEST_PATH) -> None:
    path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n",
                    encoding="utf-8")


def check_bound(target, names: Sequence[str]) -> List[Finding]:
    """STEP001 for one engine target: count and names of its variants."""
    engine = target.engine
    buckets, lanes = engine._buckets, engine._lane_configs
    expected = {"decode"} | {f"mixed:b{b}xl{n}"
                             for b in buckets for n in lanes}
    actual = set(names)
    bound = 1 + len(buckets) * len(lanes)
    if len(names) == bound and actual == expected:
        return []
    missing, extra = sorted(expected - actual), sorted(actual - expected)
    return [Finding(
        path=target.name, line=0, rule="STEP001", symbol="variants",
        message=(f"step_variants() enumerates {len(names)} graphs, bound "
                 f"is {bound} = 1 + {len(buckets)} buckets × {len(lanes)} "
                 "lane-configs"
                 + (f"; missing {missing}" if missing else "")
                 + (f"; extra {extra}" if extra else "")))]


def check_cache_invariance(off_sigs: Dict[str, dict],
                           on_sigs: Dict[str, dict],
                           on_name: str) -> List[Finding]:
    """STEP001: the prefix cache must not change any variant's
    signature."""
    findings: List[Finding] = []
    for name in sorted(set(off_sigs) | set(on_sigs)):
        off = off_sigs.get(name, {}).get("sig")
        on = on_sigs.get(name, {}).get("sig")
        if off != on:
            findings.append(Finding(
                path=on_name, line=0, rule="STEP001", symbol=name,
                message=(f"variant `{name}` signature differs from the "
                         f"cache-off twin ({on} != {off}) — the prefix "
                         "cache is admission plumbing and must not add "
                         "graphs")))
    return findings


def check_sim_projection(engine_names: Sequence[str],
                         sim_names: Sequence[str]) -> List[Finding]:
    """STEP001: SimEngine's variants are a subset of the engine's."""
    extra = sorted(set(sim_names) - set(engine_names))
    if not extra:
        return []
    return [Finding(
        path="simulator", line=0, rule="STEP001", symbol="step_variants",
        message=(f"SimEngine.step_variants() declares graphs the engine "
                 f"does not: {extra} — the simulator drifted from the "
                 "engine"))]


def check_manifest(per_target: Dict[str, Dict[str, dict]],
                   manifest: dict) -> List[Finding]:
    """STEP002: ratchet the traced signatures against the committed
    file."""
    if not manifest:
        return [Finding(
            path="manifest", line=0, rule="STEP002", symbol="<missing>",
            message=("src/repro_torch/stepcheck/manifest.json is missing "
                     "— run `python -m repro_torch.stepcheck "
                     "--write-manifest` and commit it"))]
    findings: List[Finding] = []
    recorded: Dict[str, Dict[str, dict]] = manifest.get("targets", {})
    for tname in sorted(set(per_target) | set(recorded)):
        traced = per_target.get(tname, {})
        known = recorded.get(tname, {})
        for vname in sorted(set(traced) | set(known)):
            have, want = traced.get(vname), known.get(vname)
            if want is None:
                findings.append(Finding(
                    path=tname, line=0, rule="STEP002", symbol=vname,
                    message=(f"variant `{vname}` traced but absent from "
                             "the manifest — a new graph shape; review "
                             "and --write-manifest")))
            elif have is None:
                findings.append(Finding(
                    path=tname, line=0, rule="STEP002", symbol=vname,
                    message=(f"manifest lists `{vname}` but it is no "
                             "longer reachable — stale manifest; "
                             "--write-manifest")))
            elif have["sig"] != want["sig"]:
                findings.append(Finding(
                    path=tname, line=0, rule="STEP002", symbol=vname,
                    message=(f"variant `{vname}` signature changed "
                             f"({want['sig']} -> {have['sig']}) — the "
                             "graph now takes or gives other shapes or "
                             f"dtypes (out: {want.get('out')} -> "
                             f"{have.get('out')}); review and "
                             "--write-manifest")))
    return findings
