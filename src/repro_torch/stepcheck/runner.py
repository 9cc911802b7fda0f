"""Orchestration: build the targets, trace every variant, run every
rule.

Kept apart from the CLI so tests can call ``run_all`` (or its pieces)
and the tracing runs once per target.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import bounds, dispatch_rules, harness, manifest
from .findings import Finding
from .tracing import trace_variant


@dataclasses.dataclass
class RunResult:
    """Everything one stepcheck pass produced."""

    findings: List[Finding]
    per_target: Dict[str, Dict[str, dict]]   # cache-off signature records
    manifest: dict                           # freshly built (not committed)
    targets_analyzed: int
    variants_traced: int


def run_all(committed_manifest: Optional[dict] = None,
            include_cache: bool = True, targets=None) -> RunResult:
    """Full analysis. ``committed_manifest=None`` loads the committed
    file; pass ``{}`` to skip the STEP002 ratchet. ``targets`` defaults
    to ``harness.build_targets``."""
    findings: List[Finding] = []
    if targets is None:
        targets = harness.build_targets(include_cache=include_cache)
    per_target: Dict[str, Dict[str, dict]] = {}
    cache_sigs: Dict[str, Tuple[str, Dict[str, dict]]] = {}
    variants_traced = 0

    for target in targets:
        traced = [trace_variant(target, v) for v in target.variants]
        variants_traced += len(traced)
        sigs = manifest.signatures_for(traced)
        findings.extend(manifest.check_bound(
            target, [v.name for v in target.variants]))
        if target.cache:
            cache_sigs[target.family] = (target.name, sigs)
        else:
            per_target[target.name] = sigs
            # the body rules run on cache-off targets only: the cache-on
            # twin is the same body by construction (its signatures are
            # held equal below)
            findings.extend(dispatch_rules.run_body_rules(target, traced))

    for family, (on_name, on_sigs) in sorted(cache_sigs.items()):
        off_sigs = per_target.get(f"engine[{family}]", {})
        findings.extend(manifest.check_cache_invariance(
            off_sigs, on_sigs, on_name))

    engine_names = [v.name for t in targets if t.name == "engine[dense]"
                    for v in t.variants]
    if engine_names:
        findings.extend(manifest.check_sim_projection(
            engine_names, harness.sim_variant_names()))

    built = manifest.build_manifest(per_target) if per_target else {}
    if committed_manifest is None:
        findings.extend(manifest.check_manifest(
            per_target, manifest.load_manifest()))
    elif committed_manifest:
        findings.extend(manifest.check_manifest(per_target,
                                                committed_manifest))
    # committed_manifest == {} passed explicitly: skip the ratchet

    findings.extend(bounds.run_bounds_lattice())

    findings.sort(key=lambda f: (f.path, f.rule, f.symbol))
    return RunResult(findings=findings, per_target=per_target,
                     manifest=built, targets_analyzed=len(targets),
                     variants_traced=variants_traced)
