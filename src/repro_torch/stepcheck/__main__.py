"""CLI: ``python -m repro_torch.stepcheck [options]``.

Exit code 1 only for findings not covered by the committed baseline
(``baseline.txt`` beside this file); ``--write-baseline`` regenerates it
(re-add the justification comments by hand), ``--write-manifest``
regenerates the graph manifest after an intended shape change.
``--self-test`` seeds one violation of each rule (an extra variant, a
tampered manifest, a ``torch.tensor`` constant, an ``.item()``, a stray
``.float()`` and a dead param in a step body, an unclamped sentinel
chase in a launch's access) and exits 0 only if every one is caught: the
proof that the checker checks.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List

from . import RULES
from .findings import HERE, Baseline, Finding, render_json

BASELINE_PATH = HERE / "baseline.txt"


def _seeded_body_findings() -> List[Finding]:
    """STEP003-006 on the dense target's decode variant, its body wrapped
    to add a ``torch.tensor`` constant, a stray ``.float()`` and (in a
    second trace) an ``.item()``, and its params given a leaf no step
    reads."""
    import torch

    from . import dispatch_rules, harness
    from .tracing import trace_variant

    eng, mode = harness.build_engine("dense")
    target = harness.EngineTarget("engine[seeded]", "dense", False, eng,
                                  eng.step_variants()[:1], mode)
    body = eng._step_body
    with mode:
        eng.params["unused"] = torch.zeros((3,), dtype=torch.bfloat16)

    def constant_and_upcast(dev, lane, lane_buckets=()):
        out = body(dev, lane, lane_buckets)
        tokens = out[0] + torch.tensor(1, dtype=torch.int32)
        return (tokens, out[1].float()) + tuple(out[2:])

    def host_read(dev, lane, lane_buckets=()):
        out = body(dev, lane, lane_buckets)
        out[2].sum().item()
        return out

    traced = []
    for seeded in (constant_and_upcast, host_read):
        eng._step_body = seeded
        traced.append(trace_variant(target, target.variants[0]))
    eng._step_body = body
    return dispatch_rules.run_body_rules(target, traced)


def self_test() -> int:
    """Negative controls: every rule must catch its seeded violation."""
    import torch

    from ..kernels.paged_attention.paged_attention import \
        paged_attention_grid
    from ..serving import StepVariant
    from . import bounds, harness, manifest

    failures = []
    caught: List[Finding] = []

    # STEP001: an extra variant past the bucket x lane-config product
    eng, mode = harness.build_engine("dense")
    target = harness.EngineTarget("engine[seeded]", "dense", False, eng,
                                  eng.step_variants(), mode)
    names = [v.name for v in target.variants] + [
        StepVariant("mixed:b16xl1", (16,)).name]
    caught += manifest.check_bound(target, names)

    # STEP002: a tampered manifest (a changed signature, an off-manifest
    # variant and a stale entry)
    per_target = {"engine[t]": {"decode": {"sig": "aaaa", "out": []},
                                "mixed:b8xl1": {"sig": "bbbb", "out": []}}}
    tampered = {"targets": {"engine[t]": {
        "decode": {"sig": "XXXX", "out": []},
        "mixed:b8xl2": {"sig": "cccc", "out": []}}}}
    caught += manifest.check_manifest(per_target, tampered)

    # STEP003-006 in a step body
    caught += _seeded_body_findings()

    # STEP007: K1's K/V access without the sentinel clamp
    num_pages, page_size, pps = 16, 4, 5
    (lg,) = paged_attention_grid(3, 4, 32, 2, num_pages, page_size, pps,
                                 torch.float32)

    def unclamped(cta, bt, ln):
        b, h, _ = cta
        return [((h, h + 1), (int(bt[b, i]), int(bt[b, i]) + 1),
                 (0, page_size), (0, 32)) for i in range(pps)]
    broken = dataclasses.replace(lg, operands=tuple(
        dataclasses.replace(op, ranges=unclamped)
        if op.name in ("k_pages", "v_pages") else op for op in lg.operands))
    cases = bounds.paged_attention_cases(num_pages, page_size, pps, 3)
    caught += bounds.verify_launch_grid(broken, cases)
    if bounds.verify_launch_grid(lg, cases):
        failures.append("the clamped K1 access was flagged by STEP007")

    found = {f.rule for f in caught}
    for rule in sorted(RULES):
        if rule not in found:
            failures.append(f"seeded {rule} violation NOT caught")
    symbols = {(f.rule, f.symbol) for f in caught}
    for want in [("STEP002", "decode"), ("STEP002", "mixed:b8xl1"),
                 ("STEP002", "mixed:b8xl2"),
                 ("STEP006", "params['unused']")]:
        if want not in symbols:
            failures.append(f"seeded violation NOT caught: {want}")
    if failures:
        for msg in failures:
            print(f"self-test FAILED: {msg}")
        return 1
    print("self-test OK: seeded violations caught "
          + ", ".join(f"{rule} x{sum(f.rule == rule for f in caught)}"
                      for rule in sorted(RULES)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.stepcheck",
        description="verifier of the port's step graphs and CUDA launches")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings (CI artifact)")
    parser.add_argument("--baseline", type=Path, default=BASELINE_PATH,
                        help="baseline file (default: committed)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding as new")
    parser.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from this run")
    parser.add_argument("--manifest", type=Path, default=None,
                        help="manifest file (default: committed)")
    parser.add_argument("--write-manifest", action="store_true",
                        help="regenerate the committed manifest.json")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--self-test", action="store_true",
                        help="seed violations; exit 0 iff all caught")
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, (name, summary) in sorted(RULES.items()):
            print(f"{code}  {name}: {summary}")
        return 0
    if args.self_test:
        return self_test()

    from . import manifest as manifest_mod
    from .runner import run_all

    committed = None
    if args.manifest is not None:
        committed = manifest_mod.load_manifest(args.manifest)
    result = run_all(committed_manifest=committed)

    if args.write_manifest:
        path = args.manifest or manifest_mod.MANIFEST_PATH
        manifest_mod.write_manifest(result.manifest, path)
        print(f"wrote {path}")
        # findings computed against the stale manifest no longer apply
        result.findings = [f for f in result.findings
                           if f.rule != "STEP002"]

    baseline = (Baseline() if args.no_baseline
                else Baseline.load(args.baseline))
    old, new = baseline.partition(result.findings)

    if args.write_baseline:
        args.baseline.write_text(Baseline.render(result.findings),
                                 encoding="utf-8")
        print(f"wrote {args.baseline} ({len(result.findings)} entries)")
        return 0

    if args.json:
        print(render_json(result.findings, new))
    else:
        new_ids = {id(f) for f in new}
        for f in result.findings:
            marker = "" if id(f) in new_ids else " [baselined]"
            print(f.render() + marker)
        print(f"stepcheck: {len(result.findings)} finding(s) "
              f"({len(old)} baselined, {len(new)} new) over "
              f"{result.targets_analyzed} engine target(s), "
              f"{result.variants_traced} traced variant(s)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
