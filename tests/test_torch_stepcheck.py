"""The port's stepcheck (``python -m repro_torch.stepcheck``), on the CPU.

Held against the reference's (``tools/stepcheck``,
``tests/test_stepcheck.py``): the same seven rule codes; each harness
target enumerates the same step variants as the reference's
``Engine.step_variants()`` for the same config; the committed
``manifest.json`` lists the reference manifest's targets and variant
names. The repo is clean under the committed manifest and baseline
(exit 0), a tampered manifest fails (exit 1), ``--json`` has the
reference's output shape, and ``--self-test`` catches one seeded
violation of each rule. The CLI runs in-process over one analysis of the
repo (``run_all`` is the expensive part: every variant's body traced on
fake tensors), which the CLI tests reuse.
"""
import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

from repro_torch.stepcheck import RULES, harness, manifest, runner
from repro_torch.stepcheck.__main__ import main
from repro_torch.stepcheck.findings import Baseline

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # tools/ lives at the repo root
    sys.path.insert(0, str(REPO))


def test_rule_catalog_matches_the_reference():
    from tools.stepcheck import RULES as REF
    assert sorted(RULES) == sorted(REF) == [f"STEP00{i}" for i in
                                            range(1, 8)]
    for code, (name, summary) in RULES.items():
        assert name and summary


TARGETS = [("dense", False, False), ("ssm", False, False),
           ("hybrid", False, False), ("dense", True, False),
           ("ssm", True, False), ("hybrid", True, False),
           ("dense", False, True), ("hybrid", False, True)]


@pytest.mark.parametrize("family,cache,tree", TARGETS)
def test_variant_names_match_the_reference(family, cache, tree):
    """Each harness target's ``step_variants()`` names (and lane buckets)
    are the reference engine's for the same config."""
    from tools.stepcheck.harness import build_engine as ref_engine
    ref = [(v.name, tuple(v.lane_buckets)) for v in
           ref_engine(family, cache, tree).step_variants()]
    eng, _ = harness.build_engine(family, cache, tree)
    assert [(v.name, tuple(v.lane_buckets))
            for v in eng.step_variants()] == ref
    assert len(ref) == 1 + 2 * 2


def test_manifest_lists_the_reference_targets_and_variants():
    from tools.stepcheck.manifest import load_manifest as ref_manifest
    ref = ref_manifest()["targets"]
    mine = manifest.load_manifest()["targets"]
    assert sorted(mine) == sorted(ref)
    for target, variants in ref.items():
        assert sorted(mine[target]) == sorted(variants), target


@pytest.fixture(scope="module")
def analysis():
    """One full analysis of the repo, without the ratchet."""
    return runner.run_all(committed_manifest={})


@pytest.fixture
def cli(analysis, monkeypatch):
    """``main(argv)`` in-process, over the module's analysis (the ratchet
    against the manifest the CLI names is applied to it); returns (exit
    code, stdout)."""
    def run_all(committed_manifest=None, **kw):
        m = (manifest.load_manifest() if committed_manifest is None
             else committed_manifest)
        findings = list(analysis.findings)
        if m or committed_manifest is None:
            findings += manifest.check_manifest(analysis.per_target, m)
        findings.sort(key=lambda f: (f.path, f.rule, f.symbol))
        return runner.RunResult(findings, analysis.per_target,
                                analysis.manifest, analysis.targets_analyzed,
                                analysis.variants_traced)
    monkeypatch.setattr(runner, "run_all", run_all)

    def run(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(list(argv))
        return rc, out.getvalue()
    return run


def test_analysis_covers_every_target(analysis):
    assert analysis.targets_analyzed == 8
    assert analysis.variants_traced == 40
    assert sorted(analysis.per_target) == sorted(
        f"engine[{f}]" for f in ("dense", "ssm", "hybrid", "dense+tree",
                                 "hybrid+tree"))
    # the committed manifest is what a run writes now
    assert analysis.manifest["targets"] == \
        manifest.load_manifest()["targets"]


def test_cli_repo_clean_with_committed_manifest_and_baseline(cli):
    rc, out = cli()
    assert rc == 0, out
    assert "0 new" in out


def test_cli_json_output_shape(cli):
    rc, out = cli("--json")
    assert rc == 0
    payload = json.loads(out)
    assert set(payload) == {"findings", "total", "new", "baselined"}
    assert payload["new"] == 0 and payload["total"] == payload["baselined"]
    for f in payload["findings"]:
        assert set(f) == {"path", "line", "rule", "symbol", "message",
                          "new"}
        assert f["rule"] in RULES and f["line"] == 0


def test_cli_tampered_manifest_fails_the_build(cli, tmp_path):
    m = manifest.load_manifest()
    target = m["targets"]["engine[dense]"]
    target["decode"]["sig"] = "0" * 16
    target["mixed:b16xl1"] = dict(target["mixed:b8xl1"])
    path = tmp_path / "manifest.json"
    manifest.write_manifest(m, path)
    rc, out = cli("--manifest", str(path))
    assert rc == 1
    assert "STEP002 · variant `decode` signature changed" in out
    assert "manifest lists `mixed:b16xl1`" in out


def test_baseline_entries_are_justified_and_used(analysis):
    """Every baseline line carries a justification, and each one matches
    a finding of the run (no stale grandfathering)."""
    path = Path(runner.__file__).with_name("baseline.txt")
    lines = [l for l in path.read_text().splitlines()
             if l.strip() and not l.startswith("#")]
    assert lines and all("  # " in l and "TODO" not in l for l in lines)
    old, new = Baseline.load(path).partition(analysis.findings)
    assert new == [] and len(old) == len(lines)


def test_cli_list_rules(cli):
    rc, out = cli("--list-rules")
    assert rc == 0 and all(code in out for code in RULES)


def test_cli_self_test_catches_each_rule(cli):
    rc, out = cli("--self-test")
    assert rc == 0, out
    assert "self-test OK" in out
    for code in RULES:
        assert f"{code} x" in out and f"{code} x0" not in out
