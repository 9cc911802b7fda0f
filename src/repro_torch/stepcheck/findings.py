"""Findings, the committed baseline and the JSON report.

The port's own copy of what ``tools/reprolint/framework.py`` gives the
reference's stepcheck (``Finding``, ``Baseline``, ``render_json``), so
that the port imports nothing outside its package. A trace finding's
``path`` is an analysis target (``engine[dense]``) or a kernel name, its
``line`` 0, and it renders as ``target · STEP0xx · message``; the
baseline key ``path::RULE::symbol`` survives unrelated edits.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: the directory of this package: baseline.txt and manifest.json
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Finding:
    """One rule violation: ``path`` (target or kernel), ``line`` (0 for
    trace findings), the rule code, the message and the ``symbol`` that,
    with path and rule, forms the baseline key."""

    path: str
    line: int
    rule: str
    message: str
    symbol: str = "<module>"

    @property
    def baseline_key(self) -> str:
        return f"{self.path}::{self.rule}::{self.symbol}"

    def render(self) -> str:
        loc = self.path if self.line == 0 else f"{self.path}:{self.line}"
        return f"{loc} · {self.rule} · {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "symbol": self.symbol, "message": self.message}


class Baseline:
    """Grandfathered findings: ``path::RULE::symbol  # justification``
    lines, matched as a multiset (a second finding of the same key is
    new)."""

    def __init__(self, counts: Optional[Counter] = None):
        self.counts: Counter = counts or Counter()

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        counts: Counter = Counter()
        if path.exists():
            for raw in path.read_text(encoding="utf-8").splitlines():
                entry = raw.split("#", 1)[0].strip()
                if entry:
                    counts[entry] += 1
        return cls(counts)

    def partition(self, findings: Sequence[Finding]
                  ) -> Tuple[List[Finding], List[Finding]]:
        """Split findings into (grandfathered, new)."""
        remaining = Counter(self.counts)
        old: List[Finding] = []
        new: List[Finding] = []
        for f in findings:
            if remaining[f.baseline_key] > 0:
                remaining[f.baseline_key] -= 1
                old.append(f)
            else:
                new.append(f)
        return old, new

    @staticmethod
    def render(findings: Sequence[Finding]) -> str:
        lines = ["# stepcheck baseline — grandfathered findings.",
                 "# Format: path::RULE::symbol  # one-line justification",
                 "# New findings (not listed here) fail the build.", ""]
        for f in sorted(findings, key=lambda f: f.baseline_key):
            lines.append(f"{f.baseline_key}  # TODO justify")
        return "\n".join(lines) + "\n"


def render_json(findings: Sequence[Finding], new: Sequence[Finding]) -> str:
    """The CI artifact: every finding with ``new`` set, and the counts."""
    new_ids = {id(f) for f in new}
    return json.dumps({
        "findings": [dict(f.to_json(), new=(id(f) in new_ids))
                     for f in findings],
        "total": len(findings),
        "new": len(new),
        "baselined": len(findings) - len(new),
    }, indent=2)
