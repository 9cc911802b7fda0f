"""Every kernel wrapper's launch counter, by kernel name: what the serve
and train step graphs read around an eager step or a capture (a wrapper
counts a launch when it runs, so under capture it counts what the graph
records)."""
from __future__ import annotations

from typing import Dict

from .adamw import adamw
from .flash_prefill import flash_prefill, flash_prefill_bwd, paged_prefill
from .paged_attention import paged_attention, tree_decode
from .sampling import sample_top_p
from .ssd_scan import ssd_scan, ssd_scan_bwd


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name."""
    return {"paged_decode": paged_attention.launches,
            "paged_prefill": paged_prefill.launches,
            "paged_tree_shared": tree_decode.shared_launches,
            "paged_tree_branch": tree_decode.branch_launches,
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_bwd": ssd_scan_bwd.launches,
            "flash_prefill": flash_prefill.launches,
            "flash_prefill_bwd": flash_prefill_bwd.launches,
            "adamw": adamw.launches,
            "sample_top_p": sample_top_p.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved since ``before`` (a ``launch_counts()``),
    by how much."""
    return {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}
