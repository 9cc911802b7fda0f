"""The STEP rule registry: codes, names, one-line summaries.

The reference's seven codes (``tools/stepcheck/rules.py``), each read for
the port's step: one CUDA graph per ``Engine.step_variants()`` entry,
captured from ``Engine._step_body`` and replayed every step
(``serving/step_graph.py``), and hand-written CUDA launches whose grids
are data (``kernels/introspect.py``). STEP003 has no counterpart of the
reference's whitelist of jax-internal sub-jits
(``tools/stepcheck/jaxpr_rules.py``): a captured graph is one replay
whatever the body calls, so what can break it is what capture bakes in
or cannot record.
"""
from __future__ import annotations

from typing import Dict, Tuple

#: code -> (name, summary)
RULES: Dict[str, Tuple[str, str]] = {
    "STEP001": (
        "graph-count-bound",
        "step_variants() must enumerate exactly 1 + buckets × "
        "lane-configs step graphs per engine target, invariant under the "
        "prefix cache, with the simulator's variants a subset of it"),
    "STEP002": (
        "manifest-ratchet",
        "every variant's signature (host array length, lane states' and "
        "static outputs' shapes and dtypes) must match "
        "src/repro_torch/stepcheck/manifest.json — a new or changed "
        "graph shape is a loud diff, not a silent recapture"),
    "STEP003": (
        "capture-safety",
        "the graph-captured step body makes no tensor from host data (a "
        "capture would bake it in), copies nothing across devices, and "
        "draws random numbers from the engine's generator only (the one "
        "registered with the graph)"),
    "STEP004": (
        "host-read",
        "no op in the step body reads a value on the host or sizes an "
        "output by data (_local_scalar_dense, item, nonzero, "
        "masked_select, unique, _assert_async): capture forbids the sync "
        "and a replay would reuse a stale value"),
    "STEP005": (
        "dtype-promotion",
        "no unaudited op whose floating inputs are all 16-bit and whose "
        "output is fp32 in the step body, by source site (kernel "
        "operands, KV-page writes, hidden-state plumbing)"),
    "STEP006": (
        "dead-surface",
        "no params leaf and no field of the variant's host array that the "
        "body never reads, and no static output that is an input alias "
        "or a constant"),
    "STEP007": (
        "launch-bounds",
        "every CUDA launcher's grid (introspect.LaunchGrid, checked by "
        "the launcher at each launch) keeps every CTA's operand access "
        "in bounds over a lattice of sentinel-laden shapes"),
}
