"""The body rules over a target's traced variants: STEP003-STEP006.

Counterpart of ``tools/stepcheck/jaxpr_rules.py``. Each check takes one
engine target and its ``TracedVariant``s and yields ``Finding``s with
``path`` = the target name and ``line`` = 0; a site found in several
variants is one finding (the baseline key ``target::STEPxxx::site`` must
not churn when a bucket is added).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

import torch

from .findings import Finding
from .tracing import (TracedVariant, elements, is_host_read, param_leaves,
                      reads, same_generator, storage)

#: ops that make a tensor from host data: a capture bakes the value in
_HOST_DATA = ("lift_fresh", "lift_fresh_copy")
_FLOAT16 = (torch.bfloat16, torch.float16)


def _variants(names: Set[str]) -> str:
    return ", ".join(sorted(names))


def check_capture_safety(target, traced: List[TracedVariant]
                         ) -> Iterator[Finding]:
    """STEP003: nothing in the body that a captured graph cannot replay
    as it was captured — a tensor made from host data (``torch.tensor``
    of Python values: the graph would replay the captured value), a copy
    across devices (a host transfer inside the graph), or a random draw
    from any generator but the engine's (the one ``StepGraph`` registers
    with the graph, so that each replay draws fresh numbers)."""
    seen: Dict[Tuple[str, str], Set[str]] = {}
    engine_gen = target.engine._gen
    for tv in traced:
        for rec in tv.ops:
            base = rec.op.split(".")[1]
            what = None
            if base in _HOST_DATA:
                what = "host-data"
            elif base in ("_to_copy", "copy_", "_copy_from") and rec.inputs:
                devices = {t.device for t in rec.inputs + rec.outputs}
                if "device" in rec.kwargs and rec.kwargs["device"] is not None:
                    devices.add(torch.device(rec.kwargs["device"]))
                if len(devices) > 1:
                    what = "cross-device"
            elif rec.is_random and not same_generator(rec.generator,
                                                      engine_gen):
                what = "foreign-rng"
            if what:
                seen.setdefault((what, f"{rec.op}@{rec.site}"), set()).add(
                    tv.variant.name)
    messages = {
        "host-data": "makes a tensor from host data inside the captured "
                     "body — the graph would replay the captured value",
        "cross-device": "copies across devices inside the captured body",
        "foreign-rng": "draws from a generator that is not the engine's "
                       "— it is not registered with the step graph"}
    for (what, site), variants in sorted(seen.items()):
        yield Finding(
            path=target.name, line=0, rule="STEP003", symbol=site,
            message=(f"`{site}` {messages[what]} (variants: "
                     f"{_variants(variants)})"))


def check_host_reads(target, traced: List[TracedVariant]
                     ) -> Iterator[Finding]:
    """STEP004: no op that reads a value on the host or sizes an output
    by data; capture forbids the sync, and a replay would reuse the
    captured value. The trace of a variant stops at the first one."""
    seen: Dict[str, Set[str]] = {}
    for tv in traced:
        for rec in tv.ops:
            if is_host_read(rec.op):
                seen.setdefault(f"{rec.op}@{rec.site}", set()).add(
                    tv.variant.name)
    for site, variants in sorted(seen.items()):
        yield Finding(
            path=target.name, line=0, rule="STEP004", symbol=site,
            message=(f"host read `{site}` in the step body (variants: "
                     f"{_variants(variants)}) — a sync on every step, "
                     "and a captured graph would replay a stale value"))


def check_dtype_promotion(target, traced: List[TracedVariant]
                          ) -> Iterator[Finding]:
    """STEP005: every op whose floating inputs are all 16-bit and whose
    output is fp32, by the ``repro_torch/`` site that called it. The
    harness builds bf16 models, so each silent upcast is visible.
    Load-bearing ones (fp32 softmax statistics, RMSNorm, RoPE, the SSM
    recurrence, sampling) are in the baseline with their reasons; a stray
    one is fixed, not listed."""
    seen: Dict[str, Set[str]] = {}
    for tv in traced:
        for rec in tv.ops:
            if rec.is_view:
                continue
            floats = [t.dtype for t in rec.inputs if t.is_floating_point()]
            if not floats or any(d not in _FLOAT16 for d in floats):
                continue
            if any(t.dtype == torch.float32 for t in rec.outputs):
                seen.setdefault(rec.site, set()).add(tv.variant.name)
    for site, variants in sorted(seen.items()):
        yield Finding(
            path=target.name, line=0, rule="STEP005", symbol=site,
            message=(f"silent bf16->fp32 upcast at {site} (variants: "
                     f"{_variants(variants)}) — justify in the baseline "
                     "or compute in the narrow dtype"))


def check_dead_surface(target, traced: List[TracedVariant]
                       ) -> Iterator[Finding]:
    """STEP006: dead inputs and outputs of the captured body.

    * a field of the variant's host array (``Engine.host_layout``) that
      no op reads: copied to the card every step, never used;
    * a params leaf that no op reads in any variant: model surface the
      step silently ignores;
    * a static output that aliases an input (the caller could read it
      directly) or depends on no input (a constant).

    Zero-size fields (the decode variant's chunk lengths) are vacuously
    live. A variant whose trace a host read stopped is skipped."""
    dead_fields: Dict[str, Set[str]] = {}
    passthrough: Dict[str, Set[str]] = {}
    eng = target.engine
    leaves = param_leaves(eng.params)
    leaf_of = {storage(t): path for path, t in leaves}
    read_leaves: Set[str] = set()
    complete = [tv for tv in traced if tv.stopped is None]
    for tv in complete:
        dev_store = storage(tv.dev)
        touched = torch.zeros(tv.host_len, dtype=torch.bool)
        inputs = {dev_store} | set(leaf_of) | {
            storage(t) for t in eng.state.values()} | {
            storage(t) for t in tv.lane_state or ()}
        derived = set(inputs)
        for rec in tv.ops:
            if any(storage(t) in derived for t in rec.inputs):
                derived.update(storage(t) for t in rec.outputs)
        for t in reads(tv.ops):
            st = storage(t)
            if st == dev_store:
                touched[elements(t)] = True
            elif st in leaf_of:
                read_leaves.add(leaf_of[st])
        for name, lo, hi in tv.fields:
            if hi > lo and not bool(touched[lo:hi].any()):
                dead_fields.setdefault(name, set()).add(tv.variant.name)
        for i, out in enumerate(tv.outputs):
            st = storage(out)
            if st in inputs:
                passthrough.setdefault(f"out[{i}]=input", set()).add(
                    tv.variant.name)
            elif st not in derived:
                passthrough.setdefault(f"out[{i}]=const", set()).add(
                    tv.variant.name)
    for name, variants in sorted(dead_fields.items()):
        yield Finding(
            path=target.name, line=0, rule="STEP006", symbol=name,
            message=(f"host-array field `{name}` is dead in variants "
                     f"{_variants(variants)} — copied every step, never "
                     "read"))
    if complete:
        names = {tv.variant.name for tv in complete}
        for path, _ in leaves:
            if path not in read_leaves:
                yield Finding(
                    path=target.name, line=0, rule="STEP006",
                    symbol=f"params{path}",
                    message=(f"params leaf `{path}` is never read by the "
                             f"step (variants: {_variants(names)})"))
    for site, variants in sorted(passthrough.items()):
        yield Finding(
            path=target.name, line=0, rule="STEP006", symbol=site,
            message=(f"step output `{site}` is a pass-through (variants: "
                     f"{_variants(variants)}) — the caller could read it "
                     "without a step"))


BODY_CHECKS = (check_capture_safety, check_host_reads,
               check_dtype_promotion, check_dead_surface)


def run_body_rules(target, traced: List[TracedVariant]) -> List[Finding]:
    """All four body rules over one target's traced variants."""
    out: List[Finding] = []
    for check in BODY_CHECKS:
        out.extend(check(target, traced))
    return out
