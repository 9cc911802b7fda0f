"""Logical activation-sharding constraints.

Counterpart of ``repro.distributed.logical``. Model code pins activations
to logical axes at layer boundaries with ``constrain(x, name)``; a step
binds the logical names to specs over a ``DeviceMesh`` with
``activation_rules(mesh, rules)`` while it runs. Under a context,
``constrain`` redistributes a DTensor ``x`` to the placements of its
rule (``x.redistribute``). It returns ``x`` itself, untouched, when there
is no context, no rule for ``name``, or ``x`` is not a DTensor (a plain
tensor is one device's whole tensor): the single-device serve and train
paths never see a change.

One difference from the reference: GSPMD pads an activation dim that a
mesh axis does not divide; DTensor would make uneven shards, some of them
empty. Here such an axis is dropped from the rule and that dim is
replicated (``sharding.sanitize_spec``, the activation counterpart of
``sanitize_pspecs``).

The reference's ``analysis_mode``/``scan_unroll`` have no counterpart:
they unroll the reference's ``lax.scan`` over layers for the dry-run's
L=1/L=2 traces, and the port's layer loop is a Python loop, unrolled
already.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .sharding import P, mesh_axis_sizes, placements, sanitize_spec

_STATE = threading.local()


def _current():
    return getattr(_STATE, "rules", None)


def moe_dp_chunks() -> int:
    """Number of data shards for the shard-local MoE dispatch (the rule
    map's ``"_moe_dp"``). 0 or 1 is the global dispatch."""
    cur = _current()
    if cur is None:
        return 0
    return int(cur[1].get("_moe_dp", 0) or 0)


@contextlib.contextmanager
def activation_rules(mesh, rules: Dict[str, P]):
    """Bind the logical names to ``rules`` over ``mesh`` for the block.
    Within it a plain tensor that meets a DTensor in an op (a position
    ``arange``, a mask) counts as replicated: the model makes such
    tensors at their global shapes."""
    prev = _current()
    _STATE.rules = (mesh, dict(rules))
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.rules = prev


def constrain(x, name: str):
    cur = _current()
    if cur is None:
        return x
    mesh, rules = cur
    spec = rules.get(name)
    if spec is None or not isinstance(x, DTensor):
        return x
    spec = sanitize_spec(spec, x.shape, mesh_axis_sizes(mesh))
    target = placements(mesh, spec)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def standard_rules(dp, tp="model", *, replicate_batch: bool = False
                   ) -> Dict[str, P]:
    """The logical-axis map the launchers use. ``dp``: the data-parallel
    axis names; ``replicate_batch``: long_500k mode (global batch 1)."""
    b = None if replicate_batch else tuple(dp)
    return {
        "btd": P(b, None, None),        # token activations [B,S,D]
        "bshd": P(b, None, tp, None),   # per-head q/k/v [B,S,H,hd]
        "btv": P(b, None, tp),          # logits [B,S,V]
        "bv": P(b, tp),                 # decode logits [B,V]
        "ecd": P(tp, None, None),       # MoE dispatch buffer [E,C,D]
        "ecf": P(tp, None, None),       # MoE expert hidden [E,C,F]
        # shard-local MoE dispatch: the group axis is the data shards
        "gtd": P(b, None, None),        # regrouped tokens [G,T/G,D]
        "gecd": P(b, tp, None, None),   # local buffers [G,E,C,D]
    }
