"""The serve step as one CUDA graph per step variant.

Counterpart of the reference's ``jax.jit(self._step_fn,
static_argnames=("lane_buckets",))``: the engine keeps one ``StepGraph``
per entry of ``Engine.step_variants()`` it has run (``decode`` and
``mixed:b{bucket}xl{lanes}``). Each holds the variant's static inputs —
the step's one host array, in a pinned host buffer and its device copy,
and the chunk lanes' stacked SSM state — and its static outputs, and on
the card the CUDA graph of the step body over them.

On the card the first run of a variant warms the body up eagerly on the
variant's inert array (every write lands on the spare page, every SSM
state is frozen, the RNG state is put back), which builds and loads the
kernels, raises their shared memory and sets up cuBLAS; it then captures
the body with ``torch.cuda.graph`` into the engine's one memory pool,
with the engine's generator registered so that each replay draws fresh
noise, and replays it for the real step. Every later run is a copy into
the inputs and one ``replay()``. A failed capture raises: nothing falls
back to the eager step. Eagerly — on the CPU, or on the card inside
``Engine.eager()`` — the body runs on the same buffers and its outputs
are copied into the same static outputs, so an output kept past a step
as a view of them is overwritten by the next step on the CPU too.

The kernel wrappers' launch counters count launches when the wrapper
runs: under capture, the launches the graph records. ``recorded`` keeps
them per variant; ``launches_run`` is what the steps launched on the
device: recorded launches times replays plus the eager steps' own.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.flash_prefill import flash_prefill, paged_prefill
from ..kernels.paged_attention import paged_attention, tree_decode
from ..kernels.ssd_scan import ssd_scan


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name."""
    return {"paged_decode": paged_attention.launches,
            "paged_prefill": paged_prefill.launches,
            "paged_tree_shared": tree_decode.shared_launches,
            "paged_tree_branch": tree_decode.branch_launches,
            "ssd_scan": ssd_scan.launches,
            "flash_prefill": flash_prefill.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}


class StepGraph:
    """One step variant's static buffers and, on the card, its graph.

    ``body(dev, lane_state)`` is the step body: it reads the device copy
    of the host array and the lanes' SSM state (or None) and returns a
    tuple of device tensors, with no host read of a value and no
    allocation whose size depends on data. ``inert`` is the variant's
    host array that writes nothing but the spare page."""

    def __init__(self, body: Callable, inert: np.ndarray,
                 device: torch.device,
                 lane_state: Optional[Tuple[torch.Tensor, ...]] = None,
                 pool=None, generator: Optional[torch.Generator] = None):
        self._body, self._inert = body, inert
        self._cuda = device.type == "cuda"
        self.host = torch.empty(inert.shape, dtype=torch.int32,
                                pin_memory=self._cuda)
        self._host_np = self.host.numpy()
        self.dev = torch.empty(inert.shape, dtype=torch.int32, device=device)
        self.lane_state = lane_state
        self._pool, self._gen = pool, generator
        # the host buffer is rewritten only once its last copy has run
        self._copied = torch.cuda.Event() if self._cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.replays = 0
        self.eager_runs = 0
        self.captures = 0         # one per variant; a recapture counts
        self.capture_seconds = 0.0
        self.recorded: Dict[str, int] = {}      # launches per replay
        self.eager_launches: Dict[str, int] = {}

    def _load(self, host: np.ndarray,
              lanes: Sequence[Tuple[torch.Tensor, ...]]) -> None:
        """The step's inputs into the static buffers: the host array by
        one copy from pinned memory, each lane's state into its lane."""
        if self._copied is not None:
            self._copied.synchronize()
        self._host_np[:] = host
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        for i, state in enumerate(lanes):
            for buf, part in zip(self.lane_state, state):
                buf[:, i].copy_(part[:, 0])

    def run(self, host: np.ndarray,
            lanes: Sequence[Tuple[torch.Tensor, ...]] = (),
            eager: bool = False) -> Tuple[torch.Tensor, ...]:
        """One step: load the inputs, then replay the variant's graph (on
        the card, capturing it on first use) or, eagerly, run the body and
        copy its outputs into the static outputs. Returns the static
        outputs, valid until the engine's next step: graphs that share a
        pool may reuse each other's memory."""
        if self._cuda and not eager and self.graph is None:
            self._load(self._inert, ())
            self._capture()
        self._load(host, lanes)
        if self._cuda and not eager:
            self.graph.replay()
            self.replays += 1
            return self.outputs
        before = launch_counts()
        out = self._body(self.dev, self.lane_state)
        for k, n in _since(before).items():
            self.eager_launches[k] = self.eager_launches.get(k, 0) + n
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(t) for t in out)
        for buf, t in zip(self.outputs, out):
            buf.copy_(t)
        self.eager_runs += 1
        return self.outputs

    def _capture(self) -> None:
        """Warm the body up on the inert inputs, then capture it. Python's
        cyclic collector is run before the capture and held off during
        it: a dead engine's graphs, freed by a collection that the
        capture's own allocations set off, would be destroyed mid-capture,
        which CUDA forbids and which invalidates the capture."""
        t0 = time.perf_counter()
        rng = self._gen.get_state() if self._gen is not None else None
        self._body(self.dev, self.lane_state)
        if rng is not None:
            self._gen.set_state(rng)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        if self._gen is not None:
            graph.register_generator_state(self._gen)
        before = launch_counts()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self._body(self.dev, self.lane_state)
        finally:
            if collecting:
                gc.enable()
        self.recorded = _since(before)
        torch.cuda.synchronize()
        self.graph, self.outputs = graph, tuple(out)
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0

    def launches_run(self) -> Dict[str, int]:
        """Kernel launches this variant's steps ran on the device."""
        out = dict(self.eager_launches)
        for k, n in self.recorded.items():
            out[k] = out.get(k, 0) + n * self.replays
        return out
