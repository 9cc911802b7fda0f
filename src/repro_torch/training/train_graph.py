"""The train step as one CUDA graph per batch signature.

Counterpart of the reference's ``jax.jit(make_train_step(...))``
(``repro/training/train_loop.py:54``) and of its jitted PRM-head step
(``:98``), on the rules of ``serving/step_graph.py:StepGraph``. A
``TrainGraph`` wraps a step body ``body(params, opt_state, batch) ->
{name: 0-d tensor}`` that updates ``params`` and ``opt_state`` in place.
It keeps one entry per batch signature (the keys, shapes and dtypes of
``batch``): the signature's static device buffers, its static outputs
and, on the card, its CUDA graph.

The graph is bound to the ``params`` and ``opt_state`` trees of its first
call, by the addresses of their leaves (the update writes them in place,
so the addresses stay); a later call with another tree raises. On the
card the first call of a signature runs the body eagerly on the static
buffers: a real training step, which also builds and loads the kernels,
raises their shared memory and sets up cuBLAS and autograd. The second
call captures the body with ``torch.cuda.graph`` into the step's own
memory pool (capture executes nothing) and replays it for that step;
every later call copies the batch into the buffers and runs one
``replay()``, reading no host value. A failed capture or replay raises:
nothing falls back to the eager step. Eagerly (on the CPU, or on the card
inside ``eager()``) the body runs on the same buffers and its outputs are
copied into the same static outputs, so a metric kept past the next call
is overwritten on the CPU too.

A sharded step (DTensor trees, ``launch/steps.py``) is bound to the
addresses of its leaves' local tensors, and its batch buffers are
DTensors with the batch's placements.

The kernel wrappers' launch counters count launches when the wrapper
runs: under capture, the launches the graph records. ``recorded`` keeps
them per signature; ``launches_run`` is what the steps launched on the
device: recorded launches times replays plus the eager steps' own.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..kernels.launches import launch_counts, launches_since
from .optimizer import tree_leaves

Body = Callable[[Any, Any, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def _add(into: Dict[str, int], counts: Dict[str, int], times: int = 1):
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n * times


def batch_signature(batch: Dict[str, torch.Tensor]) -> Tuple:
    """The keys, shapes and dtypes of ``batch``: one graph each."""
    return tuple((k, tuple(batch[k].shape), batch[k].dtype)
                 for k in sorted(batch))


class Signature:
    """One batch signature's static buffers and outputs and, on the card,
    its graph."""

    def __init__(self, batch: Dict[str, torch.Tensor], device):
        self.batch = {k: torch.empty_like(v) if isinstance(v, DTensor)
                      else torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.eager_runs = 0
        self.captures = 0
        self.capture_seconds = 0.0
        self.recorded: Dict[str, int] = {}      # launches per replay
        self.eager_launches: Dict[str, int] = {}


class TrainGraph:
    """A train step: ``step(params, opt_state, batch) -> (params,
    opt_state, outputs)``, the same trees (updated in place) and the
    signature's static outputs, valid until the next call of the same
    signature."""

    def __init__(self, body: Body, device):
        self.body = body
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.signatures: Dict[Tuple, Signature] = {}
        self.params = self.opt_state = None      # the bound trees
        self._ptrs: Optional[Tuple[int, ...]] = None
        self._eager = False
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None

    @contextlib.contextmanager
    def eager(self):
        """Within the block every call runs the body op by op (on the
        card too), on the same static buffers, for comparison."""
        before, self._eager = self._eager, True
        try:
            yield
        finally:
            self._eager = before

    def __call__(self, params, opt_state, batch: Dict[str, torch.Tensor]):
        self._bind(params, opt_state)
        key = batch_signature(batch)
        sig = self.signatures.get(key)
        if sig is None:
            sig = self.signatures[key] = Signature(batch, self.device)
        for k, v in batch.items():
            sig.batch[k].copy_(v)
        if self._cuda and not self._eager and sig.eager_runs:
            if sig.graph is None:
                self._capture(sig)
            sig.graph.replay()
            sig.replays += 1
        else:
            before = launch_counts()
            out = self.body(params, opt_state, sig.batch)
            _add(sig.eager_launches, launches_since(before))
            if sig.outputs is None:
                sig.outputs = {k: torch.empty_like(t) for k, t in out.items()}
            for k, t in out.items():
                sig.outputs[k].copy_(t)
            sig.eager_runs += 1
        return params, opt_state, sig.outputs

    def _bind(self, params, opt_state) -> None:
        """Bind to the first call's trees (a DTensor leaf by its local
        tensor); raise on another tree."""
        trees = (params,) if opt_state is None else (params, opt_state)
        ptrs = tuple((t.to_local() if isinstance(t, DTensor) else t)
                     .data_ptr() for tree in trees for t in tree_leaves(tree))
        if self._ptrs is None:
            self._ptrs, self.params, self.opt_state = ptrs, params, opt_state
        elif ptrs != self._ptrs:
            raise ValueError("TrainGraph: called with another params or "
                             "opt-state tree than the one it is bound to "
                             "(its graphs write those leaves in place)")

    def _capture(self, sig: Signature) -> None:
        """Capture the body on the signature's buffers into the step's
        pool, its outputs copied into the static outputs inside the graph.
        The eager warm-up's cached blocks are handed back first, so that
        they do not sit beside the pool; Python's cyclic collector is run
        before the capture and held off during it (``StepGraph._capture``
        says why)."""
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self.body(self.params, self.opt_state, sig.batch)
                for k, t in out.items():
                    sig.outputs[k].copy_(t)
                del out
        finally:
            if collecting:
                gc.enable()
        sig.recorded = launches_since(before)
        torch.cuda.synchronize()
        sig.graph = graph
        sig.captures += 1
        sig.capture_seconds = time.perf_counter() - t0

    @property
    def captures(self) -> int:
        return sum(s.captures for s in self.signatures.values())

    @property
    def replays(self) -> int:
        return sum(s.replays for s in self.signatures.values())

    @property
    def eager_runs(self) -> int:
        return sum(s.eager_runs for s in self.signatures.values())

    def launches_run(self) -> Dict[str, int]:
        """Kernel launches the steps ran on the device: each signature's
        eager launches plus its recorded launches times its replays."""
        out: Dict[str, int] = {}
        for sig in self.signatures.values():
            _add(out, sig.eager_launches)
            _add(out, sig.recorded, sig.replays)
        return out
