"""The step body under a recorder: every aten op it dispatches, on fake
tensors, on the CPU.

Counterpart of ``tools/stepcheck/tracing.py`` (which walks jaxprs). The
port's step program is ``Engine._step_body`` (``serving/engine.py``), the
body each step variant's CUDA graph captures. ``trace_variant`` runs it
once per variant inside the target's ``FakeTensorMode`` (shapes and
dtypes only, no device work) under ``StepRecorder``, a
``TorchDispatchMode`` that records, per op: its name, the innermost
``repro_torch/`` frame that called it as ``file:function`` (no line
number: a baseline key must survive unrelated edits), its tensor inputs
and outputs (dtypes, devices, shapes), whether it is a view, and the
generator of a random draw. Fake tensors take no generator, so a draw is
recorded with its generator and run without it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .harness import EngineTarget

#: ops that read a value on the host or size an output by data (STEP004)
HOST_READS = ("_local_scalar_dense", "item", "nonzero", "masked_select",
              "_assert_async")
_THIS_PACKAGE = "/repro_torch/stepcheck/"
_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int32: "i32", torch.int64: "i64",
           torch.bool: "b1", torch.uint8: "u8"}


def is_host_read(op: str) -> bool:
    base = op.split(".")[1] if op.count(".") >= 1 else op
    return base in HOST_READS or "unique" in base


@dataclasses.dataclass
class OpRecord:
    """One dispatched aten op of the body."""

    op: str                              # "aten.mm.default"
    site: str                            # "repro_torch/models/x.py:fn"
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...] = ()
    is_view: bool = False
    generator: Optional[torch.Generator] = None
    kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def is_random(self) -> bool:
        return self.generator is not None or \
            self.op.split(".")[1] in _RANDOM


#: aten ops that draw random numbers (a draw with no generator uses the
#: default one)
_RANDOM = {"rand", "randn", "randint", "randperm", "normal", "normal_",
           "uniform_", "exponential_", "bernoulli", "bernoulli_",
           "multinomial", "random_", "geometric_", "cauchy_",
           "log_normal_", "rand_like", "randn_like", "randint_like",
           "poisson", "native_dropout"}


def source_site() -> str:
    """``file:function`` of the innermost ``repro_torch/`` frame on the
    stack outside this package (``<torch>`` when there is none)."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if "/repro_torch/" in name and _THIS_PACKAGE not in name:
            short = "repro_torch/" + name.split("/repro_torch/", 1)[1]
            return f"{short}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "<torch>"


def _tensors(values) -> Tuple[torch.Tensor, ...]:
    """The tensors among an op's arguments or results: top-level or in a
    list or tuple (the only places aten schemas put them)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return tuple(out)


class HostRead(RuntimeError):
    """Raised by the recorder at a STEP004 op: the trace stops there (a
    fake tensor has no value to read)."""


class StepRecorder(TorchDispatchMode):
    """Records every aten op dispatched under it (see the module
    docstring); an op of ``HOST_READS`` is recorded and then stops the
    trace with ``HostRead``."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        gen = kwargs.pop("generator", None)
        tensors = _tensors(list(args) + list(kwargs.values()))
        rec = OpRecord(str(func), source_site(), tensors,
                       is_view=bool(getattr(func, "is_view", False)),
                       generator=gen,
                       kwargs={k: v for k, v in kwargs.items()
                               if k in ("device", "dtype")})
        self.ops.append(rec)
        if is_host_read(rec.op):
            raise HostRead(f"{rec.op} at {rec.site}")
        out = func(*args, **kwargs)
        rec.outputs = _tensors(out if isinstance(out, (list, tuple))
                               else (out,))
        return out


@dataclasses.dataclass
class TracedVariant:
    """One variant's trace: the recorded ops, the body's outputs, the
    inputs it was given and, if a host read stopped it, where."""

    variant: object
    ops: List[OpRecord]
    outputs: Tuple[torch.Tensor, ...]
    dev: torch.Tensor
    lane_state: Optional[Tuple[torch.Tensor, ...]]
    host_len: int
    fields: List[Tuple[str, int, int]]
    stopped: Optional[str] = None


def fake_inputs(eng, lane_buckets: tuple, mode
                ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """The step body's inputs as tensors of ``mode`` (a ``FakeTensorMode``):
    the device copy of the variant's inert host array, and (ssm lanes)
    zero lane states of its graph's shapes."""
    mc = eng.model.cfg
    with mode:
        dev = mode.from_tensor(
            torch.from_numpy(eng.inert_host_array(lane_buckets)))
        lane = None
        if mc.uses_ssm and lane_buckets:
            lane = tuple(eng.state[k].new_zeros(
                (mc.num_layers, len(lane_buckets)) + eng.state[k].shape[2:])
                for k in ("conv", "ssd"))
    return dev, lane


def trace_variant(target: EngineTarget, variant) -> TracedVariant:
    """Run the variant's body once under the recorder, on fake tensors
    (``fake_inputs``)."""
    eng, mode = target.engine, target.mode
    lb = variant.lane_buckets
    dev, lane = fake_inputs(eng, lb, mode)
    rec = StepRecorder()
    outputs: Tuple[torch.Tensor, ...] = ()
    stopped = None
    with mode:
        try:
            with rec:
                outputs = tuple(eng._step_body(dev, lane, lb))
        except HostRead as exc:
            stopped = str(exc)
    return TracedVariant(variant, rec.ops, outputs, dev, lane,
                         int(dev.shape[0]), list(eng.host_layout(lb)),
                         stopped)


def storage(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


def elements(t: torch.Tensor) -> torch.Tensor:
    """The flat storage indices a strided tensor spans."""
    idx = torch.full((), t.storage_offset(), dtype=torch.int64)
    for size, stride in zip(t.shape, t.stride()):
        idx = idx[..., None] + torch.arange(size) * stride
    return idx.reshape(-1)


def tensor_str(t: torch.Tensor) -> str:
    """Canonical short form, e.g. ``bf16[4,97]``."""
    return (f"{_DTYPES.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(d) for d in t.shape)}]")


def variant_signature(tv: TracedVariant) -> Tuple[str, List[str],
                                                  List[str]]:
    """(sha256-16 digest, input strings, output strings) of a traced
    variant: the host array's length, the lane states' and the static
    outputs' shapes and dtypes. Any change of what the graph takes or
    gives changes the digest."""
    ins = [f"i32[{tv.host_len}]"] + [tensor_str(t)
                                     for t in tv.lane_state or ()]
    outs = [tensor_str(t) for t in tv.outputs]
    payload = "|".join(ins) + "->" + "|".join(outs)
    digest = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]
    return digest, ins, outs


def param_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every params leaf, e.g. ``['layers']['attn']['wq']``."""
    leaves, _ = pytree.tree_flatten_with_path(params)
    return [(pytree.keystr(path), t) for path, t in leaves
            if isinstance(t, torch.Tensor)]


#: ops that read a tensor's metadata (device, sizes), never its values
_METADATA = {"device", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_contiguous", "dim", "size", "stride",
             "empty_like", "zeros_like", "ones_like", "full_like",
             "new_empty", "new_zeros", "new_ones", "new_full",
             "empty_strided"}


def reads(ops: Sequence[OpRecord]) -> List[torch.Tensor]:
    """Every tensor an op reads the values of: the inputs of ops that are
    neither views (a view only aliases) nor metadata queries."""
    return [t for rec in ops
            if not rec.is_view and rec.op.split(".")[1] not in _METADATA
            for t in rec.inputs]


def same_generator(a: Optional[torch.Generator],
                   b: Optional[torch.Generator]) -> bool:
    """Whether two generator handles are one generator (the dispatcher
    hands an op a new Python handle of the caller's generator)."""
    if a is None or b is None:
        return a is b
    return getattr(a, "_cdata", id(a)) == getattr(b, "_cdata", id(b))
