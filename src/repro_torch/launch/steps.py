"""Step functions (train / prefill / serve) and their shardings.

Counterpart of ``repro.launch.steps``: the functions the dry-run traces
and the sharded launchers run, over a ``torch.distributed`` DeviceMesh
with DTensor params. ``build_step`` returns the step and its example
inputs, meta tensors of the global shapes (nothing is allocated); the
step's ``shard`` turns whole tensors (the same on every rank) into the
DTensors its specs say, and calling it runs it under the activation
rules.

The train kind runs through ``training.train_graph.TrainGraph``, the
counterpart of ``jax.jit``: on the card one CUDA graph per batch
signature. The prefill and serve kinds run eagerly, as the port's
``Model.prefill``/``decode_step`` do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import zeros as dtensor_zeros

from ..distributed.logical import activation_rules, standard_rules
from ..distributed.sharding import (TP, P, batch_axes, cache_pspecs,
                                    distribute_params, drop_fsdp,
                                    mesh_axis_sizes, param_pspecs,
                                    placements, sanitize_pspecs, tree_map)
from ..models import Model, ModelConfig
from ..training.optimizer import AdamWConfig
from ..training.train_graph import TrainGraph
from ..training.train_loop import train_body
from .shapes import ShapeSpec, adapt_config, input_specs


def make_train_step_fn(model: Model, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> metrics``, updating the
    params and state in place (``training.train_loop.train_body``)."""
    return train_body(model, opt_cfg)


def make_prefill_step_fn(model: Model, max_len: int,
                         init_cache: Optional[Callable] = None):
    """``prefill_step(params, batch) -> (logits [B, V], cache)``; the
    cache is ``init_cache(B, max_len)`` (the model's own by default; the
    sharded step's makes the cache of the shape it was built for)."""
    def prefill_step(params, batch):
        x = batch.get("tokens")
        x = batch["embeds"] if x is None else x
        cache = init_cache(x.shape[0], max_len) if init_cache else None
        return model.prefill(params, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), cache=cache,
                             max_len=max_len)
    return prefill_step


def make_serve_step_fn(model: Model):
    def serve_step(params, cache, tokens, positions):
        return model.decode_step(params, tokens, cache, positions)
    return serve_step


@dataclasses.dataclass
class ShardedStep:
    """A step over ``mesh``: ``fn`` takes DTensor arguments with the
    specs ``in_specs`` (one spec tree per positional argument, ``None``
    for an argument left as it is)."""
    kind: str
    fn: Callable
    mesh: Any
    model: Model
    in_specs: Tuple[Any, ...]

    def shard(self, *args):
        """Whole tensors (the same on every rank) -> DTensors by
        ``in_specs``; each rank keeps its shard of its own copy. A ``None``
        argument stays ``None``."""
        return tuple(None if a is None else
                     distribute_params(a, self.mesh, spec)
                     for a, spec in zip(args, self.in_specs))

    def __call__(self, *args):
        return self.fn(*args)


def _batch_specs(batch_shape: Dict[str, Any], mesh, multi_pod: bool,
                 replicate: bool = False):
    dp = None if replicate else batch_axes(multi_pod)
    specs = {k: P(*((dp,) + (None,) * (len(v.shape) - 1)))
             for k, v in batch_shape.items()}
    return sanitize_pspecs(specs, batch_shape, mesh)


def params_shape(cfg: ModelConfig, dtype) -> Dict[str, Any]:
    """The params tree as meta tensors, every fp32 leaf in ``dtype`` (as
    the reference's dry-run casts them)."""
    tree = Model(cfg, dtype=dtype, device="meta").init_params(None)
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                    else t, tree)


def build_step(arch_cfg: ModelConfig, shape: ShapeSpec, mesh,
               dtype=torch.bfloat16, param_mode: str = "2d", moe_dp: int = 0,
               opt_cfg: Optional[AdamWConfig] = None):
    """Returns ``(step, example_args)``: a ``ShardedStep`` and meta
    tensors of the global input shapes (nothing is allocated).

    ``param_mode``: ``"2d"`` (FSDP + TP) or ``"tp"`` (decode only:
    weights replicated over ``"data"``, sharded on ``"model"``). The
    model runs on the mesh's device type."""
    multi_pod = "pod" in mesh.mesh_dim_names
    dp = batch_axes(multi_pod)
    replicate_batch = shape.kind == "decode" and shape.global_batch == 1
    rules = standard_rules(dp, replicate_batch=replicate_batch)
    if moe_dp:
        rules["_moe_dp"] = moe_dp

    def with_rules(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with activation_rules(mesh, rules):
                return fn(*args, **kw)
        return wrapped

    cfg = adapt_config(arch_cfg, shape)
    model = Model(cfg, dtype=dtype, device=mesh.device_type)
    pshape = params_shape(cfg, dtype)
    pspecs = sanitize_pspecs(param_pspecs(pshape), pshape, mesh)
    if param_mode == "tp":
        if shape.kind != "decode":
            raise ValueError("the pure-TP layout is a decode lever")
        pspecs = drop_fsdp(pspecs)
    tp_size = mesh_axis_sizes(mesh)[TP]
    specs = input_specs(cfg, shape, dtype=dtype)

    if shape.kind == "train":
        fn = with_rules(make_train_step_fn(model, opt_cfg or AdamWConfig()))
        opt_shape = {
            "mu": tree_map(lambda t: t.to(torch.float32), pshape),
            "nu": tree_map(lambda t: t.to(torch.float32), pshape),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
        }
        ospecs = {"mu": pspecs, "nu": pspecs, "step": None}
        batch_shape = {k: v for k, v in specs.items() if v is not None}
        bspecs = _batch_specs(batch_shape, mesh, multi_pod)
        graph = TrainGraph(fn, mesh.device_type)
        step = ShardedStep("train", graph, mesh, model,
                           (pspecs, ospecs, bspecs))
        return step, (pshape, opt_shape, batch_shape)

    if shape.kind == "prefill":
        batch_shape = {k: v for k, v in specs.items() if v is not None}
        bspecs = _batch_specs(batch_shape, mesh, multi_pod)
        cshape = Model(cfg, dtype=dtype, device="meta").init_cache(
            shape.global_batch, shape.seq_len)
        cspecs = sanitize_pspecs(cache_pspecs(cshape, dp, tp_size=tp_size),
                                 cshape, mesh)
        fn = with_rules(make_prefill_step_fn(
            model, shape.seq_len,
            init_cache=lambda b, n: sharded_cache(cshape, mesh, cspecs)))
        step = ShardedStep("prefill", fn, mesh, model, (pspecs, bspecs))
        return step, (pshape, batch_shape)

    # decode
    fn = with_rules(make_serve_step_fn(model))
    shard_seq = shape.global_batch == 1          # long_500k
    cache_shape = specs["cache"]
    cspecs = sanitize_pspecs(
        cache_pspecs(cache_shape, dp, shard_seq=shard_seq, tp_size=tp_size),
        cache_shape, mesh)
    tok_spec = sanitize_pspecs(P(None) if shard_seq else P(dp),
                               specs["tokens"], mesh)
    step = ShardedStep("decode", fn, mesh, model,
                       (pspecs, cspecs, tok_spec, tok_spec))
    return step, (pshape, cache_shape, specs["tokens"], specs["positions"])


def sharded_cache(shapes, mesh, cspecs):
    """A cache of the meta tensors ``shapes`` (``Model.init_cache`` on
    the meta device) as DTensor zeros with ``cspecs``' placements, made
    shard by shard."""
    return {k: dtensor_zeros(v.shape, dtype=v.dtype, device_mesh=mesh,
                             placements=placements(mesh, cspecs[k]))
            for k, v in shapes.items()}
