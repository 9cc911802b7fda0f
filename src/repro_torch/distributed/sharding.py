"""Sharding rules: parameter, optimizer and cache specs, as DTensor
placements.

Counterpart of ``repro.distributed.sharding``, with the same scheme over
a ``torch.distributed`` ``DeviceMesh``:

  * tp   = ``"model"``: tensor and expert parallelism (attention heads,
           FFN hidden, experts, vocab).
  * fsdp = ``"data"``: weight and optimizer-state sharding along the
           other matrix dim (ZeRO-3 style); DTensor all-gathers a layer's
           weights where an op needs them whole.
  * batch axes: ``("pod", "data")`` on the multi-pod mesh, else
           ``("data",)``.

A spec is a ``P``, a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (the dim is sharded
over their product, the first one major, as JAX orders them). The rules
are the reference's, key path for key path, over the port's params tree
(nested dicts, per-layer leaves stacked ``[L, ...]``). ``shardings``
turns each spec into DTensor placements, one per mesh dim: ``Shard(d)``
where the spec names that mesh dim on tensor dim ``d``, else
``Replicate()``. ``distribute_params`` makes the DTensor tree.

Dims that do not divide their mesh axes are replicated
(``sanitize_pspecs``): DTensor, unlike GSPMD, does not pad a shard. So
are dims of size 1.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

TP = "model"
FSDP = "data"


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


# (path regex, spec WITHOUT the leading layer-stack axis): the reference's
# _PARAM_RULES. Vocab-parallel embeddings keep d_model replicated, so the
# logits' contraction stays local.
_PARAM_RULES = [
    (r"embed/embedding$",        P(TP, None)),
    (r"embed/lm_head$",          P(None, TP)),
    (r"attn/w[qkv]$",            P(FSDP, TP)),
    (r"attn/wo$",                P(TP, FSDP)),
    (r"attn/b[qkv]$",            P(TP)),
    (r"mlp/w_(up|gate)$",        P(FSDP, TP)),
    (r"mlp/w_down$",             P(TP, FSDP)),
    (r"mlp/b_up$",               P(TP)),
    (r"mlp/b_down$",             P(None)),
    (r"moe/router$",             P(FSDP, None)),
    (r"moe/w_(up|gate)$",        P(TP, FSDP, None)),   # experts on tp
    (r"moe/w_down$",             P(TP, None, FSDP)),
    (r"mamba/in_proj$",          P(FSDP, TP)),
    (r"mamba/out_proj$",         P(TP, FSDP)),
    (r"mamba/conv_w$",           P(None, TP)),
    (r"mamba/conv_b$",           P(TP)),
    (r"mamba/norm/(scale|bias)$", P(TP)),
    (r"mamba/(a_log|d_skip|dt_bias)$", P(None)),
    (r"norm\d?/(scale|bias)$",   P(None)),
    (r"final_norm/(scale|bias)$", P(None)),
]


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, trees of
    the same structure); a bare leaf is mapped too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _map_with_path(fn, tree, prefix: str = ""):
    return {k: (_map_with_path(fn, v, f"{prefix}{k}/")
                if isinstance(v, dict) else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def param_spec(path_str: str, ndim: int) -> P:
    stacked = path_str.startswith("layers/")
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_str):
            parts = tuple(spec)
            if stacked:
                parts = (None,) + parts
            assert len(parts) <= ndim, (path_str, parts, ndim)
            return P(*(parts + (None,) * (ndim - len(parts))))
    raise KeyError(f"no sharding rule for param {path_str!r} (ndim={ndim})")


def param_pspecs(params_shape) -> Any:
    """A params tree (tensors, meta tensors or anything with ``.shape``)
    -> the same tree of specs."""
    return _map_with_path(lambda path, leaf: param_spec(path, len(leaf.shape)),
                          params_shape)


def drop_fsdp(spec_tree) -> Any:
    """The pure-TP layout for decode: the FSDP (``"data"``) axis of every
    spec replaced by replication, tensor and expert parallelism kept."""
    def fix(spec):
        if not isinstance(spec, P):
            return spec
        out = []
        for axes in spec:
            if axes is None:
                out.append(None)
            elif isinstance(axes, tuple):
                kept = tuple(a for a in axes if a != FSDP)
                out.append(kept if kept else None)
            else:
                out.append(None if axes == FSDP else axes)
        return P(*out)
    return tree_map(fix, spec_tree)


def opt_pspecs(params_shape) -> Any:
    ps = param_pspecs(params_shape)
    return {"mu": ps, "nu": ps, "step": P()}


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def cache_pspecs(cache_shape, dp, *, shard_seq: bool = False,
                 tp_size: int = 16) -> Dict[str, P]:
    """Decode-cache specs, shape-aware, as the reference's.

    KV cache ``[L, B, S, kv, hd]``: ``"model"`` lands on kv_heads when
    they divide it, otherwise on the sequence (each model shard holds a
    slab of keys and the softmax partials merge across it).
    ``shard_seq``: long_500k mode, batch 1 replicated and the sequence
    takes the data axes too. SSM states: conv channels and the SSD
    head_dim take the model axis."""
    specs = {}
    for key, leaf in cache_shape.items():
        if key in ("k", "v"):          # [L, B, S, kv, hd]
            kv = leaf.shape[3]
            if kv % tp_size == 0:
                specs[key] = (P(None, None, dp, TP, None) if shard_seq
                              else P(None, dp, None, TP, None))
            else:
                seq_axes = (tuple(dp) + (TP,)) if shard_seq else TP
                specs[key] = (P(None, None, seq_axes, None, None)
                              if shard_seq
                              else P(None, dp, TP, None, None))
        elif key == "conv":            # [L, B, W-1, C]
            specs[key] = P(None, None if shard_seq else dp, None, TP)
        elif key == "ssd":             # [L, B, H, P, N]
            specs[key] = P(None, None if shard_seq else dp, None, TP, None)
        else:
            raise KeyError(key)
    return specs


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, tuple) else (axes,)


def sanitize_spec(spec: P, shape: Sequence[int], sizes: Dict[str, int]) -> P:
    """``spec`` padded to ``len(shape)`` entries, with every sharded dim
    whose size does not divide its mesh axes replicated, and every dim of
    size 1 (nothing to shard; DTensor cannot squeeze a sharded dim, as a
    matmul's fold of a batch of 1 does)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in enumerate(parts[:len(shape)]):
        total = 1
        for n in _names(axes):
            total *= sizes[n]
        out.append(axes if axes is not None and shape[dim] % total == 0
                   and shape[dim] > 1 else None)
    return P(*out)


def sanitize_pspecs(spec_tree, shape_tree, mesh):
    """Replicate every sharded dim whose size does not divide its mesh
    axes (e.g. vocab 50280 or kv_heads 2 over a 16-way axis)."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda spec, leaf: sanitize_spec(spec, leaf.shape, sizes)
                    if isinstance(spec, P) else spec, spec_tree, shape_tree)


def placements(mesh, spec: P) -> Tuple[Placement, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec names it on tensor dim ``d``, else
    ``Replicate()``. A dim over a tuple of axes takes ``Shard(d)`` on each,
    which DTensor orders by mesh dim: the tuple must follow the mesh's
    order (the first axis major, as in JAX)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        axes = _names(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


def shardings(mesh, tree_of_pspecs):
    """A tree of specs -> the same tree of placement tuples."""
    return tree_map(lambda spec: placements(mesh, spec), tree_of_pspecs)


def distribute_params(tree, mesh, specs):
    """A port tree of full tensors (the same on every rank) -> DTensors
    with the specs' placements (a ``None`` spec leaves its leaf as it
    is). Each rank keeps its own shard of its own copy: nothing is sent
    between ranks. A leaf that is sharded over no mesh dim of more than
    one rank becomes a DTensor around the same tensor (no copy)."""
    def one(t, spec):
        if spec is None:
            return t
        pl = placements(mesh, spec)
        if all(p == Replicate() or mesh.size(i) == 1
               for i, p in enumerate(pl)):
            return DTensor.from_local(t, mesh, pl, run_check=False)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return tree_map(one, tree, specs)


def local_bytes(shape: Sequence[int], itemsize: int, spec: P,
                sizes: Dict[str, int]) -> int:
    """The bytes of one device's shard of a tensor of ``shape`` under
    ``spec`` (a sanitized spec: every sharded dim divides)."""
    n = itemsize
    for dim, extent in enumerate(shape):
        div = 1
        for a in _names(spec[dim] if dim < len(spec) else None):
            div *= sizes[a]
        n *= extent // div
    return n


def full_tree(tree):
    """A DTensor tree gathered to full tensors (tests and checks)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def local_tree(tree):
    """Each DTensor leaf's local tensor (plain leaves as they are)."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


__all__ = ["P", "TP", "FSDP", "param_spec", "param_pspecs", "drop_fsdp",
           "opt_pspecs", "batch_axes", "cache_pspecs", "sanitize_pspecs",
           "shardings", "placements", "distribute_params", "tree_map",
           "mesh_axis_sizes", "local_bytes", "full_tree", "local_tree"]
