"""Running a function on each rank's local shards of DTensors.

The port's kernels are bound through ctypes on raw device pointers, and
some ops (index writes, the MoE scatter) have no DTensor sharding
strategy. Those calls run under ``local_map``: the inputs are brought to
stated placements, the function runs on each rank's local tensors (on the
card: the kernels, K4 and K5 with their backwards), and its outputs are
DTensors again, autograd carried through. These helpers say which shard
of a tensor dim a rank holds.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

from .sharding import TP


def shard_dims(placements: Sequence[Placement], dim: int) -> Tuple[int, ...]:
    """The mesh dims on which ``dim`` is sharded."""
    return tuple(i for i, p in enumerate(placements) if p == Shard(dim))


def shard_count(mesh, mesh_dims: Sequence[int]) -> int:
    n = 1
    for i in mesh_dims:
        n *= mesh.size(i)
    return n


def shard_index(mesh, mesh_dims: Sequence[int]) -> int:
    """This rank's shard number over ``mesh_dims`` (the first major, as
    DTensor orders a dim sharded over several mesh dims)."""
    idx = 0
    for i in mesh_dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def model_dim(mesh) -> int:
    """The index of the ``"model"`` mesh dim (-1 without one)."""
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(TP) if TP in names else -1


def batch_placements(x: DTensor) -> Tuple[Placement, ...]:
    """``x``'s batch sharding (``Shard(0)`` on the mesh dims where x has
    it) with every other mesh dim replicated."""
    return tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in x.placements)


def as_dtensor(t, mesh, placements_: Sequence[Placement]) -> DTensor:
    """``t`` (a DTensor or a plain tensor holding the whole, global value
    on every rank) as a DTensor with ``placements_``."""
    if not isinstance(t, DTensor):
        t = distribute_tensor(t, mesh, [Replicate()] * mesh.ndim,
                              src_data_rank=None)
    return t.redistribute(mesh, tuple(placements_))


def split_last(t, sizes: Sequence[int]):
    """``t`` [..., prod(sizes)] reshaped to [..., *sizes]. A DTensor
    whose last dim is sharded over more ranks than divide ``sizes[0]`` is
    gathered there first (DTensor cannot cut a shard across the split)."""
    shape = tuple(t.shape[:-1]) + tuple(sizes)
    if isinstance(t, DTensor):
        dims = shard_dims(t.placements, t.dim() - 1)
        if dims and sizes[0] % shard_count(t.device_mesh, dims):
            t = t.redistribute(t.device_mesh, tuple(
                Replicate() if i in dims else p
                for i, p in enumerate(t.placements)))
    return t.reshape(shape)


def partial_where(placements_: Sequence[Placement],
                  reduced: Sequence[int]) -> Tuple[Placement, ...]:
    """``placements_`` with ``Partial()`` on the mesh dims in ``reduced``:
    the placements of a gradient that each rank there only holds a part
    of."""
    return tuple(Partial() if i in reduced else p
                 for i, p in enumerate(placements_))


__all__ = ["shard_dims", "shard_count", "shard_index", "model_dim",
           "batch_placements", "as_dtensor", "split_last", "partial_where"]
