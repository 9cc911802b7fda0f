"""Device meshes for the sharded steps and the dry-run.

Counterpart of ``repro.launch.mesh``. Functions only: importing this
module makes no process group and touches no device. ``make_mesh`` needs
an initialised default process group (``torch.distributed``) whose world
size is the mesh's size: NCCL on the card, gloo on the CPU, or the
``"fake"`` group of the dry-run.
"""
from __future__ import annotations

from typing import Sequence

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default process group's ranks (row-major, as ``jax.make_mesh``)."""
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production meshes: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``
    when ``multi_pod`` (256 and 512 ranks), so the port's spec trees hold
    leaf by leaf against the reference's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


# Published per-card rates of an NVIDIA H100 80GB HBM3 (SXM5), 700 W, for
# the dry-run's roofline terms.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s per direction
