"""Mesh construction — :mod:`repro.launch.mesh` on ``DeviceMesh``.

``make_production_mesh`` is a FUNCTION (never a module-level constant) so
importing this module touches no process group.

Mesh layouts:

* single pod: ``(data=16, model=16)`` — 256 ranks.  DP/FSDP over
  ``data``, TP/EP over ``model``.
* multi-pod: ``(pod=2, data=16, model=16)`` — 512 ranks.  The ``pod`` axis
  is the slow inter-pod dimension: batch parallelism across pods, gradient
  reduction hierarchically scheduled (reduce-scatter inside a pod,
  cross-pod all-reduce, all-gather inside a pod — see
  :mod:`repro_torch.train.collective_schedule`).

A mesh needs the default process group, with one rank per device of the
mesh (``torchrun``, or ``torch.distributed.init_process_group`` with an
``init_method``); the device type defaults to ``cuda``, as the port's
other entry points do, and is ``cpu`` for a gloo world.
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["make_production_mesh", "make_mesh", "batch_axes",
           "PRODUCTION_SHAPES"]

#: (shape, axes) of the reference's two production meshes
PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group's ranks, on ``device_type`` (default ``cuda``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's 16×16 (or 2×16×16) mesh: needs a world of 256 (or
    512) ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
