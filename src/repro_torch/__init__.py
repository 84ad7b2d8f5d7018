"""PyTorch / CUDA port of :mod:`repro`, for one NVIDIA H100.

The package mirrors ``repro``'s module paths (``repro_torch.core.makespan``
↔ ``repro.core.makespan``) and never imports ``jax`` or ``repro``.  This
slice covers the main path: a :class:`~repro_torch.core.platform.Platform`,
the annealed multi-restart planner (:mod:`repro_torch.core.optimize`),
float64 pricing (:mod:`repro_torch.core.makespan`), and real execution on
the plan-driven engine, whose word-count reduce runs the hand-written
Hopper ``segment_sum`` kernel (:mod:`repro_torch.kernels`), all behind
:class:`repro_torch.api.GeoJob`.

Entry points run on the card unless the caller passes ``device="cpu"`` or
calls :func:`set_default_device`.
"""
from ._device import default_device, set_default_device

__all__ = ["default_device", "set_default_device"]
