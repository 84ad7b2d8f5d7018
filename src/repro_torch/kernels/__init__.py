"""Hand-written Hopper kernels of the port, with their plain versions.

* :mod:`repro_torch.kernels.segment_reduce` — ``segment_sum``, CUDA C++ in
  ``csrc/segment_sum.cu`` (word count's reduce).
* :mod:`repro_torch.kernels.ref` — the plain PyTorch versions.
* :mod:`repro_torch.kernels.ops` — the entry points the engine calls.
* :mod:`repro_torch.kernels._build` — ``nvcc`` build and ctypes loader.
"""
from . import ops, ref
from .segment_reduce import segment_sum

__all__ = ["ops", "ref", "segment_sum"]
