"""Hand-written Hopper kernels of the port, with their plain versions.

* :mod:`repro_torch.kernels.segment_reduce` — ``segment_sum``, CUDA C++ in
  ``csrc/segment_sum.cu`` (word count's reduce).
* :mod:`repro_torch.kernels.flash_attention` — ``flash_attention``, CUDA
  C++ in ``csrc/flash_attention.cu`` (prefill attention: bf16 on the
  tensor cores with ``wgmma`` fed by TMA, float32 on the CUDA cores).
* :mod:`repro_torch.kernels.mamba_scan` — ``mamba_scan``, CUDA C++ in
  ``csrc/mamba_scan.cu`` (the Mamba-1 selective scan, prefill and decode).
* :mod:`repro_torch.kernels.moe_dispatch` — ``moe_dispatch``, CUDA C++ in
  ``csrc/moe_dispatch.cu`` (the MoE layers' token scatter, prefill and
  decode), and ``compute_slots``.
* :mod:`repro_torch.kernels.rglru_scan` — ``rglru_scan``, CUDA C++ in
  ``csrc/rglru_scan.cu`` (the RG-LRU recurrence, prefill and decode).
* :mod:`repro_torch.kernels.ref` — the plain PyTorch versions.
* :mod:`repro_torch.kernels.ops` — the entry points the models and the
  engine call.
* :mod:`repro_torch.kernels._build` — ``nvcc`` build and ctypes loader.
"""
from . import ops, ref
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .moe_dispatch import compute_slots, moe_dispatch
from .rglru_scan import rglru_scan
from .segment_reduce import segment_sum

__all__ = ["compute_slots", "flash_attention", "mamba_scan", "moe_dispatch",
           "ops", "ref", "rglru_scan", "segment_sum"]
