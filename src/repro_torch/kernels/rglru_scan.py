"""RG-LRU gated linear recurrence on Hopper — RecurrentGemma's recurrent
block, in prefill and in every decode step.

Replaces the TPU kernel :func:`repro.kernels.rglru_scan._rglru_kernel` (a
chunked associative scan with the carry in VMEM across a sequential chunk
grid axis) with the hand-written CUDA C++ kernel ``csrc/rglru_scan.cu`` for
``sm_90a``.  The function is bound by bytes on the H100; this first kernel
walks time in order, one thread per (batch, channel), with coalesced loads
issued ahead of the dependent chain; see the note in the source.

For a tensor on the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.rglru_scan_ref`; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .ref import rglru_scan_ref

__all__ = ["rglru_scan"]

_ENTRY = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("rglru_scan"), _ENTRY[dtype])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, p, p, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, a: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: x on {x.device}, need cuda")
    if a.device != x.device:
        raise ValueError(f"rglru_scan: a on {a.device}, x on {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"rglru_scan: x dtype {x.dtype}, need float32 or "
                        "bfloat16")
    if a.dtype != x.dtype:
        raise TypeError(f"rglru_scan: a dtype {a.dtype}, x dtype {x.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan: need x and a (B, T, D) of one shape, "
                         f"got {tuple(x.shape)} and {tuple(a.shape)}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("rglru_scan: x and a must be contiguous")
    if h0 is not None:
        if h0.device != x.device:
            raise ValueError(f"rglru_scan: h0 on {h0.device}, x on {x.device}")
        if h0.dtype != torch.float32:
            raise TypeError(f"rglru_scan: h0 dtype {h0.dtype}, need float32")
        if h0.shape != (x.shape[0], x.shape[2]):
            raise ValueError(f"rglru_scan: h0 must be ({x.shape[0]}, "
                             f"{x.shape[2]}), got {tuple(h0.shape)}")
        if not h0.is_contiguous():
            raise ValueError("rglru_scan: h0 must be contiguous")


def rglru_scan(
    x: torch.Tensor,  # (B, T, D) gated input
    a: torch.Tensor,  # (B, T, D) recurrence gate in (0, 1)
    h0: Optional[torch.Tensor] = None,  # (B, D) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` → ``(h_all,
    h_T)``: every state in x's dtype and the last in float32.  Each kernel
    launch adds one to ``rglru_scan.launches``."""
    if x.device.type == "cpu":
        return rglru_scan_ref(x, a, h0)
    _check(x, a, h0)
    B, T, D = x.shape
    y = torch.empty_like(x)
    h_t = (h0.clone() if h0 is not None
           else torch.zeros((B, D), dtype=torch.float32, device=x.device))
    if B and D and T:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _kernel(x.dtype)(
                x.data_ptr(), a.data_ptr(),
                None if h0 is None else h0.data_ptr(),
                y.data_ptr(), h_t.data_ptr(), B, T, D, stream,
            )
        if rc != 0:
            raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA "
                               f"error {rc}")
        rglru_scan.launches += 1
    return y, h_t


rglru_scan.launches = 0
