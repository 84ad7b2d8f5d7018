"""Segment sum on Hopper — the MapReduce combiner/reducer primitive.

Replaces the TPU kernel :func:`repro.kernels.segment_reduce._segsum_kernel`
(a one-hot ``Pᵀ @ values`` MXU matmul per row block) with the hand-written
CUDA C++ kernel ``csrc/segment_sum.cu`` for ``sm_90a``.  The kernel is
bound by bytes on the H100: each element is read once and added once, so
it reads rows coalesced and adds each element into a float32 output with
one atomic, which also takes any id order; see the note in the source.

``num_segments`` is a run-time integer, not a compile-time constant: word
count passes each reducer's count of unique keys.  For a tensor on the CPU
the wrapper computes the plain version :func:`repro_torch.kernels.ref.
segment_sum_ref`; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import segment_sum_ref

__all__ = ["segment_sum"]

_ENTRY = {torch.float32: "segment_sum_f32", torch.bfloat16: "segment_sum_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("segment_sum"), _ENTRY[dtype])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _check(values: torch.Tensor, segment_ids: torch.Tensor,
           num_segments: int) -> None:
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: values on {values.device}, need cuda")
    if segment_ids.device != values.device:
        raise ValueError(
            f"segment_sum: segment_ids on {segment_ids.device}, values on "
            f"{values.device}"
        )
    if values.dim() != 2:
        raise ValueError(f"segment_sum: values must be (N, D), got "
                         f"{tuple(values.shape)}")
    if segment_ids.shape != (values.shape[0],):
        raise ValueError(
            f"segment_sum: segment_ids must be ({values.shape[0]},), got "
            f"{tuple(segment_ids.shape)}"
        )
    if values.dtype not in _ENTRY:
        raise TypeError(f"segment_sum: values dtype {values.dtype}, need "
                        "float32 or bfloat16")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_sum: segment_ids dtype {segment_ids.dtype}, "
                        "need int32")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment_sum: values and segment_ids must be "
                         "contiguous")
    if int(num_segments) < 0:
        raise ValueError(f"segment_sum: num_segments={num_segments} < 0")


def segment_sum(
    values: torch.Tensor,  # (N, D) float32 or bfloat16
    segment_ids: torch.Tensor,  # (N,) int32
    num_segments: int,
) -> torch.Tensor:
    """``(num_segments, D)`` sums of the rows of ``values`` by id, in
    float32, cast back to the input dtype; ids outside ``[0,
    num_segments)`` are dropped, and ids need not be sorted.  Each kernel
    launch adds one to ``segment_sum.launches``."""
    if values.device.type == "cpu":
        return segment_sum_ref(values, segment_ids, num_segments)
    _check(values, segment_ids, num_segments)
    n, d = values.shape
    s = int(num_segments)
    out = torch.zeros((s, d), dtype=torch.float32, device=values.device)
    if n and d and s:
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _kernel(values.dtype)(
                values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
                n, d, s, stream,
            )
        if rc != 0:
            raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                               f"error {rc}")
        segment_sum.launches += 1
    return out.to(values.dtype)


segment_sum.launches = 0
