"""Segment sum on Hopper — the MapReduce combiner/reducer primitive.

Replaces the TPU kernel :func:`repro.kernels.segment_reduce._segsum_kernel`
(a one-hot ``Pᵀ @ values`` MXU matmul per row block) with the hand-written
CUDA C++ kernel ``csrc/segment_sum.cu`` for ``sm_90a``.  The kernel is
bound by bytes on the H100: it reads the rows once, coalesced, sums each
run of equal ids in registers and across a warp's lanes, and adds a run's
total into the float32 output with one atomic where the run ends, which
also takes any id order; see the note in the source.

``num_segments`` is a run-time integer, not a compile-time constant: word
count passes each reducer's count of unique keys.  For a tensor on the CPU
the wrapper computes the plain version :func:`repro_torch.kernels.ref.
segment_sum_ref`; for a CUDA tensor it launches the kernel or raises.  The
wrapper crosses into C once per call: the C entry zero-fills the output
on the caller's stream before its launch.  It enters no device context:
the tensors must be on the current device, or the wrapper raises.
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
    current = torch.cuda.current_device()
    if values.get_device() != current:
        raise ValueError(f"segment_sum: values on {values.device}, the current "
                         f"device is cuda:{current}: call under "
                         f"torch.cuda.device({values.device})")


def segment_sum(
    values: torch.Tensor,  # (N, D) float32 or bfloat16
    segment_ids: torch.Tensor,  # (N,) int32
    num_segments: int,
) -> torch.Tensor:
    """``(num_segments, D)`` sums of the rows of ``values`` by id, in
    float32, cast back to the input dtype; ids outside ``[0,
    num_segments)`` are dropped, and ids need not be sorted.  Each kernel
    launch adds one to ``segment_sum.launches``."""
    if not values.is_cuda:
        if values.device.type == "cpu":
            return segment_sum_ref(values, segment_ids, num_segments)
        _check(values, segment_ids, num_segments)  # raises: not cuda
    # the host's cost of a call is most of the call at the main path's
    # sizes: every check of _check in one expression of cheap accessors,
    # and _check, which names the fault, only where one fails
    dtype = values.dtype
    s = int(num_segments)
    index = values.get_device()
    if not (dtype in _ENTRY and segment_ids.dtype == torch.int32
            and values.dim() == 2 and segment_ids.dim() == 1
            and segment_ids.get_device() == index
            and index == torch._C._cuda_getDevice() and s >= 0
            and values.is_contiguous() and segment_ids.is_contiguous()
            and segment_ids.size(0) == values.size(0)):
        _check(values, segment_ids, num_segments)
    n, d = values.shape
    # empty_strided: no memory-format argument for the host to resolve
    out = torch.empty_strided((s, d), (d, 1), dtype=torch.float32,
                              device=values.device)
    if s and d:
        # the raw stream pointer: torch.cuda.current_stream(...).cuda_stream
        # builds a Stream object on every call, a cost the host pays at
        # every reducer
        rc = _kernel(dtype)(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), n, d, s,
            torch._C._cuda_getCurrentRawStream(index),
        )
        if rc != 0:
            raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                               f"error {rc}")
        if n:
            segment_sum.launches += 1
    return out if dtype == torch.float32 else out.to(dtype)


segment_sum.launches = 0
