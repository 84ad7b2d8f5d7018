"""Public ops layer: the entry points the MapReduce engine calls.

``sorted_segment_sum`` launches the Hopper kernel for a CUDA tensor at any
size: the reference's ``_MIN_KERNEL_SEQ`` threshold was about the TPU
kernel's grid overhead and does not carry over.  For a tensor on the CPU,
or with ``use_kernel=False``, it computes the plain version.
"""
from __future__ import annotations

from . import ref
from .segment_reduce import segment_sum

__all__ = ["sorted_segment_sum"]


def sorted_segment_sum(values, segment_ids, num_segments: int,
                       use_kernel: bool = True):
    if use_kernel:
        return segment_sum(values, segment_ids, num_segments)
    return ref.segment_sum_ref(values, segment_ids, num_segments)
