"""Plain PyTorch versions of the port's kernels.

They run on any device and define what each kernel computes: the CPU
tests hold them against :mod:`repro.kernels.ref`, and on the card the
kernels are held against them.  They repeat the kernels' arithmetic and are
no yardstick of speed.
"""
from __future__ import annotations

import torch

__all__ = ["segment_sum_ref"]


def segment_sum_ref(
    values: torch.Tensor,  # (N, D)
    segment_ids: torch.Tensor,  # (N,) integer ids, sorted or not
    num_segments: int,
) -> torch.Tensor:
    """Segment sum — the MapReduce combiner/reducer primitive: row ``n`` of
    ``values`` is added into row ``segment_ids[n]`` of the ``(num_segments,
    D)`` output.  Sums are taken in float32 and cast back to the input
    dtype; ids outside ``[0, num_segments)`` are dropped."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    out.index_add_(0, ids[keep], values[keep].float())
    return out.to(values.dtype)
