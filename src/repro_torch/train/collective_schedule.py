"""Plan-driven hierarchical cross-pod all-reduce —
:mod:`repro.train.collective_schedule` with its ``shard_map`` written out
as collectives on the mesh dims' process groups.

This is the runnable counterpart of :mod:`repro_torch.core.collective_plan`:
the planner chooses non-uniform per-pod segment ownership for the slow
inter-pod hop; this module executes the schedule on a ``(pod, data, ...)``
mesh:

  1. intra-pod reduce-scatter over the 'data' dim,
  2. cross-pod all-reduce over the 'pod' dim,
  3. intra-pod all-gather over 'data'.

On homogeneous fabrics the planned segments are uniform and this is exactly
the classic hierarchical all-reduce (each gradient byte crosses the slow
hop once instead of data_parallel_degree times).  ``segment_sizes`` is
taken and not read, as in the reference: its pod all-reduce runs once over
the whole scattered chunk.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..models.model import _tree_map

__all__ = ["hierarchical_allreduce", "flat_size"]


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda _, a: out.append(a), tree)
    return out


def flat_size(tree) -> int:
    return int(sum(math.prod(a.shape) for a in _leaves(tree)))


def hierarchical_allreduce(
    tree,
    mesh,
    segment_sizes: Sequence[int] | None = None,
    mean: bool = True,
):
    """All-reduce a tree (dicts of tensors) over ('pod', 'data') with the
    hierarchical schedule: every rank passes its own tree and gets the sum
    (``mean``: the mean) of the trees of its (pod, data) group, in float32.
    ``segment_sizes`` — per-pod planned ownership (from
    ``plan_cross_pod_reduction``); unread, as in the reference.

    The tree is flattened to one float32 vector, padded to pod×data
    divisibility, reduced, and unflattened — matching how fused gradient
    buckets work in production trainers.  The flat vector and the
    gathered result are each a copy of the tree."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names
    if "pod" not in names or "data" not in names:
        raise ValueError(f"hierarchical_allreduce needs a mesh with 'pod' "
                         f"and 'data' dims, got {names}")
    n_pod = mesh.size(names.index("pod"))
    n_data = mesh.size(names.index("data"))
    leaves = _leaves(tree)
    n = sum(a.numel() for a in leaves)
    npad = (-n) % (n_pod * n_data)
    device = leaves[0].device
    flat = torch.cat([a.reshape(-1).float() for a in leaves]
                     + [torch.zeros(npad, device=device)])
    denom = float(n_pod * n_data) if mean else 1.0

    # 1. intra-pod reduce-scatter over 'data': chunk i of the flat vector,
    #    summed over the pod's data ranks, lands on data rank i
    chunk = torch.empty(flat.numel() // n_data, device=device)
    dist.reduce_scatter_tensor(chunk, flat, group=mesh.get_group("data"))
    del flat
    # 2. cross-pod reduction of the scattered chunk
    dist.all_reduce(chunk, group=mesh.get_group("pod"))
    # 3. intra-pod all-gather over 'data'
    reduced = torch.empty(chunk.numel() * n_data, device=device)
    dist.all_gather_into_tensor(reduced, chunk, group=mesh.get_group("data"))
    del chunk
    if denom != 1.0:
        reduced.div_(denom)
    offset = [0]

    def take(_, a):
        out = reduced[offset[0]:offset[0] + a.numel()].view(a.shape)
        offset[0] += a.numel()
        return out

    return _tree_map(take, tree)
