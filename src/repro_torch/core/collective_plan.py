"""Hierarchical multi-pod gradient aggregation, planned with the paper's
model — :mod:`repro.core.collective_plan` on torch: the same text, with a
``device=`` keyword that the solve runs on (default: the process default,
the card).

In multi-pod data parallelism the gradient all-reduce decomposes into

  push    : intra-pod reduce-scatter (ICI)   — every chip ends up with a
            1/N shard of the pod-local gradient sum,
  map     : local accumulation (free),
  shuffle : cross-pod reduction over DCN     — each *parameter segment* is
            reduced at exactly one owning pod (one-reducer-per-key!), then
  reduce  : the reduced segments are broadcast back (intra-pod all-gather).

The cross-pod stage is exactly the paper's shuffle: the key space is the
parameter index space, ``y_k`` is the fraction of parameters owned by pod
``k``, and heterogeneous per-pod DCN bandwidth makes non-uniform ownership
profitable.  This module plans ``y`` via :func:`repro_torch.core.optimize`'s
machinery and converts the result into concrete **segment sizes** (quantized
to TP-shard-aligned blocks) that the training step's collective schedule
(:mod:`repro_torch.train.collective_schedule`) consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .._device import DeviceLike
from .makespan import BARRIERS_ALL_PIPELINED
from .optimize import optimize_plan
from .plan import ExecutionPlan
from .platform import Platform

__all__ = ["ReductionPlan", "plan_cross_pod_reduction", "reduction_platform"]


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    """Cross-pod reduction ownership.

    ``fractions[k]`` — fraction of the flat parameter space pod ``k`` owns
    for the DCN reduction; ``segment_sizes`` — the same quantized to
    ``block`` elements, summing to ``n_elements``; ``est_time_s`` — modeled
    wall time of the full hierarchical all-reduce.
    """

    fractions: np.ndarray
    segment_sizes: np.ndarray
    n_elements: int
    block: int
    est_time_s: float
    uniform_time_s: float

    @property
    def speedup_vs_uniform(self) -> float:
        return self.uniform_time_s / max(self.est_time_s, 1e-12)

    def segment_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.segment_sizes)])


def reduction_platform(
    grad_mb: float,
    pod_dcn_bw_mbps: Sequence[float],
    ici_bw_mbps: float = 50_000.0,
    chips_per_pod: int = 256,
    accum_rate_mbps: float = 800_000.0,
) -> Platform:
    """Express one hierarchical all-reduce as a tripartite platform.

    Sources and mappers are pods (the intra-pod reduce-scatter feeds the
    pod's DCN egress), reducers are pods as segment owners.  ``D_i`` is the
    pod-local reduced gradient (``grad_mb``); push links model the intra-pod
    reduce-scatter bandwidth (ICI, scaled by the (N-1)/N ring factor);
    shuffle links model pod-to-pod DCN paths (bounded by the slower end's
    per-pod DCN bandwidth); compute rates model the reduction arithmetic
    (HBM-bound, effectively free relative to DCN).
    """
    bw = np.asarray(pod_dcn_bw_mbps, dtype=np.float64)
    P = bw.shape[0]
    ring = (chips_per_pod - 1) / chips_per_pod if chips_per_pod > 1 else 1.0
    # push: each pod feeds its own aggregation stage over ICI (x = I).
    B_sm = np.full((P, P), 1e-6)
    np.fill_diagonal(B_sm, ici_bw_mbps * ring)
    # shuffle: pod j ships the segment owned by pod k.  The sender's DCN NIC
    # is shared across its P-1 remote destinations (egress serialization) —
    # the per-link independence of the paper's model needs this division to
    # describe a NIC-bound fabric.
    B_mr = np.empty((P, P))
    for j in range(P):
        for k in range(P):
            B_mr[j, k] = (
                ici_bw_mbps * ring if j == k else bw[j] / max(P - 1, 1)
            )
    pods = np.arange(P)
    return Platform(
        D=np.full(P, grad_mb),
        B_sm=B_sm,
        B_mr=B_mr,
        C_m=np.full(P, accum_rate_mbps),
        # reduce = the owner ingesting P-1 remote contributions through its
        # own DCN NIC (ingress serialization) and accumulating.
        C_r=np.minimum(bw, accum_rate_mbps),
        alpha=1.0,
        cluster_s=pods,
        cluster_m=pods,
        cluster_r=pods,
        name=f"xpod_reduction_{P}pods",
    )


def plan_cross_pod_reduction(
    grad_mb: float,
    pod_dcn_bw_mbps: Sequence[float],
    n_elements: int,
    block: int = 512,
    ici_bw_mbps: float = 50_000.0,
    chips_per_pod: int = 256,
    n_restarts: int = 8,
    steps: int = 300,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
) -> ReductionPlan:
    """Plan non-uniform cross-pod segment ownership.

    With homogeneous DCN this reduces to uniform 1/P ownership; with
    heterogeneous per-pod DCN bandwidth (shared fabrics, degraded NICs,
    multi-tenant cells) the slower pods own proportionally less of the
    parameter space.
    """
    platform = reduction_platform(
        grad_mb, pod_dcn_bw_mbps, ici_bw_mbps, chips_per_pod
    )
    P = platform.nR
    # sources push their own gradient to their own aggregator: x = I.
    x = np.eye(P)
    res = optimize_plan(
        platform,
        mode="e2e_shuffle",
        barriers=BARRIERS_ALL_PIPELINED,
        n_restarts=n_restarts,
        steps=steps,
        seed=seed,
        fixed_x=x,
        device=device,
    )
    from .makespan import makespan

    plan = ExecutionPlan(x=x, y=res.plan.y, meta="xpod_reduction")
    uniform = ExecutionPlan(x=x, y=np.full(P, 1.0 / P), meta="uniform")
    est = makespan(platform, plan, BARRIERS_ALL_PIPELINED)
    uni = makespan(platform, uniform, BARRIERS_ALL_PIPELINED)
    if est > uni:  # never accept a plan worse than uniform ownership
        plan, est = uniform, uni

    # quantize fractions to block-aligned segment sizes summing exactly.
    n_blocks = max(n_elements // block, P)
    raw = plan.y * n_blocks
    sizes = np.floor(raw).astype(np.int64)
    remainder = int(n_blocks - sizes.sum())
    order = np.argsort(-(raw - sizes))
    for idx in order[:remainder]:
        sizes[idx] += 1
    seg = sizes * block
    seg[-1] += n_elements - int(seg.sum())  # absorb the tail
    return ReductionPlan(
        fractions=plan.y.copy(),
        segment_sizes=seg,
        n_elements=n_elements,
        block=block,
        est_time_s=float(est),
        uniform_time_s=float(uni),
    )
