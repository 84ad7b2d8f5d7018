"""MoE dispatch planning — the paper's shuffle optimization applied to
token→expert all-to-all: :mod:`repro.core.moe_plan` on torch, the same text
with a ``device=`` keyword that the solve runs on (default: the process
default, the card).

A Mixture-of-Experts layer routes every token to its top-k experts.  Under
expert parallelism the experts live on different devices (possibly different
*pods*), so routing is an all-to-all over heterogeneous links: intra-pod ICI
vs inter-pod DCN.  The correspondence to the paper is exact:

* data sources / mappers = the data-parallel token shards (router output),
* reducers              = expert shards,
* the one-reducer-per-key constraint = one-*expert*-per-token-assignment:
  every token assigned to expert ``e`` must reach the shard hosting ``e``,
* ``alpha``             = top_k (each token's hidden vector is replicated to
  k experts),
* ``y_k``               = fraction of router probability mass the planner
  *biases* toward expert group ``k``.

The planner cannot change which expert a token semantically wants — but MoE
routers are trained with load-balancing auxiliary losses and capacity
factors, and production systems bias routing for systems reasons.  The plan
is exported as **per-expert-group capacity fractions**: the MoE layer turns
them into per-expert capacity and an additive router bias, keeping hot
experts on well-connected shards busy and starving experts behind slow DCN
links.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .._device import DeviceLike
from .makespan import BARRIERS_ALL_PIPELINED, makespan
from .optimize import optimize_plan
from .plan import ExecutionPlan
from .platform import Platform

__all__ = ["MoEDispatchPlan", "plan_moe_dispatch", "moe_platform"]


@dataclasses.dataclass(frozen=True)
class MoEDispatchPlan:
    """``group_fractions[g]`` — planned share of routed tokens for expert
    group ``g``; ``capacity_factor[g]`` — multiplier on the uniform
    per-group capacity; ``router_bias[g]`` — additive log-bias implementing
    the plan in a trained router; ``est_time_s`` / ``uniform_time_s`` —
    modeled all-to-all times."""

    group_fractions: np.ndarray
    capacity_factor: np.ndarray
    router_bias: np.ndarray
    est_time_s: float
    uniform_time_s: float

    @property
    def speedup_vs_uniform(self) -> float:
        return self.uniform_time_s / max(self.est_time_s, 1e-12)


def moe_platform(
    tokens_mb_per_shard: float,
    n_token_shards: int,
    group_pod: Sequence[int],
    shard_pod: Sequence[int],
    top_k: int = 1,
    ici_bw_mbps: float = 50_000.0,
    dcn_bw_mbps: float = 6_400.0,
    expert_flops_rate_mbps: float = 25_000.0,
) -> Platform:
    """Build the tripartite platform for one MoE dispatch.

    ``shard_pod[i]`` — pod of token shard ``i``; ``group_pod[g]`` — pod of
    expert group ``g``.  Push is the router itself (device-local, fast);
    shuffle is the dispatch all-to-all; reduce is expert FFN compute.
    """
    shard_pod = np.asarray(shard_pod)
    group_pod = np.asarray(group_pod)
    nS = n_token_shards
    nG = group_pod.shape[0]
    # push: token shards "push" to themselves (router is local) — model as a
    # near-infinite diagonal so the push phase is negligible.
    B_sm = np.full((nS, nS), 1e9)
    # dispatch all-to-all: a shard's egress NIC is shared across the remote
    # groups it feeds (same per-link sharing note as collective_plan).
    n_remote = np.array(
        [max(int((group_pod != shard_pod[j]).sum()), 1) for j in range(nS)]
    )
    B_mr = np.empty((nS, nG))
    for j in range(nS):
        for g in range(nG):
            B_mr[j, g] = (
                ici_bw_mbps
                if shard_pod[j] == group_pod[g]
                else dcn_bw_mbps / n_remote[j]
            )
    rate = np.broadcast_to(
        np.asarray(expert_flops_rate_mbps, dtype=np.float64), (nG,)
    ).copy()
    return Platform(
        D=np.full(nS, tokens_mb_per_shard),
        B_sm=B_sm,
        B_mr=B_mr,
        C_m=np.full(nS, 1e9),  # router cost negligible
        C_r=rate,
        alpha=float(top_k),
        cluster_s=shard_pod.copy(),
        cluster_m=shard_pod.copy(),
        cluster_r=group_pod.copy(),
        name=f"moe_dispatch_{nG}groups",
    )


def plan_moe_dispatch(
    tokens_mb_per_shard: float,
    n_token_shards: int,
    group_pod: Sequence[int],
    shard_pod: Sequence[int],
    top_k: int = 1,
    ici_bw_mbps: float = 50_000.0,
    dcn_bw_mbps: float = 6_400.0,
    expert_flops_rate_mbps=25_000.0,
    max_capacity_factor: float = 2.0,
    n_restarts: int = 8,
    steps: int = 300,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
) -> MoEDispatchPlan:
    """Plan expert-group token fractions minimizing dispatch+compute time."""
    platform = moe_platform(
        tokens_mb_per_shard,
        n_token_shards,
        group_pod,
        shard_pod,
        top_k,
        ici_bw_mbps,
        dcn_bw_mbps,
        expert_flops_rate_mbps,
    )
    nG = platform.nR
    x = np.eye(n_token_shards)
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
    y = res.plan.y.copy()
    uniform = np.full(nG, 1.0 / nG)
    # cap the skew: an expert group can absorb at most max_capacity_factor ×
    # its uniform share (routers cannot be biased arbitrarily without
    # quality loss).  Water-fill: cap, redistribute the excess among the
    # uncapped groups proportionally, repeat until stable.
    cap_val = max_capacity_factor / nG
    for _ in range(nG):
        over = y > cap_val + 1e-12
        if not over.any():
            break
        excess = float((y[over] - cap_val).sum())
        y[over] = cap_val
        free = ~over
        if not free.any():
            y = np.full(nG, 1.0 / nG)
            break
        y[free] += excess * y[free] / max(y[free].sum(), 1e-12)
    y = y / y.sum()
    est = makespan(platform, ExecutionPlan(x=x, y=y), BARRIERS_ALL_PIPELINED)
    uni = makespan(
        platform, ExecutionPlan(x=x, y=uniform), BARRIERS_ALL_PIPELINED
    )
    if est > uni:
        y, est = uniform, uni
    cap = y / uniform
    bias = np.log(np.maximum(y, 1e-9)) - np.log(uniform)
    return MoEDispatchPlan(
        group_fractions=y,
        capacity_factor=cap,
        router_bias=bias,
        est_time_s=float(est),
        uniform_time_s=float(uni),
    )
