"""Scale-tier substrate generation: 3-tier edge -> region -> backbone
topologies at 10^2-10^3 nodes, plus a seeded job-mix generator.

Every scenario the repo inherited from the paper is paper-sized (~8
nodes).  The geo-distributed MapReduce surveys motivate a different
shape for production claims: *many* weak edge sites feeding *regional*
datacenters over heterogeneous uplinks, with a small *backbone* tier
holding the reduce capacity.  This module generates such substrates
deterministically from a seed:

* **edge tier** — the sources.  Each edge node lives in a region and
  owns a log-uniform uplink; pushing inside its own region rides the
  region LAN, pushing across regions is capped by the thinner of the
  two regions' WAN uplinks.
* **region tier** — the mappers.  Each region holds a pool of map
  workers with heterogeneous compute rates and one WAN uplink toward
  the backbone.
* **backbone tier** — the reducers.  A few well-provisioned sites; the
  mapper->reducer capacity is the min of the region uplink and the
  backbone site's ingress, with per-pair jitter so no two paths tie.

All capacities are drawn log-uniformly (heterogeneity is the point:
uniform capacities produce the simultaneous-completion event storms a
scale-tier benchmark must *not* accidentally dodge, and exact float
ties that would race the executor's tie-break).

:func:`scale_job_mix` generates the matching workload: jobs with
region-local data footprints, sparse heuristic plans (each source
pushes over its best few links, shuffle lands on the best few
reducers), staggered release times and per-job alpha — directly
consumable by :func:`repro.core.simulate.simulate_schedule` or the
fluid engine.  Both generators are pure functions of their seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .plan import ExecutionPlan
from .platform import Platform, Substrate
from .simulate import SimConfig

__all__ = ["scale_job_mix", "scale_tier_substrate"]


def _log_uniform(rng: np.random.Generator, lo_hi: Tuple[float, float],
                 size) -> np.ndarray:
    lo, hi = float(lo_hi[0]), float(lo_hi[1])
    if not (0 < lo <= hi):
        raise ValueError(f"need 0 < lo <= hi, got ({lo}, {hi})")
    return np.exp(rng.uniform(np.log(lo), np.log(hi), size=size))


def scale_tier_substrate(
    n_regions: int = 4,
    edges_per_region: int = 12,
    mappers_per_region: int = 8,
    n_backbone: int = 2,
    reducers_per_backbone: int = 6,
    seed: int = 0,
    edge_up_mbps: Tuple[float, float] = (2.0, 20.0),
    lan_mbps: Tuple[float, float] = (60.0, 200.0),
    region_wan_mbps: Tuple[float, float] = (8.0, 48.0),
    backbone_mbps: Tuple[float, float] = (60.0, 240.0),
    map_rate: Tuple[float, float] = (20.0, 90.0),
    reduce_rate: Tuple[float, float] = (30.0, 120.0),
    name: Optional[str] = None,
) -> Substrate:
    """Generate a 3-tier substrate: ``n_regions * edges_per_region``
    sources, ``n_regions * mappers_per_region`` mappers and
    ``n_backbone * reducers_per_backbone`` reducers.

    Path capacities compose hierarchically: an edge->mapper path is
    ``min(edge uplink, region LAN)`` inside one region and
    ``min(edge uplink, both regions' WAN uplinks)`` across regions; a
    mapper->reducer path is ``min(region WAN uplink, backbone ingress)``
    with per-pair log-uniform jitter.  Deterministic in ``seed``.
    """
    if min(n_regions, edges_per_region, mappers_per_region,
           n_backbone, reducers_per_backbone) < 1:
        raise ValueError("every tier needs at least one node")
    rng = np.random.default_rng(seed)
    nS = n_regions * edges_per_region
    nM = n_regions * mappers_per_region
    nR = n_backbone * reducers_per_backbone

    region_s = np.repeat(np.arange(n_regions), edges_per_region)
    region_m = np.repeat(np.arange(n_regions), mappers_per_region)
    site_r = np.repeat(np.arange(n_backbone), reducers_per_backbone)

    edge_up = _log_uniform(rng, edge_up_mbps, nS)
    lan = _log_uniform(rng, lan_mbps, n_regions)
    region_wan = _log_uniform(rng, region_wan_mbps, n_regions)
    backbone_in = _log_uniform(rng, backbone_mbps, n_backbone)

    # edge -> mapper: LAN inside the region, min of both WAN uplinks across
    same = region_s[:, None] == region_m[None, :]
    inter = np.minimum(region_wan[region_s][:, None],
                       region_wan[region_m][None, :])
    path = np.where(same, lan[region_m][None, :], inter)
    B_sm = np.minimum(edge_up[:, None], path)
    B_sm = B_sm * _log_uniform(rng, (0.85, 1.18), (nS, nM))

    # mapper -> reducer: region WAN uplink capped by backbone ingress
    B_mr = np.minimum(region_wan[region_m][:, None],
                      backbone_in[site_r][None, :])
    B_mr = B_mr * _log_uniform(rng, (0.85, 1.18), (nM, nR))

    C_m = _log_uniform(rng, map_rate, nM)
    C_r = _log_uniform(rng, reduce_rate, nR)

    return Substrate(
        B_sm=B_sm, B_mr=B_mr, C_m=C_m, C_r=C_r,
        cluster_s=region_s, cluster_m=region_m,
        # backbone cluster ids offset past the regions so a reducer is
        # never mistaken for region-local by cluster-id comparisons
        cluster_r=site_r + n_regions,
        name=name or (
            f"scale[{n_regions}x{edges_per_region}e"
            f"+{n_regions}x{mappers_per_region}m"
            f"+{n_backbone}x{reducers_per_backbone}r seed={seed}]"
        ),
    )


def scale_job_mix(
    substrate: Substrate,
    n_jobs: int = 100,
    seed: int = 0,
    mb_per_job: Tuple[float, float] = (1500.0, 12000.0),
    sources_per_job: int = 3,
    push_fan: int = 2,
    reduce_fan: int = 3,
    alpha_range: Tuple[float, float] = (0.6, 1.4),
    arrival_spread_s: float = 0.0,
    base_cfg: Optional[SimConfig] = None,
) -> List[Tuple[Platform, ExecutionPlan, SimConfig]]:
    """Generate ``n_jobs`` jobs on ``substrate``: each picks a home
    region, places a log-uniform data footprint on a few of that
    region's edge nodes, and gets a *sparse* heuristic plan (every
    active source spreads over its ``push_fan`` best links,
    bandwidth-weighted; shuffle lands on the ``reduce_fan`` best
    reducers as seen from the chosen mappers, capacity-weighted).

    Returns ``(platform_view, plan, cfg)`` entries ready for
    :func:`repro.core.simulate.simulate_schedule`.  ``base_cfg`` seeds
    each job's :class:`SimConfig` (barriers, chunking, mode flags);
    release times are staggered uniformly over ``arrival_spread_s``.
    Deterministic in ``seed``.
    """
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    rng = np.random.default_rng(seed)
    cfg0 = base_cfg if base_cfg is not None else SimConfig()
    nS, nM, nR = substrate.nS, substrate.nM, substrate.nR
    B_sm = np.asarray(substrate.B_sm, dtype=np.float64)
    B_mr = np.asarray(substrate.B_mr, dtype=np.float64)
    C_r = np.asarray(substrate.C_r, dtype=np.float64)
    regions = np.asarray(substrate.cluster_s)
    region_ids = np.unique(regions)

    entries: List[Tuple[Platform, ExecutionPlan, SimConfig]] = []
    for n in range(n_jobs):
        home = int(rng.choice(region_ids))
        local = np.flatnonzero(regions == home)
        k_src = min(sources_per_job, local.size)
        srcs = np.sort(rng.choice(local, size=k_src, replace=False))

        total = float(_log_uniform(rng, mb_per_job, ()))
        split = rng.dirichlet(np.full(k_src, 3.0))
        D = np.zeros(nS)
        D[srcs] = total * split

        # push: each source spreads over its best few links, weighted by
        # bandwidth; inactive sources get a one-hot row (zero volume, but
        # Eq. 2 requires every row on the simplex)
        x = np.zeros((nS, nM))
        best = np.argmax(B_sm, axis=1)
        x[np.arange(nS), best] = 1.0
        used_mappers: set = set()
        for i in srcs:
            fan = min(push_fan, nM)
            top = np.argsort(B_sm[i])[::-1][:fan]
            w = B_sm[i, top]
            x[i] = 0.0
            x[i, top] = w / w.sum()
            used_mappers.update(int(j) for j in top)

        # shuffle: the best few reducers as seen from the mappers this job
        # actually uses, weighted by reduce capacity
        fan_r = min(reduce_fan, nR)
        mlist = sorted(used_mappers)
        reach = B_mr[mlist].mean(axis=0)
        top_r = np.argsort(reach * C_r)[::-1][:fan_r]
        y = np.zeros(nR)
        y[top_r] = C_r[top_r] / C_r[top_r].sum()

        alpha = float(rng.uniform(*alpha_range))
        start = float(rng.uniform(0.0, arrival_spread_s)) \
            if arrival_spread_s > 0 else 0.0
        cfg = dataclasses.replace(cfg0, start_time=start, seed=seed + n)
        platform = substrate.view(D, alpha, name=f"scale-job{n}")
        plan = ExecutionPlan(x=x, y=y, meta=f"scale_mix[{n}]")
        entries.append((platform, plan, cfg))
    return entries
