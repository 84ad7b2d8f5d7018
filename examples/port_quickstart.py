"""Quickstart through the PyTorch port (``repro_torch``; no jax): the
paper's whole loop through the job-level ``GeoJob`` API.

1. **model** a distributed platform (8 PlanetLab-derived data centers);
2. **plan** an execution plan with a registered planner mode
   (``repro_torch.core.optimize.available_modes()``): the paper's
   ``e2e_multi`` against two baselines, solved on ``--device``;
3. **execute** on the chunk-granular discrete-event executor
   (``job.simulate()``), priced by the same cost model as the plan.

    PYTHONPATH=src python examples/port_quickstart.py
    PYTHONPATH=src python examples/port_quickstart.py --device cpu

Every solve runs on ``--device`` (default ``cuda``).
"""
import argparse

import numpy as np

from repro_torch.api import GeoJob
from repro_torch.core import (
    BARRIERS_GGL, local_push_plan, planetlab_platform, uniform_plan,
)
from repro_torch.core.optimize import available_modes

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

# An 8-data-center, globally distributed platform with PlanetLab-measured
# bandwidth/compute heterogeneity; alpha=1 (e.g. a distributed sort).
platform = planetlab_platform(n_datacenters=8, alpha=1.0, seed=0)
print(platform.describe())
print("registered planner modes:", ", ".join(available_modes()))

setups = {
    "uniform": lambda j: j.with_plan(uniform_plan(platform), BARRIERS_GGL),
    "hadoop-locality": lambda j: j.with_plan(local_push_plan(platform), BARRIERS_GGL),
    "e2e-multi (paper)": lambda j: j.plan("e2e_multi", barriers=BARRIERS_GGL),
}

results = {}
print(f"\n{'plan':22s} {'model makespan':>15s} {'executed':>10s}  phases")
for name, setup in setups.items():
    job = setup(GeoJob(platform, device=args.device))
    results[name] = job.planned
    executed = job.simulate().makespan
    bd = results[name].breakdown
    phases = " ".join(f"{k}={bd[k]:.0f}s" for k in ("push", "map", "shuffle", "reduce"))
    print(f"{name:22s} {results[name].makespan:13.0f}s {executed:9.0f}s  {phases}")

best = results["e2e-multi (paper)"]
uni = results["uniform"]
print(f"\nend-to-end multi-phase plan reduces makespan by "
      f"{1 - best.makespan / uni.makespan:.0%} vs uniform "
      f"(paper reports 82-87% on its platform).")
print("optimized push matrix x (rows=sources, cols=mappers):")
print(np.round(best.plan.x, 2))
print("optimized shuffle fractions y:", np.round(best.plan.y, 3))
