"""Multi-job scheduling through the PyTorch port (``repro_torch``; no jax):
two concurrent jobs on one shared substrate.

The paper's core claim — end-to-end optimization beats myopic, per-phase
control — extends across *jobs* once the platform is shared: planning each
job as if it were alone ("independent", the per-job-myopic baseline) can
pile every job onto the same fast links and nodes, while planning them
together ("joint") routes around each other's demand.

The scenario: a two-mapper substrate where

* job A ("pinned") can only reach mapper 0 quickly — its source's link to
  mapper 1 is dead slow (1 MB/s vs 10 GB/s);
* job B ("flexible") reaches both mappers at full speed, so its *solo*
  optimum splits evenly across them — straight onto A's only mapper.

Planned independently, both jobs contend for mapper 0 and the schedule
drags; planned jointly (or greedily in sequence), job B cedes mapper 0 to
the job that has no alternative.  Every policy is solved on ``--device``,
priced by the same shared-capacity float64 cost model the single-job path
uses, and then actually executed — concurrently, with real contention — on
the chunk-granular discrete-event executor.

    PYTHONPATH=src python examples/port_multijob.py
    PYTHONPATH=src python examples/port_multijob.py --device cpu

Every solve runs on ``--device`` (default ``cuda``).
"""
import argparse

import numpy as np

from repro_torch.api import GeoJob, GeoSchedule
from repro_torch.core import BARRIERS_GGL, Substrate
from repro_torch.core.optimize import available_policies

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

substrate = Substrate(
    B_sm=np.array([[10_000.0, 1.0],       # source 0: mapper 1 unreachable
                   [10_000.0, 10_000.0]]),  # source 1: anywhere
    B_mr=np.full((2, 2), 10_000.0),
    C_m=np.array([50.0, 50.0]),
    C_r=np.array([10_000.0, 10_000.0]),
    cluster_s=np.array([0, 1]),
    cluster_m=np.array([0, 1]),
    cluster_r=np.array([0, 1]),
    name="shared_pair",
)
print(substrate.describe())
print("registered schedule policies:", ", ".join(available_policies()))

# two 40 GB jobs: A's data sits at source 0, B's at source 1 — same
# substrate entries, different slices (Substrate.view shares the arrays)
job_a = GeoJob(substrate.view(np.array([40_000.0, 0.0]), 1.0, name="pinned"),
               device=args.device)
job_b = GeoJob(substrate.view(np.array([0.0, 40_000.0]), 1.0, name="flexible"),
               device=args.device)

print(f"\n{'policy':13s} {'modeled':>9s} {'executed':>9s}  "
      f"B's push split (m0, m1)")
reports = {}
for policy in ("independent", "sequential", "joint"):
    report = (
        GeoSchedule([job_a, job_b], device=args.device)
        .plan(policy=policy, mode="e2e_multi", barriers=BARRIERS_GGL,
              n_restarts=8, steps=250)
        .simulate()
    )
    reports[policy] = report
    m0, m1 = report.plans[1].x[1]
    print(f"{policy:13s} {report.makespan_modeled:8.0f}s "
          f"{report.makespan_sim:8.0f}s  ({m0:.2f}, {m1:.2f})")

indep, joint = reports["independent"], reports["joint"]
print(f"\njoint planning reduces the executed aggregate makespan by "
      f"{1 - joint.makespan_sim / indep.makespan_sim:.0%} vs per-job-myopic.")
print("hottest contended resources under the independent plans:")
util = indep.utilization()
for name in sorted(indep.contended(), key=lambda n: -util[n])[:3]:
    print(f"  {name}: {util[name]:.0%} busy over the schedule")
print("\n" + joint.summary())
