"""Multi-stage pipelines through the PyTorch port (``repro_torch``; no
jax): end-to-end cross-stage planning vs stagewise.

Real geo-analytics workloads are chains of MapReduce stages — one stage's
reduce output is the next stage's source data.  That extends the paper's
core argument (end-to-end beats myopic, per-phase control) across a new
axis: *where a stage's reducers sit decides where the next stage's data
starts from*.

The scenario: two sites, and the twist is in the *outgoing* links.

* node 0 hosts the fast reducer (300 MB/s vs node 1's 60 MB/s), but its
  outgoing push links crawl at 4 MB/s;
* node 1's reducer is slow, but its outgoing links run at wire speed.

A 3-stage chain (6 GB ingest -> transform -> aggregate) planned
``stagewise`` places each stage's reduce output on the fast reducer —
locally optimal, and it strands the next stage's entire input behind the
4 MB/s links.  ``end_to_end`` optimizes all stages' push and shuffle
fractions in one solve on ``--device``, with gradients flowing through the
inter-stage coupling (downstream D is a function of upstream y): it
concedes reduce speed on the non-final stages to keep their output on the
well-connected node, and only the sink stage uses the fast reducer.

Both plans then actually run on the chunk-granular executor, where a
downstream stage's push chunks at source node s release only when the
upstream reduce output destined for s lands.

    PYTHONPATH=src python examples/port_pipeline.py
    PYTHONPATH=src python examples/port_pipeline.py --device cpu

Every solve runs on ``--device`` (default ``cuda``).
"""
import argparse

import numpy as np

from repro_torch.api import GeoJob, GeoPipeline
from repro_torch.core import BARRIERS_GGL, Substrate
from repro_torch.core.optimize import available_pipeline_modes

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

OPT = dict(n_restarts=8, steps=250)

substrate = Substrate(
    B_sm=np.array([[4.0, 4.0],        # node 0: fast reducer, dead-slow exit
                   [200.0, 200.0]]),  # node 1: slow reducer, fast exit
    B_mr=np.full((2, 2), 200.0),
    C_m=np.array([100.0, 100.0]),
    C_r=np.array([300.0, 60.0]),
    cluster_s=np.array([0, 1]),
    cluster_m=np.array([0, 1]),
    cluster_r=np.array([0, 1]),
    name="pipeline_pair",
)
print(substrate.describe())
print("registered pipeline planners:",
      ", ".join(available_pipeline_modes()))


def stages():
    """6 GB at the well-connected node; downstream stages' D is derived
    from the upstream plans (their views start empty)."""
    return [
        GeoJob(substrate.view(np.array([0.0, 6000.0]), 1.0, name="ingest")),
        GeoJob(substrate.view(np.zeros(2), 1.0, name="transform")),
        GeoJob(substrate.view(np.zeros(2), 0.5, name="aggregate")),
    ]


print(f"\n{'mode':11s} {'modeled':>9s} {'simulated':>9s}  "
      "reduce split per stage (r0, r1)")
reports = {}
for mode in ("stagewise", "end_to_end"):
    report = (
        GeoPipeline(stages(), name=f"chain_{mode}", device=args.device)
        .plan(mode, stage_mode="e2e_multi", barriers=BARRIERS_GGL, **OPT)
        .simulate()
    )
    reports[mode] = report
    splits = "  ".join(
        f"({p.y[0]:.2f}, {p.y[1]:.2f})" for p in report.plans
    )
    print(f"{mode:11s} {report.makespan_modeled:8.0f}s "
          f"{report.makespan_sim:8.0f}s  {splits}")

sw, e2e = reports["stagewise"], reports["end_to_end"]
print(f"\nstagewise strands stage k+1's input behind node 0's 4 MB/s "
      f"links;\nend-to-end planning cuts the simulated pipeline makespan "
      f"by {1 - e2e.makespan_sim / sw.makespan_sim:.0%}.")
print("\nper-stage start/finish (end_to_end, modeled):")
for k, (t0, t1) in enumerate(zip(e2e.result.starts, e2e.result.finishes)):
    print(f"  stage {k}: {t0:7.1f}s -> {t1:7.1f}s")
print("\n" + e2e.summary())

assert e2e.makespan_modeled <= sw.makespan_modeled + 1e-9, \
    "end_to_end must never be modeled-worse (stagewise competes)"
assert 1 - e2e.makespan_sim / sw.makespan_sim >= 0.20, \
    "expected a >=20% simulated win on this scenario"
