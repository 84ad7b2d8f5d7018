"""Online control plane through the PyTorch port (``repro_torch``; no jax):
progress-aware re-planning over streaming arrivals and drifting capacities.

The offline planner decides once, against a frozen view of the fabric — but
the world refuses to hold still.  This example puts the closed
plan→observe→re-plan loop on the spot with the two disturbances a
geo-distributed scheduler actually faces:

* a **capacity drift**: both backbone shuffle links into the fast reducer
  r0 degrade 250x at t=105s, mid-shuffle of the running job (a
  :class:`repro_torch.core.platform.CapacityTrace` the planner does not know);
* a **streaming arrival**: a second job turns up at t=50s, mid-map, known
  to nobody at t=0 (except the clairvoyant frozen baseline, which still
  loses).

The frozen joint plan — offline-optimal, even told the arrival's release
time in advance — pushes its residual shuffle through the collapsed links
and crawls.  The ``reactive`` policy pauses the executor at each event,
snapshots every job's *residual* work, re-plans it against the capacities
then in force (``Substrate.at(t)``, warm-started from the incumbent plan),
and swaps the not-yet-committed chunks onto the healthy path.

Part 2 then shows where ``reactive`` itself turns myopic: each
job's residual is re-planned *solo*, so concurrent jobs spill onto the
same resources.  ``reactive_shared`` co-replans every live residual
jointly through shared-capacity pricing and charges each swap its replan
cost (``OnlineConfig.hysteresis``), beating both the frozen joint plan
and solo-residual re-planning with fewer accepted swaps than
hysteresis-free co-replanning.

    PYTHONPATH=src python examples/port_online.py
    PYTHONPATH=src python examples/port_online.py --device cpu

Every solve runs on ``--device`` (default ``cuda``).  ``reactive_incremental``
charges each swap the MEASURED solve time (a first-call-excluded EMA of
the device's solves, each timed between two device synchronizations), so
its line depends on how fast ``--device`` solves; every other line pins or
needs no charge and does not.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import Arrival, GeoJob, GeoSchedule, OnlineConfig
from repro_torch.core import (
    BARRIERS_GGL,
    CapacityTrace,
    SimConfig,
    Substrate,
    available_online_policies,
    simulate_schedule,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

OPT = dict(n_restarts=8, steps=250)

substrate = Substrate(
    B_sm=np.full((2, 2), 200.0),
    B_mr=np.array([[500.0, 100.0],   # backbone links into r0 are the fast path
                   [500.0, 100.0]]),
    C_m=np.array([100.0, 100.0]),
    C_r=np.array([2000.0, 2000.0]),
    cluster_s=np.array([0, 1]),
    cluster_m=np.array([0, 1]),
    cluster_r=np.array([0, 1]),
    name="online_pair",
).with_traces({
    # ... until they collapse to 2 MB/s at t=105s, mid-shuffle
    "shuffle[m0->r0]": CapacityTrace.step(500.0, 2.0, 105.0),
    "shuffle[m1->r0]": CapacityTrace.step(500.0, 2.0, 105.0),
})
print(substrate.describe())
print("registered online policies:", ", ".join(available_online_policies()))

steady = GeoJob(substrate.view(np.array([8000.0, 8000.0]), 1.0, name="steady"),
                device=args.device)
late_view = substrate.view(np.array([4000.0, 4000.0]), 1.0, name="late")
cfg = SimConfig(barriers=BARRIERS_GGL)
t_arrival = 50.0

# ---------------------------------------------------------------------------
# the frozen baseline: everything planned jointly offline — it even knows the
# arrival's release time — but against the NOMINAL capacities
# ---------------------------------------------------------------------------
frozen = GeoSchedule([steady, GeoJob(late_view, device=args.device)],
                     device=args.device).plan(
    "joint", mode="e2e_multi", barriers=BARRIERS_GGL, **OPT
)
frozen_sim = simulate_schedule(
    [(steady.platform, frozen.planned.plans[0], cfg),
     (late_view, frozen.planned.plans[1],
      dataclasses.replace(cfg, start_time=t_arrival))],
    substrate=substrate,
)
print(f"\nfrozen joint plan (clairvoyant offline): "
      f"{frozen_sim.makespan:8.0f}s aggregate")

# ---------------------------------------------------------------------------
# the online loop: plan -> observe -> re-plan
# ---------------------------------------------------------------------------
sched = GeoSchedule([steady], device=args.device).plan(
    "independent", mode="e2e_multi", barriers=BARRIERS_GGL, **OPT
)
print(f"\n{'policy':10s} {'online':>9s} {'vs frozen':>10s}  decisions")
reports = {}
for policy, extra in (("static", {}), ("reactive", {}),
                      ("horizon", {"replan_dt": 40.0})):
    arrival = Arrival(
        GeoJob(late_view, device=args.device).with_plan(
            frozen.planned.plans[1], BARRIERS_GGL),
        t_arrival,
    )
    report = sched.run_online(policy=policy, arrivals=[arrival], cfg=cfg,
                              **OPT, **extra)
    reports[policy] = report
    gain = 1 - report.makespan_online / frozen_sim.makespan
    print(f"{policy:10s} {report.makespan_online:8.0f}s {gain:9.0%}  "
          f"{len(report.swaps)} swaps / {len(report.decisions)} decisions")

reactive = reports["reactive"]
print("\nreactive decision timeline (modeled remaining seconds):")
print(reactive.timeline())
print(f"\nreactive re-planning beats the frozen joint plan by "
      f"{1 - reactive.makespan_online / frozen_sim.makespan:.0%} "
      f"({frozen_sim.makespan:.0f}s -> {reactive.makespan_online:.0f}s).")
print(reactive.summary())

# ---------------------------------------------------------------------------
# part 2: solo-residual re-planning is schedule-myopic — co-replan instead
# ---------------------------------------------------------------------------
# Asymmetric reducer access: the steady job's mappers (m0/m1) reach both
# reducers, the late job's mappers (m2/m3) can only shuffle into r1 — the
# late job is STUCK on r1, a fact only shared-capacity pricing can see.
# When the fast reducer r0 degrades mid-shuffle (300 -> 40 MB/s), solo
# replanning balances the steady job's residual against the raw capacities
# and spills onto r1, right on top of the stuck job.  The two later trace
# steps on dead push links change nothing real — they only bait
# hysteresis-free re-planning into epsilon swaps (thrash).
shared_sub = Substrate(
    B_sm=np.array([
        [200.0, 200.0, 1.0, 1.0],
        [200.0, 200.0, 1.0, 1.0],
        [1.0, 1.0, 200.0, 200.0],
        [1.0, 1.0, 200.0, 200.0],
    ]),
    B_mr=np.array([
        [200.0, 200.0],
        [200.0, 200.0],
        [1.0, 200.0],
        [1.0, 200.0],
    ]),
    C_m=np.array([100.0, 100.0, 100.0, 100.0]),
    C_r=np.array([300.0, 60.0]),
    cluster_s=np.array([0, 0, 1, 1]),
    cluster_m=np.array([0, 0, 1, 1]),
    cluster_r=np.array([0, 1]),
    name="online_shared",
).with_traces({
    "reduce[r0]": CapacityTrace.step(300.0, 40.0, 110.0),
    "push[s0->m2]": CapacityTrace.step(1.0, 0.9, 150.0),   # nuisance
    "push[s1->m2]": CapacityTrace.step(1.0, 0.9, 180.0),   # nuisance
})
print("\n--- part 2: shared-capacity co-replanning with hysteresis ---")
print(shared_sub.describe())

steady2 = GeoJob(shared_sub.view(np.array([8000.0, 8000.0, 0.0, 0.0]), 1.0,
                                 name="steady"), device=args.device)
stuck_view = shared_sub.view(np.array([0.0, 0.0, 6000.0, 6000.0]), 1.0,
                             name="late")

frozen2 = GeoSchedule([steady2, GeoJob(stuck_view, device=args.device)],
                      device=args.device).plan(
    "joint", mode="e2e_multi", barriers=BARRIERS_GGL, **OPT
)
frozen2_sim = simulate_schedule(
    [(steady2.platform, frozen2.planned.plans[0], cfg),
     (stuck_view, frozen2.planned.plans[1],
      dataclasses.replace(cfg, start_time=t_arrival))],
    substrate=shared_sub,
)
print(f"\nfrozen joint plan (clairvoyant offline): "
      f"{frozen2_sim.makespan:8.0f}s aggregate")

sched2 = GeoSchedule([steady2], device=args.device).plan(
    "independent", mode="e2e_multi", barriers=BARRIERS_GGL, **OPT
)
print(f"\n{'variant':22s} {'online':>9s} {'vs frozen':>10s}  "
      "swaps/rejected/decisions")
reports2 = {}
for name, policy, online in (
    ("reactive (solo)", "reactive", None),
    # solver_cost_s pinned: the hysteresis narrative below is about the
    # gate, and the MEASURED charge (the default, a first-call-excluded
    # EMA of observed solve time) depends on how fast the device solves
    ("reactive_shared", "reactive_shared",
     OnlineConfig(shared=True, hysteresis=1.0, solver_cost_s=1.0)),
    ("shared, no hysteresis", "reactive_shared",
     OnlineConfig(shared=True, hysteresis=0.0)),
    # warm-started incremental re-solves + the measured charge
    ("reactive_incremental", "reactive_incremental", None),
):
    arrival = Arrival(
        GeoJob(stuck_view, device=args.device).with_plan(
            frozen2.planned.plans[1], BARRIERS_GGL),
        t_arrival,
    )
    report = sched2.run_online(policy=policy, arrivals=[arrival], cfg=cfg,
                               online=online, **OPT)
    reports2[name] = report
    gain = 1 - report.makespan_online / frozen2_sim.makespan
    print(f"{name:22s} {report.makespan_online:8.0f}s {gain:9.0%}  "
          f"{len(report.swaps)}/{len(report.rejected)}"
          f"/{len(report.decisions)}")

shared = reports2["reactive_shared"]
solo = reports2["reactive (solo)"]
nohyst = reports2["shared, no hysteresis"]
print("\nreactive_shared decision timeline (modeled remaining seconds):")
print(shared.timeline())
print(f"\nco-replanning beats the frozen joint plan by "
      f"{1 - shared.makespan_online / frozen2_sim.makespan:.0%} and "
      f"solo-residual reactive by "
      f"{1 - shared.makespan_online / solo.makespan_online:.0%}, "
      f"accepting {len(shared.swaps)} swaps vs "
      f"{len(nohyst.swaps)} without hysteresis "
      f"({len(shared.rejected)} rejected, "
      f"{shared.charged_s:.0f}s charged).")
print(shared.summary())
