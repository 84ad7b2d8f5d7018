"""Planner-as-a-service through the PyTorch port (``repro_torch``; no jax):
batched solves, the shape-keyed solver counters, and incremental
warm-start replans.

A control plane that plans for a fleet doesn't solve one problem and exit —
it fields a *stream* of requests: new jobs arriving (same substrate, new
volumes), periodic residual re-plans, the occasional novel topology.  Three
properties make that cheap:

* **the solver key** — solves are keyed by problem shape + static config,
  process-wide.  Torch runs eagerly, so there is no executable to cache:
  the first request of a key in the process is its "compile" (on the card,
  the CUDA context and cuBLAS set-up of the solver's first launches), and
  every later request of that key (any volumes, any seed, any
  :class:`~repro_torch.api.GeoSchedule`) is a hit.
* **batched solves** — N concurrent same-shape requests are stacked into
  ONE batched solve on ``--device``, so the per-call Python and launch
  overhead is paid once.
* **incremental replans** — when an incumbent plan exists, a short
  low-temperature polish from the incumbent's logits replaces the full
  annealed re-solve; the incumbent competes in the final f64 pricing, so
  the result is never modeled worse than keeping it.

    PYTHONPATH=src python examples/port_planner_service.py
    PYTHONPATH=src python examples/port_planner_service.py --device cpu

Every solve runs on ``--device`` (default ``cuda``); each timing reads the
host clock only after the device has finished its queued work.
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device, synchronize
from repro_torch.core import SolverService, solver_cache_stats
from repro_torch.core.makespan import BARRIERS_GGL
from repro_torch.core.platform import planetlab_platform

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()
device = resolve_device(args.device)

OPT = dict(n_restarts=8, steps=150)

svc = SolverService(mode="e2e_multi", barriers=BARRIERS_GGL, device=device,
                    **OPT)


def timed(label, fn):
    before = solver_cache_stats()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    dt = time.perf_counter() - t0
    after = solver_cache_stats()
    print(f"{label:42s} {dt * 1e3:9.1f} ms   "
          f"+{after['compiles'] - before['compiles']} compiles, "
          f"+{after['hits'] - before['hits']} cache hits")
    return out, dt


# ---------------------------------------------------------------------------
# 1. cold vs warm: the first request of a key pays the set-up
# ---------------------------------------------------------------------------
print("--- request stream against one problem shape (8-node planetlab) ---")
cold_res, cold = timed(
    "cold  (first request of the key)",
    lambda: svc.plan(planetlab_platform(8, alpha=1.0, seed=0), seed=0),
)
_, warm = timed(
    "warm  (new volumes, same shape)",
    lambda: svc.plan(planetlab_platform(8, alpha=1.3, seed=1), seed=1),
)
print(f"{'':42s} -> warm request is {cold / warm:.0f}x faster\n")

# ---------------------------------------------------------------------------
# 2. batching: 8 concurrent requests, one batched solve
# ---------------------------------------------------------------------------
fleet = [planetlab_platform(8, alpha=a, seed=s)
         for s, a in enumerate((0.5, 0.8, 1.0, 1.2, 1.5, 1.8, 2.0, 2.5))]
seeds = list(range(8))
svc.plan_many(fleet, seeds=seeds)          # first call of the batch-of-8 key
batch, t_batch = timed(
    f"batch ({len(fleet)} requests, one solve)",
    lambda: svc.plan_many(fleet, seeds=seeds),
)
_, t_seq = timed(
    f"sequential ({len(fleet)} warm requests)",
    lambda: [svc.plan(p, seed=s) for p, s in zip(fleet, seeds)],
)
print(f"{'':42s} -> {len(fleet) / t_batch:.0f} plans/s batched "
      f"vs {len(fleet) / t_seq:.0f} plans/s sequential\n")

# ---------------------------------------------------------------------------
# 3. incremental replans: polish the incumbent instead of re-solving
# ---------------------------------------------------------------------------
print("--- mid-flight residual replans for the fleet ---")
incumbents = [r.plan for r in batch]
# first calls of both replan keys up front — we're comparing solve time
svc.replan_many(fleet, incumbents, seeds=seeds)
svc.replan_many(fleet, incumbents, seeds=seeds, incremental=True)
full, t_full = timed(
    "full re-solve (fresh anneal)",
    lambda: svc.replan_many(fleet, incumbents, seeds=seeds),
)
inc, t_inc = timed(
    "incremental (warm-start polish)",
    lambda: svc.replan_many(fleet, incumbents, seeds=seeds, incremental=True),
)
worse = sum(i.makespan > b.makespan + 1e-9 for i, b in zip(inc, batch))
print(f"{'':42s} -> {t_full / t_inc:.1f}x faster, "
      f"{worse}/{len(fleet)} modeled worse than the incumbent "
      "(never-worse by construction)\n")

spans = np.array([r.makespan for r in inc])
print(f"fleet replan makespans: {np.min(spans):.0f}..{np.max(spans):.0f}s "
      f"(median {np.median(spans):.0f}s)")
print(f"solver counters: {solver_cache_stats()}")
print("online loops get all of this via policy='reactive_incremental' "
      "(shared co-replanning, hysteresis gated by MEASURED solve time).")
