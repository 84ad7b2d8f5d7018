"""Apply the paper's planner to multi-pod LM training decisions, through the
PyTorch port (``repro_torch``; no jax):

1. cross-pod gradient-reduction ownership under heterogeneous DCN,
   the plan the hierarchical all-reduce executes,
2. MoE dispatch capacity planning under heterogeneous expert shards,
3. geo-planned corpus ingest vs myopic nearest-source pulls.

    PYTHONPATH=src python examples/port_plan_multipod_training.py
    PYTHONPATH=src python examples/port_plan_multipod_training.py --device cpu

Every solve runs on ``--device`` (default ``cuda``).
"""
import argparse

import numpy as np

from repro_torch.api import GeoJob
from repro_torch.configs import get_config
from repro_torch.core.collective_plan import plan_cross_pod_reduction
from repro_torch.core.moe_plan import plan_moe_dispatch
from repro_torch.core.platform import tpu_pod_platform

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
ap.add_argument("--restarts", type=int, default=8)
ap.add_argument("--steps", type=int, default=300)
args = ap.parse_args()
solve = dict(n_restarts=args.restarts, steps=args.steps, device=args.device)

# --- 1. gradient reduction: pod 2's DCN is degraded to 25% --------------------
cfg = get_config("llama4-scout-17b-a16e")
grad_mb = cfg.n_params() * 4 / 1e6 / 256  # f32 grads, per-chip shard
rp = plan_cross_pod_reduction(
    grad_mb=grad_mb,
    pod_dcn_bw_mbps=[6400, 6400, 1600, 6400],
    n_elements=cfg.n_params() // 256,
    **solve,
)
print("[collective] hierarchical all-reduce, planned pod ownership:",
      np.round(rp.fractions, 3))
print(f"[collective] modeled reduction time {rp.est_time_s*1e3:.1f} ms "
      f"vs uniform {rp.uniform_time_s*1e3:.1f} ms "
      f"({rp.speedup_vs_uniform:.2f}x)")

# --- 2. MoE dispatch: one expert pod is throttled ------------------------------
mp = plan_moe_dispatch(
    tokens_mb_per_shard=64.0,
    n_token_shards=8,
    group_pod=[0, 0, 0, 0, 1, 1, 1, 1],
    shard_pod=[0, 0, 0, 0, 1, 1, 1, 1],
    top_k=1,
    expert_flops_rate_mbps=[25000] * 4 + [10000] * 4,
    **solve,
)
print("\n[moe] MoE dispatch, planned group fractions:",
      np.round(mp.group_fractions, 3))
print(f"[moe] dispatch+compute {mp.est_time_s*1e3:.1f} ms vs uniform "
      f"{mp.uniform_time_s*1e3:.1f} ms ({mp.speedup_vs_uniform:.2f}x)")
print("[moe] router bias to load at init:", np.round(mp.router_bias, 2))

# --- 3. corpus ingest ----------------------------------------------------------
platform = tpu_pod_platform(n_pods=4, hosts_per_pod=4, compute_jitter=0.4, seed=1)
e2e = GeoJob(platform, device=args.device).plan(
    "e2e_multi", n_restarts=args.restarts, steps=args.steps).planned
myo = GeoJob(platform, device=args.device).plan(
    "myopic_push", n_restarts=args.restarts, steps=args.steps).planned
print(f"\n[ingest] e2e-planned makespan {e2e.makespan:.1f}s "
      f"vs myopic push {myo.makespan:.1f}s "
      f"({1 - e2e.makespan/myo.makespan:.0%} faster)")
