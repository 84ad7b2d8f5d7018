"""GeoPlan core on torch — the single-job slice of :mod:`repro.core`.

* :mod:`repro_torch.core.platform` — tripartite platform model (§2.1).
* :mod:`repro_torch.core.plan` — valid execution plans (§2.2, Eqs 1–3).
* :mod:`repro_torch.core.makespan` — makespan model (Eqs 4–14, G/L/P
  barrier semantics): float64 numpy pricing and the differentiable torch
  model the solver anneals.
* :mod:`repro_torch.core.optimize` — single-job plan optimization (§2.3)
  as a batched torch solver, validated by brute force and by the paper's
  own linearization in :mod:`repro_torch.core.milp`.
* :mod:`repro_torch.core.simulate` — chunk-granular discrete-event
  executor for :meth:`repro_torch.api.GeoJob.simulate`.
"""
from .makespan import (
    BARRIERS_ALL_GLOBAL,
    BARRIERS_ALL_PIPELINED,
    BARRIERS_GGL,
    CostModel,
    makespan,
    makespan_model,
    phase_breakdown,
)
from .optimize import (
    MODES,
    PlanResult,
    SolverService,
    available_modes,
    brute_force_plan,
    get_planner,
    optimize_plan,
    optimize_plan_batch,
    register_planner,
    reset_solver_cache_stats,
    solver_cache_occupancy,
    solver_cache_stats,
)
from .plan import ExecutionPlan, local_push_plan, uniform_plan
from .platform import (
    CapacityTrace,
    FailureEvent,
    FailureTrace,
    Platform,
    Substrate,
    planetlab_platform,
    tpu_pod_platform,
    two_cluster_example,
)
from .simulate import SimConfig, SimResult, simulate

__all__ = [
    "BARRIERS_ALL_GLOBAL",
    "BARRIERS_ALL_PIPELINED",
    "BARRIERS_GGL",
    "CapacityTrace",
    "CostModel",
    "ExecutionPlan",
    "FailureEvent",
    "FailureTrace",
    "MODES",
    "Platform",
    "PlanResult",
    "SimConfig",
    "SimResult",
    "SolverService",
    "Substrate",
    "available_modes",
    "brute_force_plan",
    "get_planner",
    "local_push_plan",
    "makespan",
    "makespan_model",
    "optimize_plan",
    "optimize_plan_batch",
    "phase_breakdown",
    "planetlab_platform",
    "register_planner",
    "reset_solver_cache_stats",
    "simulate",
    "solver_cache_occupancy",
    "solver_cache_stats",
    "tpu_pod_platform",
    "two_cluster_example",
    "uniform_plan",
]
