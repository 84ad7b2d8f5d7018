"""GeoPlan core on torch — :mod:`repro.core` without pipelines and the
scale tier.

* :mod:`repro_torch.core.platform` — tripartite platform model (§2.1),
  shared substrates, capacity traces and failures.
* :mod:`repro_torch.core.plan` — valid execution plans (§2.2, Eqs 1–3).
* :mod:`repro_torch.core.makespan` — makespan model (Eqs 4–14, G/L/P
  barrier semantics): float64 numpy pricing (single job, shared capacity,
  residuals) and the differentiable torch model the solvers anneal.
* :mod:`repro_torch.core.optimize` — plan optimization (§2.3) as batched
  torch solvers: single jobs, multi-job schedule policies, online
  re-planning and its policy registry; validated by brute force and by
  the paper's own linearization in :mod:`repro_torch.core.milp`.
* :mod:`repro_torch.core.simulate` — chunk-granular discrete-event
  executor (single jobs, concurrent schedules, the steerable engine of
  online control).
* :mod:`repro_torch.core.fluid` — flow-level executor and the fluid
  pricing of online control.
"""
from .fluid import FluidSim
from .makespan import (
    BARRIERS_ALL_GLOBAL,
    BARRIERS_ALL_PIPELINED,
    BARRIERS_GGL,
    CostModel,
    JobProgress,
    makespan,
    makespan_model,
    phase_breakdown,
    residual_volumes,
    shared_effective_volumes,
)
from .optimize import (
    MODES,
    SCHEDULE_OBJECTIVES,
    OnlineConfig,
    PlanResult,
    SchedulePlanResult,
    ScheduleReplanResult,
    SolveTimeEMA,
    SolverService,
    available_modes,
    available_online_policies,
    available_policies,
    brute_force_plan,
    get_online_config,
    get_online_policy,
    get_planner,
    get_schedule_planner,
    optimize_plan,
    optimize_plan_batch,
    optimize_schedule,
    register_online_policy,
    register_planner,
    register_schedule_planner,
    replan,
    replan_batch,
    replan_schedule,
    reset_solver_cache_stats,
    score_residual_shared,
    solver_cache_occupancy,
    solver_cache_stats,
    swap_charge,
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
from .simulate import (
    ProgressSnapshot,
    ResourceStats,
    ScheduleSimResult,
    SimConfig,
    SimResult,
    open_schedule,
    simulate,
    simulate_schedule,
)

__all__ = [
    "BARRIERS_ALL_GLOBAL",
    "BARRIERS_ALL_PIPELINED",
    "BARRIERS_GGL",
    "CapacityTrace",
    "CostModel",
    "ExecutionPlan",
    "FailureEvent",
    "FailureTrace",
    "FluidSim",
    "JobProgress",
    "MODES",
    "OnlineConfig",
    "Platform",
    "PlanResult",
    "ProgressSnapshot",
    "ResourceStats",
    "SCHEDULE_OBJECTIVES",
    "SchedulePlanResult",
    "ScheduleReplanResult",
    "ScheduleSimResult",
    "SimConfig",
    "SimResult",
    "SolveTimeEMA",
    "SolverService",
    "Substrate",
    "available_modes",
    "available_online_policies",
    "available_policies",
    "brute_force_plan",
    "get_online_config",
    "get_online_policy",
    "get_planner",
    "get_schedule_planner",
    "local_push_plan",
    "makespan",
    "makespan_model",
    "open_schedule",
    "optimize_plan",
    "optimize_plan_batch",
    "optimize_schedule",
    "phase_breakdown",
    "planetlab_platform",
    "register_online_policy",
    "register_planner",
    "register_schedule_planner",
    "replan",
    "replan_batch",
    "replan_schedule",
    "reset_solver_cache_stats",
    "residual_volumes",
    "score_residual_shared",
    "shared_effective_volumes",
    "simulate",
    "simulate_schedule",
    "solver_cache_occupancy",
    "solver_cache_stats",
    "swap_charge",
    "tpu_pod_platform",
    "two_cluster_example",
    "uniform_plan",
]
