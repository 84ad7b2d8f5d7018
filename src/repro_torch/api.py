"""`GeoJob` — the planning/execution facade, on the port.

:mod:`repro.api` on the port: model a platform, optimize a
plan, execute (or simulate) it, and compare modeled against measured
timings, all priced by one shared cost model
(:class:`repro_torch.core.makespan.CostModel`):

    from repro_torch.api import GeoJob, split_sources
    from repro_torch.core import BARRIERS_GGL, planetlab_platform
    from repro_torch.mapreduce.apps import generate_documents, word_count

    platform = planetlab_platform(8, alpha=1.0, seed=0)
    sources = split_sources(*generate_documents(800, 60), platform.nS)

    report = (
        GeoJob(platform, word_count())
        .calibrate(sources)                # probe-measure the app's alpha
        .plan(mode="e2e_multi", barriers=BARRIERS_GGL)
        .execute(sources)                  # real maps/reduces, real bytes
    )
    print(report.summary())                # modeled vs measured makespan

The solver runs on the job's ``device`` (default: the process default, the
card), and word count's reduce on its app's.  Every planner name registered
via :func:`repro_torch.core.optimize.register_planner` is usable as
``mode``.

Concurrent jobs contending for the same WAN links and compute lift the same
loop one level up — :class:`GeoSchedule` plans N jobs *together* on their
shared :class:`repro_torch.core.platform.Substrate` (policies:
``independent`` / ``sequential`` / ``joint``) and executes or simulates
them with real resource contention:

    sub = Substrate.of(platform)
    jobs = [GeoJob(sub.view(D_a, alpha), app_a), GeoJob(sub.view(D_b, alpha))]
    report = GeoSchedule(jobs, device="cuda").plan(policy="joint").simulate()
    print(report.summary())               # aggregate makespan + hot links

:meth:`GeoSchedule.run_online` closes the plan→observe→re-plan loop over
jobs streaming in after t=0 and capacities drifting mid-run:

    report = GeoSchedule([job_a]).plan(policy="joint").run_online(
        policy="reactive", arrivals=[Arrival(job_b, time=50.0)])
    print(report.summary())               # online vs frozen-plan makespan
    print(report.timeline())              # the per-decision audit trail

Multi-stage pipelines lift it across *stages* — :class:`GeoPipeline` plans
a DAG of jobs where each stage consumes its upstream stages' reduce output
(``stagewise`` / ``end_to_end``), and a pipeline may be a member of a
:class:`GeoSchedule`:

    pipe = GeoPipeline([GeoJob(sub.view(D, 1.0), app),
                        GeoJob(sub.view(np.zeros(sub.nS), 1.0), app)],
                       device="cuda")
    print(pipe.plan("end_to_end").simulate().summary())
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ._device import DeviceLike, resolve_device, synchronize
from .analysis.validate import validate_plan_shapes
from .core.fluid import fluid_score_residual
from .core.makespan import BARRIERS_GGL, CostModel, attribute_phases
from .core.optimize import (
    OnlineConfig,
    PipelinePlanResult,
    PlanResult,
    SchedulePlanResult,
    SolveTimeEMA,
    _pipeline_result,
    _shared_schedule_result,
    available_modes,
    get_online_config,
    get_online_policy,
    optimize_pipeline,
    optimize_plan,
    optimize_schedule,
    replan,
    replan_batch,
    replan_schedule,
    solver_cache_stats,
    swap_charge,
)
from .core.pipeline import PipelineSpec, StageSpec
from .core.plan import ExecutionPlan, uniform_plan
from .core.platform import Platform, Substrate
from .core.simulate import (
    ResourceStats,
    ScheduleSimResult,
    SimConfig,
    SimResult,
    open_schedule,
    simulate,
    simulate_schedule,
)
from .mapreduce.engine import GeoMapReduce, MRApp, PhaseStats, Records

__all__ = ["Arrival", "Decision", "GeoJob", "GeoPipeline", "GeoSchedule",
           "JobReport", "OnlineConfig", "OnlineReport", "PipelineReport",
           "ScheduleReport", "split_sources"]


def split_sources(keys: np.ndarray, values: np.ndarray, n_sources: int) -> List[Records]:
    """Partition a flat ``(keys, values)`` corpus into per-source record sets
    (one contiguous slice per data source)."""
    return list(zip(np.array_split(keys, n_sources),
                    np.array_split(values, n_sources)))


@dataclasses.dataclass(frozen=True)
class JobReport:
    """The outcome of one planned, executed job: the plan that ran, the
    measured byte movement, and modeled-vs-measured phase timings priced
    through the same cost model."""

    result: PlanResult
    stats: PhaseStats
    #: analytic phase breakdown of the plan (model side), seconds
    modeled: Dict[str, float]
    #: measured byte volumes priced through the identical equations, seconds
    measured: Dict[str, float]
    #: per-reducer ``(keys, values)`` outputs of the application
    outputs: List[Records]
    barriers: Tuple[str, str, str]

    @property
    def plan(self) -> ExecutionPlan:
        return self.result.plan

    @property
    def makespan_modeled(self) -> float:
        return self.modeled["makespan"]

    @property
    def makespan_measured(self) -> float:
        return self.measured["makespan"]

    def deltas(self) -> Dict[str, float]:
        """Measured − modeled seconds per phase (positive: the model was
        optimistic — e.g. the app's real α differs from the planning α)."""
        return {k: self.measured[k] - self.modeled[k] for k in self.modeled}

    def model_error(self) -> float:
        """Relative modeled-vs-measured makespan error."""
        return (self.makespan_modeled - self.makespan_measured) / max(
            self.makespan_measured, 1e-12
        )

    def summary(self) -> str:
        phases = " ".join(
            f"{k}={self.measured[k]:.1f}s" for k in ("push", "map", "shuffle", "reduce")
        )
        return (
            f"{self.result.mode}[{''.join(self.barriers)}] "
            f"measured={self.makespan_measured:.1f}s "
            f"modeled={self.makespan_modeled:.1f}s "
            f"(error {self.model_error():+.1%})  {phases}"
        )


class GeoJob:
    """A geo-distributed MapReduce job: platform + application + plan.

    The facade is fluent — ``plan(...)`` stores a :class:`PlanResult` and
    returns the job, so the whole loop reads
    ``GeoJob(platform, app).plan(mode=...).execute(per_source)``.
    """

    def __init__(
        self,
        platform: Platform,
        app: Optional[MRApp] = None,
        *,
        n_buckets: int = 512,
        device: Optional[DeviceLike] = None,
    ):
        self.platform = platform
        self.app = app
        self.n_buckets = n_buckets
        self.device = device
        self._result: Optional[PlanResult] = None

    def __repr__(self):
        app = self.app.name if self.app is not None else None
        planned = repr(self._result) if self._result is not None else "unplanned"
        return f"GeoJob({self.platform.name}, app={app}, {planned})"

    # -- planning ------------------------------------------------------------
    def plan(
        self,
        mode: str = "e2e_multi",
        barriers: Tuple[str, str, str] = BARRIERS_GGL,
        **solver_kwargs,
    ) -> "GeoJob":
        """Produce and adopt an execution plan with any registered planner
        (see :func:`repro_torch.core.optimize.available_modes`); extra
        keyword arguments (``n_restarts``, ``steps``, ``seed``, ``fixed_x``,
        ``device``) reach the solver, which runs on the job's device unless
        ``device`` overrides it."""
        solver_kwargs.setdefault("device", self.device)
        self._result = optimize_plan(
            self.platform, mode, barriers=tuple(barriers), **solver_kwargs
        )
        return self

    def with_plan(
        self,
        plan: ExecutionPlan,
        barriers: Tuple[str, str, str] = BARRIERS_GGL,
    ) -> "GeoJob":
        """Adopt an externally built plan (a baseline, a replayed plan, …),
        pricing it through the shared cost model."""
        validate_plan_shapes(
            (plan.nS, plan.nM, plan.nR),
            (self.platform.nS, self.platform.nM, self.platform.nR),
            context=f"plan {plan.meta or 'external'!r}",
        )
        cm = CostModel(self.platform, tuple(barriers))
        breakdown = cm.breakdown(plan)
        self._result = PlanResult(
            plan=plan,
            makespan=breakdown["makespan"],
            breakdown=breakdown,
            mode=plan.meta or "external",
            barriers=cm.barriers,
            objective=breakdown["makespan"],
        )
        return self

    @property
    def planned(self) -> PlanResult:
        if self._result is None:
            raise RuntimeError(
                "job has no plan yet — call .plan(mode=...) or .with_plan(...) "
                f"first (registered modes: {available_modes()})"
            )
        return self._result

    @property
    def cost_model(self) -> CostModel:
        """The cost model pricing this job (platform + planned barriers)."""
        barriers = self.planned.barriers if self._result is not None else BARRIERS_GGL
        return CostModel(self.platform, barriers)

    # -- calibration ---------------------------------------------------------
    def calibrate(
        self, per_source: Sequence[Records], alpha_floor: float = 0.01
    ) -> "GeoJob":
        """Probe-run the application under a uniform plan to measure its real
        expansion factor α *and* the per-source input volume, and return a
        job whose platform plans with them (the §3.2 probe).  Calibrating
        makes the modeled and measured sides of a :class:`JobReport`
        directly comparable; any existing plan is dropped as stale."""
        if self.app is None:
            raise RuntimeError("calibrate() needs an application (app=None)")
        probe = GeoMapReduce(
            self.platform, uniform_plan(self.platform), self.app,
            n_buckets=self.n_buckets,
        )
        _, stats = probe.run(per_source)
        D_mb = np.array(
            [k.shape[0] * self.app.record_bytes for k, _ in per_source],
            dtype=np.float64,
        ) / 1e6
        platform = dataclasses.replace(
            self.platform,
            D=np.maximum(D_mb, 1e-9),
            alpha=max(stats.alpha_measured, alpha_floor),
        )
        return GeoJob(platform, self.app, n_buckets=self.n_buckets,
                      device=self.device)

    # -- execution -----------------------------------------------------------
    def execute(self, per_source: Sequence[Records]) -> JobReport:
        """Run the application under the planned execution plan, price the
        measured byte movement through the same cost model the planner used,
        and report modeled-vs-measured timings."""
        if self.app is None:
            raise RuntimeError(
                "execute() needs an application — construct GeoJob(platform, app) "
                "or use .simulate() for a model-only run"
            )
        result = self.planned
        engine = GeoMapReduce(
            self.platform, result.plan, self.app, n_buckets=self.n_buckets
        )
        outputs, stats = engine.run(per_source)
        cm = CostModel(self.platform, result.barriers)
        return JobReport(
            result=result,
            stats=stats,
            modeled=result.breakdown,
            measured=cm.breakdown_volumes(*stats.volumes_mb()),
            outputs=outputs,
            barriers=result.barriers,
        )

    def simulate(self, cfg: Optional[SimConfig] = None, **cfg_kwargs) -> SimResult:
        """Execute the planned job on the chunk-granular discrete-event
        executor (no application needed); defaults to the plan's barriers."""
        result = self.planned
        if cfg is None:
            cfg_kwargs.setdefault("barriers", result.barriers)
            cfg = SimConfig(**cfg_kwargs)
        elif cfg_kwargs:
            raise TypeError("pass either cfg or keyword overrides, not both")
        return simulate(self.platform, result.plan, cfg)


# ---------------------------------------------------------------------------
# multi-stage pipelines
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """The outcome of one planned pipeline: per-stage plans priced end to
    end through the shared cost model, the discrete-event execution with
    real inter-stage release gating (:meth:`GeoPipeline.simulate`), and —
    after :meth:`GeoPipeline.execute` — per-stage application runs with
    measured byte movement chained stage to stage."""

    result: PipelinePlanResult
    barriers: Tuple[str, str, str]
    #: the concurrent stage execution (simulate()/execute() paths)
    sim: Optional[ScheduleSimResult] = None
    #: per-stage application reports (only from execute())
    jobs: Optional[Tuple[JobReport, ...]] = None
    #: measured per-stage timings composed along the DAG (only execute())
    measured: Optional[Dict[str, object]] = None

    @property
    def plans(self) -> Tuple[ExecutionPlan, ...]:
        return self.result.plans

    @property
    def sims(self) -> Optional[Tuple[SimResult, ...]]:
        """Per-stage discrete-event results."""
        return tuple(self.sim.jobs) if self.sim is not None else None

    @property
    def makespan_modeled(self) -> float:
        """Modeled end-to-end makespan along the DAG's critical path."""
        return self.result.makespan

    @property
    def makespan_sim(self) -> Optional[float]:
        """Simulated end-to-end makespan (absolute finish of the last
        stage, inter-stage gating included)."""
        return self.sim.makespan if self.sim is not None else None

    @property
    def makespan_measured(self) -> Optional[float]:
        """Measured end-to-end makespan (execute() path), else ``None``."""
        if self.measured is None:
            return None
        return float(self.measured["makespan"])

    def as_dict(self) -> Dict[str, object]:
        """Stable, JSON-round-trippable form: modeled per-stage spans and
        DAG composition, plus the simulated/measured sides when present."""
        out: Dict[str, object] = {
            "mode": self.result.mode,
            "barriers": "".join(self.barriers),
            "makespan": self.result.makespan,
            "stages": [
                {"makespan": r.makespan, **{k: float(v) for k, v
                                            in r.breakdown.items()}}
                for r in self.result.results
            ],
            "start": [float(t) for t in self.result.starts],
            "finish": [float(t) for t in self.result.finishes],
        }
        if self.sim is not None:
            out["simulated"] = self.sim.as_dict()
        if self.measured is not None:
            out["measured"] = self.measured
        return out

    def summary(self) -> str:
        extra = ""
        if self.makespan_sim is not None:
            extra += f" simulated={self.makespan_sim:.1f}s"
        if self.makespan_measured is not None:
            extra += f" measured={self.makespan_measured:.1f}s"
        stages = " ".join(
            f"{r.makespan:.0f}s" for r in self.result.results
        )
        return (
            f"pipeline[{self.result.mode}/{''.join(self.barriers)}] "
            f"{len(self.result.results)} stages "
            f"modeled={self.makespan_modeled:.1f}s{extra}  [{stages}]"
        )


class GeoPipeline:
    """A DAG of MapReduce stages where each downstream stage consumes its
    upstream stages' reduce output — the paper's end-to-end-beats-myopic
    argument lifted across *stages*.

    ``stages`` are per-stage :class:`GeoJob`\\ s on one shared substrate;
    only root stages' ``D`` is authoritative (a downstream stage's source
    vector is derived from its upstream reducers' placement).  ``edges``
    is a list of ``(upstream, downstream)`` stage-index pairs, defaulting
    to the linear chain; ``out_scales[k]`` is stage ``k``'s reduce-output
    MB per reduce-input MB.

    The facade mirrors :class:`GeoJob`:
    ``GeoPipeline(stages).plan(mode=...).simulate()`` — ``mode`` is any
    registered pipeline planner (``stagewise`` / ``end_to_end`` built in),
    ``stage_mode`` the per-stage planner it builds on.  Planning adopts
    each stage's shared-priced :class:`PlanResult` (and its derived-``D``
    platform view) into the stage job, so stages remain usable job facades
    afterwards.  A pipeline can be scheduled alongside plain jobs inside
    :class:`GeoSchedule` — including :meth:`GeoSchedule.run_online`, whose
    snapshot/swap machinery steers the not-yet-started stages of a live
    pipeline.  Every solve of the pipeline runs on ``device`` (default: the
    process default, the card); each stage's application keeps its own."""

    def __init__(
        self,
        stages: Sequence[GeoJob],
        edges: Optional[Sequence[Tuple[int, int]]] = None,
        out_scales: Optional[Sequence[float]] = None,
        name: str = "pipeline",
        *,
        device: Optional[DeviceLike] = None,
    ):
        if not stages:
            raise ValueError("GeoPipeline needs at least one stage")
        self.stages = list(stages)
        self.name = name
        self.device = device
        n = len(self.stages)
        if edges is None:
            edges = [(k - 1, k) for k in range(1, n)]
        if out_scales is None:
            out_scales = [1.0] * n
        if len(out_scales) != n:
            raise ValueError("one out_scale per stage")
        deps: List[List[int]] = [[] for _ in range(n)]
        for u, v in edges:
            u, v = int(u), int(v)
            if not (0 <= u < n and 0 <= v < n):
                raise ValueError(f"edge ({u}, {v}) references unknown stages")
            deps[v].append(u)
        #: the validated stage DAG (cycles rejected here, at construction)
        self.spec = PipelineSpec(stages=tuple(
            StageSpec(
                platform=job.platform,
                deps=tuple(deps[k]),
                out_scale=float(out_scales[k]),
                name=f"{name}/stage{k}",
            )
            for k, job in enumerate(self.stages)
        ))
        self.substrate = self.spec.substrate
        self._result: Optional[PipelinePlanResult] = None

    def __repr__(self):
        planned = repr(self._result) if self._result is not None \
            else "unplanned"
        return (
            f"GeoPipeline({self.name}: {len(self.stages)} stages on "
            f"{self.substrate.name}, {planned})"
        )

    def stage_links(self) -> Dict[int, List[Tuple[int, float]]]:
        """Executor stage-linkage: ``{stage: [(upstream, out_scale), ...]}``
        (the upstream's own out_scale — what its reducers emit)."""
        return {
            k: [(u, self.spec.stages[u].out_scale) for u in stage.deps]
            for k, stage in enumerate(self.spec.stages)
            if stage.deps
        }

    # -- planning ------------------------------------------------------------
    def plan(
        self,
        mode: str = "end_to_end",
        stage_mode: str = "e2e_multi",
        barriers: Tuple[str, str, str] = BARRIERS_GGL,
        **solver_kwargs,
    ) -> "GeoPipeline":
        """Plan all stages with any registered pipeline planner
        (``stagewise`` — the per-stage-myopic baseline — or ``end_to_end``
        — one solve over all stages with gradients through the inter-stage
        coupling; see
        :func:`repro_torch.core.optimize.available_pipeline_modes`).  Extra
        keyword arguments (``n_restarts``, ``steps``, ``seed``, ``device``)
        reach :func:`repro_torch.core.optimize.optimize_pipeline`, which
        solves on the pipeline's device unless ``device`` overrides it."""
        solver_kwargs.setdefault("device", self.device)
        self._result = optimize_pipeline(
            self.spec, mode=mode, stage_mode=stage_mode,
            barriers=tuple(barriers), **solver_kwargs,
        )
        self._adopt(self._result)
        return self

    def with_plans(self) -> "GeoPipeline":
        """Adopt every stage's existing plan (set via :meth:`GeoJob.plan`
        or :meth:`GeoJob.with_plan`) as the pipeline plan, re-priced end to
        end — the pipeline analogue of :meth:`GeoJob.with_plan` for
        baselines and replays."""
        barriers = self.stages[0].planned.barriers
        for job in self.stages[1:]:
            if job.planned.barriers != barriers:
                raise ValueError(
                    "with_plans() needs every stage planned under the same "
                    f"barriers, got {job.planned.barriers} vs {barriers}"
                )
        plans = [job.planned.plan for job in self.stages]
        res = _pipeline_result(
            self.spec, plans, barriers, "external", "external", 0.0
        )
        self._result = dataclasses.replace(res, objective=res.makespan)
        self._adopt(self._result)
        return self

    def _adopt(self, result: PipelinePlanResult) -> None:
        """Give every stage job its derived-``D`` platform view and its
        end-to-end-priced :class:`PlanResult` (each job keeps its own
        ``device``)."""
        for job, platform, res in zip(
            self.stages, self.spec.stage_platforms(result.plans),
            result.results,
        ):
            job.platform = platform
            job._result = res

    @property
    def planned(self) -> PipelinePlanResult:
        if self._result is None:
            raise RuntimeError(
                "pipeline has no plan yet — call .plan(mode=...) or "
                ".with_plans() first"
            )
        return self._result

    # -- execution -----------------------------------------------------------
    def _stage_cfgs(self, cfg, cfg_kwargs) -> List[SimConfig]:
        result = self.planned
        if cfg is None:
            cfg_kwargs.setdefault("barriers", result.barriers)
            cfg = SimConfig(**cfg_kwargs)
        elif cfg_kwargs:
            raise TypeError("pass either cfg or keyword overrides, not both")
        cfgs = [cfg] * len(self.stages) if isinstance(cfg, SimConfig) \
            else list(cfg)
        if len(cfgs) != len(self.stages):
            raise ValueError("one SimConfig per stage (or a single shared one)")
        return cfgs

    def simulate(self, cfg=None, **cfg_kwargs) -> PipelineReport:
        """Execute the planned pipeline on the chunk-granular executor:
        all stages run through the shared resource engine, and a downstream
        stage's push chunks at source ``s`` release only when the upstream
        reduce output destined for ``s`` lands (real inter-stage gating,
        real contention between overlapping stages)."""
        result = self.planned
        cfgs = self._stage_cfgs(cfg, cfg_kwargs)
        entries = [
            (job.platform, res.plan, c)
            for job, res, c in zip(self.stages, result.results, cfgs)
        ]
        sim = simulate_schedule(entries, substrate=self.substrate,
                                stage_links=self.stage_links())
        return PipelineReport(result=result, barriers=result.barriers,
                              sim=sim)

    def execute(self, per_source) -> PipelineReport:
        """Run every stage's application, chaining real records: a
        downstream stage's source ``s`` consumes the concatenated reducer-
        ``s`` outputs of its upstream stages.  ``per_source`` is the root
        stage's per-source record sets (or ``{stage_idx: record_sets}``
        when the DAG has several roots).  Measured per-stage byte movement
        is priced through the identical cost model and composed along the
        same critical path as the modeled side."""
        result = self.planned
        roots = [k for k, s in enumerate(self.spec.stages) if not s.deps]
        if isinstance(per_source, dict):
            root_sources = {int(k): v for k, v in per_source.items()}
        elif len(roots) == 1:
            root_sources = {roots[0]: per_source}
        else:
            raise ValueError(
                f"pipeline has {len(roots)} root stages — pass "
                "per_source as {stage_idx: record_sets}"
            )
        if set(root_sources) != set(roots):
            raise ValueError(
                f"per_source covers stages {sorted(root_sources)} but the "
                f"roots are {roots}"
            )
        for job in self.stages:
            if job.app is None:
                raise RuntimeError(
                    "execute() needs every stage to carry an application — "
                    "use .simulate() for a model-only run"
                )
        n = len(self.stages)
        outputs: List[Optional[List[Records]]] = [None] * n
        reports: List[Optional[JobReport]] = [None] * n
        stage_measured: List[Optional[Dict[str, float]]] = [None] * n
        for k in self.spec.topo_order():
            stage, job, res = self.spec.stages[k], self.stages[k], \
                result.results[k]
            if stage.deps:
                srcs = [
                    (
                        np.concatenate([outputs[u][s][0]
                                        for u in stage.deps]),
                        np.concatenate([outputs[u][s][1]
                                        for u in stage.deps]),
                    )
                    for s in range(job.platform.nS)
                ]
            else:
                srcs = root_sources[k]
            engine = GeoMapReduce(
                job.platform, res.plan, job.app, n_buckets=job.n_buckets
            )
            outs, stats = engine.run(srcs)
            outputs[k] = outs
            cm = CostModel(job.platform, result.barriers)
            measured = cm.breakdown_volumes(*stats.volumes_mb())
            stage_measured[k] = measured
            reports[k] = JobReport(
                result=res, stats=stats, modeled=res.breakdown,
                measured=measured, outputs=outs, barriers=result.barriers,
            )
        # compose the measured stage spans along the same critical path
        start = [0.0] * n
        finish = [0.0] * n
        for k in self.spec.topo_order():
            start[k] = max(
                (finish[u] for u in self.spec.stages[k].deps), default=0.0
            )
            finish[k] = start[k] + stage_measured[k]["makespan"]
        measured_doc: Dict[str, object] = {
            "stages": [dict(m) for m in stage_measured],
            "start": start,
            "finish": finish,
            "makespan": max(finish),
        }
        cfgs = self._stage_cfgs(None, {})
        sim = simulate_schedule(
            [(job.platform, res.plan, c)
             for job, res, c in zip(self.stages, result.results, cfgs)],
            substrate=self.substrate, stage_links=self.stage_links(),
        )
        return PipelineReport(
            result=result, barriers=result.barriers, sim=sim,
            jobs=tuple(reports), measured=measured_doc,
        )


# ---------------------------------------------------------------------------
# multi-job scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleReport:
    """The outcome of one planned, concurrently executed schedule: per-job
    plans priced under shared-capacity contention, the discrete-event
    execution of all jobs on the shared substrate, per-resource
    utilization/contention accounting, and (after :meth:`GeoSchedule.execute`)
    per-job :class:`JobReport`\\ s with real measured byte movement."""

    result: SchedulePlanResult
    #: the concurrent discrete-event execution (always present — execute()
    #: runs the modeled schedule too, for the resource accounting)
    sim: ScheduleSimResult
    barriers: Tuple[str, str, str]
    #: per-job application reports (only from execute())
    jobs: Optional[Tuple[JobReport, ...]] = None

    @property
    def policy(self) -> str:
        return self.result.policy

    @property
    def plans(self) -> Tuple[ExecutionPlan, ...]:
        return self.result.plans

    @property
    def sims(self) -> Tuple[SimResult, ...]:
        """Per-job discrete-event results."""
        return tuple(self.sim.jobs)

    @property
    def resources(self) -> Dict[str, ResourceStats]:
        """Named substrate resources -> service accounting."""
        return self.sim.resources

    @property
    def makespan_modeled(self) -> float:
        """Aggregate modeled makespan (shared-capacity pricing, max over
        jobs)."""
        return self.result.makespan

    @property
    def makespan_sim(self) -> float:
        """Aggregate discrete-event makespan (absolute finish of the last
        job)."""
        return self.sim.makespan

    @property
    def makespan_measured(self) -> Optional[float]:
        """Aggregate measured makespan (execute() path), else ``None``."""
        if self.jobs is None:
            return None
        return max(job.makespan_measured for job in self.jobs)

    def utilization(self) -> Dict[str, float]:
        """Busy fraction of the schedule horizon per named resource."""
        return self.sim.utilization()

    def contended(self) -> Dict[str, ResourceStats]:
        """Resources that served chunks of more than one job."""
        return self.sim.contended()

    def hotspots(
        self,
        utilization_above: Optional[float] = None,
        backlog_age_above_s: Optional[float] = None,
    ) -> Dict[str, List[str]]:
        """Resources whose load crossed a warning threshold (utilization or
        mean queue delay), with human-readable violations — see
        :meth:`ScheduleSimResult.hotspots`."""
        return self.sim.hotspots(utilization_above, backlog_age_above_s)

    def as_dict(self) -> Dict[str, object]:
        """JSON-pure report of the schedule outcome: barrier configuration,
        policy, modeled/simulated (and, after execute(), measured)
        makespans, the full execution accounting, and the load hotspots
        that crossed the :class:`ResourceStats` warning thresholds."""
        out: Dict[str, object] = {
            "policy": str(self.policy),
            "barriers": "".join(self.barriers),
            "makespan_modeled": float(self.makespan_modeled),
            "makespan_sim": float(self.makespan_sim),
            "sim": self.sim.as_dict(),
            "hotspots": self.hotspots(),
        }
        if self.jobs is not None:
            out["makespan_measured"] = float(self.makespan_measured)
        return out

    def summary(self) -> str:
        measured = (
            f" measured={self.makespan_measured:.1f}s"
            if self.jobs is not None else ""
        )
        util = self.utilization()
        hot = " ".join(
            f"{n}={util[n]:.0%}"
            for n in sorted(util, key=lambda n: -util[n])[:3]
        )
        return (
            f"{self.policy}[{''.join(self.barriers)}] {len(self.sims)} jobs "
            f"modeled={self.makespan_modeled:.1f}s "
            f"simulated={self.makespan_sim:.1f}s{measured} "
            f"contended={len(self.contended())} hottest: {hot}"
        )


@dataclasses.dataclass(frozen=True)
class Arrival:
    """A job that streams in after t=0: the online control plane learns of
    it only at ``time``.  If ``job`` is unplanned, a *frozen* offline plan
    is produced with planner ``mode`` against the nominal substrate (what a
    static scheduler would have committed to); online policies may replace
    it at arrival against the capacities then in force.  ``cfg`` overrides
    the schedule-wide :class:`SimConfig` template for this job (its
    ``start_time`` is always forced to ``time``)."""

    job: "GeoJob"
    time: float
    mode: str = "e2e_multi"
    cfg: Optional[SimConfig] = None


@dataclasses.dataclass(frozen=True)
class Decision:
    """One entry of an online run's control timeline."""

    time: float
    event: str  # "arrival" | "drift" | "failure" | "tick"
    job: int
    #: "inject" | "swap" | "keep" | "reject" — "reject" is a candidate swap
    #: whose modeled savings did not clear its hysteresis-weighted charge
    action: str
    #: modeled remaining seconds under the incumbent plan at decision time
    modeled_before: float
    #: modeled remaining seconds under the adopted plan (== before on
    #: keep/reject — a rejected candidate is not adopted)
    modeled_after: float
    #: the replan cost charged against the candidate swap (solver estimate
    #: + modeled data movement, seconds; 0 outside cost-aware policies)
    charge: float = 0.0

    def __repr__(self):
        charged = f" charge={self.charge:.1f}s" if self.charge else ""
        return (
            f"Decision(t={self.time:.1f}s {self.event}: job {self.job} "
            f"{self.action} {self.modeled_before:.1f}s->"
            f"{self.modeled_after:.1f}s{charged})"
        )


@dataclasses.dataclass(frozen=True)
class OnlineReport:
    """The outcome of one online-controlled schedule: the steered execution,
    the frozen-plan baseline on the *same* arrivals and capacity drift, and
    the per-decision timeline that separates them."""

    policy: str
    sim: ScheduleSimResult
    static_sim: ScheduleSimResult
    decisions: Tuple[Decision, ...]
    #: each job's plan when the run finished (arrivals included, in
    #: injection order after the initial jobs)
    plans: Tuple[ExecutionPlan, ...]
    barriers: Tuple[str, str, str]

    @property
    def makespan_online(self) -> float:
        """Aggregate simulated makespan of the steered execution."""
        return self.sim.makespan

    @property
    def makespan_static(self) -> float:
        """Aggregate simulated makespan of the frozen-plan baseline."""
        return self.static_sim.makespan

    @property
    def improvement(self) -> float:
        """Fraction of the frozen baseline's makespan the online policy
        removed (0 = no better, 0.4 = 40% faster)."""
        if self.makespan_static <= 0:
            return 0.0
        return 1.0 - self.makespan_online / self.makespan_static

    @property
    def swaps(self) -> Tuple[Decision, ...]:
        """Accepted swaps — candidate plans actually adopted."""
        return tuple(d for d in self.decisions if d.action == "swap")

    @property
    def rejected(self) -> Tuple[Decision, ...]:
        """Candidate swaps the replan-cost hysteresis declined."""
        return tuple(d for d in self.decisions if d.action == "reject")

    @property
    def charged_s(self) -> float:
        """Total replan cost charged against candidate swaps (accepted and
        rejected), modeled seconds."""
        return sum(d.charge for d in self.decisions)

    def as_dict(self) -> Dict[str, object]:
        """JSON-pure report of the online run: policy, the steered/frozen
        makespans and their gap, decision-timeline aggregates, and the flat
        per-decision records (mirrors :meth:`ScheduleReport.as_dict`)."""
        return {
            "policy": str(self.policy),
            "barriers": "".join(self.barriers),
            "makespan_online": float(self.makespan_online),
            "makespan_static": float(self.makespan_static),
            "improvement": float(self.improvement),
            "n_decisions": len(self.decisions),
            "n_swaps": len(self.swaps),
            "n_rejected": len(self.rejected),
            "n_failures_observed": len(
                [d for d in self.decisions if d.event == "failure"]
            ),
            "charged_s": float(self.charged_s),
            "decisions": [
                {
                    "time": float(d.time),
                    "event": str(d.event),
                    "job": int(d.job),
                    "action": str(d.action),
                    "modeled_before": float(d.modeled_before),
                    "modeled_after": float(d.modeled_after),
                    "charge": float(d.charge),
                }
                for d in self.decisions
            ],
            "sim": self.sim.as_dict(),
            "static_sim": self.static_sim.as_dict(),
        }

    def timeline(self) -> str:
        if not self.decisions:
            return "(no decisions)"
        return "\n".join(
            f"  t={d.time:8.1f}s  {d.event:8s} job {d.job}: {d.action:6s} "
            f"remaining {d.modeled_before:8.1f}s -> {d.modeled_after:8.1f}s"
            + (f"  (charged {d.charge:.1f}s)" if d.charge else "")
            for d in self.decisions
        )

    def summary(self) -> str:
        rejected = (
            f", {len(self.rejected)} rejected" if self.rejected else ""
        )
        return (
            f"online[{self.policy}] {len(self.sim.jobs)} jobs "
            f"online={self.makespan_online:.1f}s "
            f"static={self.makespan_static:.1f}s "
            f"({self.improvement:+.0%} vs frozen, "
            f"{len(self.swaps)} swaps{rejected}/"
            f"{len(self.decisions)} decisions)"
        )


class GeoSchedule:
    """N concurrent :class:`GeoJob`\\ s contending for one shared
    :class:`Substrate` — the end-to-end-beats-myopic argument lifted across
    jobs.

    The facade mirrors :class:`GeoJob`:
    ``GeoSchedule(jobs).plan(policy=...).simulate()`` (or ``.execute(...)``
    when every job carries an application).  All job platforms must be
    views of the same substrate (:meth:`Substrate.view`); planning adopts
    each per-job plan into its :class:`GeoJob`, so individual jobs remain
    usable facades afterwards.  A member may also be a
    :class:`GeoPipeline`: its stages join the flat job list, linked stage
    to stage in the executor.  Every solve of the schedule — its plan and
    each re-plan of :meth:`run_online` — runs on ``device`` (default: the
    process default, the card).
    """

    def __init__(self, jobs: Sequence, *,
                 device: Optional[DeviceLike] = None):
        if not jobs:
            raise ValueError("GeoSchedule needs at least one job")
        #: the user's members (GeoJob or GeoPipeline), in order
        self.members = list(jobs)
        #: the flat job list the engine runs — pipelines contribute their
        #: stage jobs, linked through ``_links``
        self.jobs: List[GeoJob] = []
        self._links: Dict[int, List[Tuple[int, float]]] = {}
        self._pipelines: List[Tuple[GeoPipeline, int]] = []
        for member in self.members:
            if isinstance(member, GeoPipeline):
                base = len(self.jobs)
                self._pipelines.append((member, base))
                self.jobs.extend(member.stages)
                for child, parents in member.stage_links().items():
                    self._links[base + child] = [
                        (base + p, s) for p, s in parents
                    ]
            elif isinstance(member, GeoJob):
                self.jobs.append(member)
            else:
                raise TypeError(
                    "GeoSchedule members must be GeoJob or GeoPipeline, "
                    f"got {type(member).__name__}"
                )
        self.device = device
        self.substrate = Substrate.of(self.jobs[0].platform)
        for job in self.jobs[1:]:
            if not self.substrate.compatible(Substrate.of(job.platform)):
                raise ValueError(
                    f"job platform {job.platform.name!r} does not share the "
                    "substrate — build job platforms with Substrate.view()"
                )
        self._result: Optional[SchedulePlanResult] = None

    def __repr__(self):
        planned = repr(self._result) if self._result is not None else "unplanned"
        return f"GeoSchedule({len(self.jobs)} jobs on {self.substrate.name}, {planned})"

    # -- planning ------------------------------------------------------------
    def plan(
        self,
        policy: str = "joint",
        mode: str = "e2e_multi",
        barriers: Tuple[str, str, str] = BARRIERS_GGL,
        pipeline_mode: str = "end_to_end",
        **solver_kwargs,
    ) -> "GeoSchedule":
        """Plan all jobs together with any registered schedule policy
        (``independent`` / ``sequential`` / ``joint`` built in — see
        :func:`repro_torch.core.optimize.available_policies`); ``mode`` is
        the per-job planner the policy builds on.  Extra keyword arguments
        (``n_restarts``, ``steps``, ``seed``, ``objective``, ``device``)
        reach :func:`repro_torch.core.optimize.optimize_schedule`, which
        solves on the schedule's device unless ``device`` overrides it.
        Each job adopts its shared-priced :class:`PlanResult`.

        :class:`GeoPipeline` members are planned with ``pipeline_mode``
        (cross-stage, per pipeline — stage ``mode`` underneath, on the
        same device); plain jobs go through the schedule ``policy``, and
        the whole flat stack (stages included, on their derived-``D``
        views) is re-priced under shared capacity."""
        barriers = tuple(barriers)
        solver_kwargs.setdefault("device", self.device)
        if not self._pipelines:
            self._result = optimize_schedule(
                [job.platform for job in self.jobs],
                policy=policy, mode=mode, barriers=barriers,
                **solver_kwargs,
            )
            for job, res in zip(self.jobs, self._result.results):
                job._result = res
            return self
        # only the generic solver knobs reach the pipeline planner —
        # schedule-level kwargs (e.g. objective=) stay with the policy
        pipe_kwargs = {
            k: v for k, v in solver_kwargs.items()
            if k in ("n_restarts", "steps", "seed", "device")
        }
        for pipe, _ in self._pipelines:
            pipe.plan(mode=pipeline_mode, stage_mode=mode,
                      barriers=barriers, **pipe_kwargs)
        staged = {
            base + k
            for pipe, base in self._pipelines
            for k in range(len(pipe.stages))
        }
        plain = [i for i in range(len(self.jobs)) if i not in staged]
        if plain:
            sub_result = optimize_schedule(
                [self.jobs[i].platform for i in plain],
                policy=policy, mode=mode, barriers=barriers,
                **solver_kwargs,
            )
            for i, res in zip(plain, sub_result.results):
                self.jobs[i]._result = res
        self._result = _shared_schedule_result(
            [job.platform for job in self.jobs],
            [job.planned.plan for job in self.jobs],
            barriers, policy=policy, mode=mode,
        )
        for job, res in zip(self.jobs, self._result.results):
            job._result = res
        return self

    def with_plans(self) -> "GeoSchedule":
        """Adopt every job's existing plan (set via :meth:`GeoJob.plan` or
        :meth:`GeoJob.with_plan`) as the schedule plan, re-priced under
        shared capacity — the schedule analogue of :meth:`GeoJob.with_plan`
        for baselines and replays."""
        barriers = self.jobs[0].planned.barriers
        for job in self.jobs[1:]:
            if job.planned.barriers != barriers:
                raise ValueError(
                    "with_plans() needs every job planned under the same "
                    f"barriers, got {job.planned.barriers} vs {barriers}"
                )
        self._result = _shared_schedule_result(
            [job.platform for job in self.jobs],
            [job.planned.plan for job in self.jobs],
            barriers, policy="external", mode="external",
        )
        for job, res in zip(self.jobs, self._result.results):
            job._result = res
        return self

    @property
    def planned(self) -> SchedulePlanResult:
        if self._result is None:
            raise RuntimeError(
                "schedule has no plan yet — call .plan(policy=...) first"
            )
        return self._result

    # -- execution -----------------------------------------------------------
    def _sim_entries(self, cfg: Optional[SimConfig], cfg_kwargs):
        result = self.planned
        if cfg is None and not cfg_kwargs:
            cfg = SimConfig(barriers=result.barriers)
        elif cfg is None:
            cfg_kwargs.setdefault("barriers", result.barriers)
            cfg = SimConfig(**cfg_kwargs)
        elif cfg_kwargs:
            raise TypeError("pass either cfg or keyword overrides, not both")
        cfgs = [cfg] * len(self.jobs) if isinstance(cfg, SimConfig) else list(cfg)
        if len(cfgs) != len(self.jobs):
            raise ValueError("one SimConfig per job (or a single shared one)")
        return [
            (job.platform, res.plan, c)
            for job, res, c in zip(self.jobs, result.results, cfgs)
        ]

    def simulate(self, cfg=None, **cfg_kwargs) -> ScheduleReport:
        """Execute all planned jobs concurrently on the chunk-granular
        executor — chunks of different jobs contend for the same link and
        compute resources.  ``cfg`` is a shared :class:`SimConfig`, a
        per-job sequence of them, or keyword overrides; barriers default to
        the planned ones."""
        entries = self._sim_entries(cfg, cfg_kwargs)
        sim = simulate_schedule(entries, substrate=self.substrate,
                                stage_links=self._links or None)
        return ScheduleReport(
            result=self.planned,
            sim=sim,
            barriers=self.planned.barriers,
        )

    def execute(self, per_source: Sequence[Sequence[Records]]) -> ScheduleReport:
        """Run every job's application under its planned slice of the
        schedule, price each job's *measured* byte movement under the same
        shared-capacity equations the policy optimized, and report per-job
        modeled-vs-measured timings plus the substrate's resource
        accounting (from the modeled concurrent execution).

        ``per_source[g]`` is job ``g``'s per-source record sets."""
        result = self.planned
        if self._links:
            raise RuntimeError(
                "execute() on a schedule containing pipelines is not "
                "supported — run GeoPipeline.execute() per pipeline (real "
                "record chaining), or use .simulate() for the whole "
                "schedule"
            )
        if len(per_source) != len(self.jobs):
            raise ValueError("one per-source record set per job")
        for job in self.jobs:
            if job.app is None:
                raise RuntimeError(
                    "execute() needs every job to carry an application — "
                    "use .simulate() for a model-only run"
                )
        stats_list: List[PhaseStats] = []
        outputs_list: List[List[Records]] = []
        for job, res, srcs in zip(self.jobs, result.results, per_source):
            engine = GeoMapReduce(
                job.platform, res.plan, job.app, n_buckets=job.n_buckets
            )
            outputs, stats = engine.run(srcs)
            stats_list.append(stats)
            outputs_list.append(outputs)
        cm = CostModel(self.jobs[0].platform, result.barriers)
        measured = cm.price_shared(
            [stats.volumes_mb() for stats in stats_list], result.barriers
        )
        reports = tuple(
            JobReport(
                result=res,
                stats=stats,
                modeled=res.breakdown,
                measured=attribute_phases(out),
                outputs=outputs,
                barriers=result.barriers,
            )
            for res, stats, out, outputs in zip(
                result.results, stats_list, measured, outputs_list
            )
        )
        sim = simulate_schedule(
            self._sim_entries(None, {}), substrate=self.substrate
        )
        return ScheduleReport(
            result=result,
            sim=sim,
            barriers=result.barriers,
            jobs=reports,
        )

    # -- online control ------------------------------------------------------
    def run_online(
        self,
        policy: str = "reactive",
        arrivals: Sequence[Arrival] = (),
        cfg: Optional[SimConfig] = None,
        replan_dt: Optional[float] = None,
        n_restarts: int = 8,
        steps: int = 200,
        seed: int = 0,
        online: Optional[OnlineConfig] = None,
    ) -> OnlineReport:
        """Execute the planned schedule under a closed plan→observe→re-plan
        loop, with ``arrivals`` streaming in after t=0 and any capacity
        drift of the substrate's :class:`repro_torch.core.platform.CapacityTrace`\\ s
        applied live.

        ``policy`` is any name registered via
        :func:`repro_torch.core.optimize.register_online_policy` — built in:
        ``static`` (never re-plan: reproduces the frozen offline pipeline
        exactly), ``reactive`` (re-plan on every arrival / failure /
        capacity-drift event), ``horizon`` (re-plan every ``replan_dt``
        seconds), their schedule-aware, cost-aware variants
        ``reactive_shared`` / ``horizon_shared``,
        ``reactive_incremental`` (shared triggers with warm-started
        incremental solves charged at measured cost), and
        ``reactive_fluid`` (incremental solves with the replan gate
        scored by a drift-aware fluid rollout —
        ``OnlineConfig(candidate_pricing="fluid")`` — so a decision's
        pricing cost scales with flows, not chunks).  At each decision
        point
        the executor is paused and a
        :class:`~repro_torch.core.simulate.ProgressSnapshot` captured; how the
        residuals are then re-planned is the policy's
        :class:`~repro_torch.core.optimize.OnlineConfig` (overridable via
        ``online``):

        * solo (default): each active job re-planned alone against the
          capacities then in force (:func:`repro_torch.core.optimize.replan`,
          warm-started from the incumbent plan), any improving plan
          swapped in for the job's not-yet-committed chunks;
        * ``shared=True``: all live jobs co-replanned *jointly* against
          shared-capacity residual pricing
          (:func:`repro_torch.core.optimize.replan_schedule`) — no job grabs a
          fast link the model knows the others also need;
        * ``hysteresis > 0``: each candidate swap is charged its replan
          cost (:func:`repro_torch.core.optimize.swap_charge`: solver wall-clock
          — a measured EMA of this run's solve times unless the config
          pins ``solver_cost_s`` — plus the modeled data movement of
          re-routing its queued bytes) and fires
          only when modeled savings exceed ``hysteresis ×`` the charge —
          rejected candidates land in the timeline as ``reject`` entries
          with the charge that gated them.  ``hysteresis=inf`` never
          swaps, reproducing ``static`` byte-for-byte.

        Every solve runs on the schedule's device; each is timed between
        two synchronizations of it, so a measured charge is the solve's
        wall-clock, not its launches'.  The returned :class:`OnlineReport`
        carries the steered execution, the frozen-plan baseline run on the
        *same* arrivals and drift, and the per-decision timeline (with
        per-swap charge accounting).
        """
        policy_fn = get_online_policy(policy)
        ocfg = online if online is not None else get_online_config(policy)
        # hysteresis=inf can never accept a swap: skip the solves entirely
        # (the run is the frozen pipeline either way)
        gate_open = bool(np.isfinite(ocfg.hysteresis))
        if replan_dt is not None and replan_dt <= 0:
            raise ValueError(f"replan_dt must be > 0, got {replan_dt}")
        if policy in ("horizon", "horizon_shared") and replan_dt is None:
            raise ValueError(
                f"policy={policy!r} replans only on ticks — pass replan_dt "
                "(seconds between re-planning decisions)"
            )
        result = self.planned
        dev = resolve_device(self.device)
        entries = self._sim_entries(cfg, {})
        template = entries[0][2]

        # frozen offline plans for the arrivals (planned on the nominal
        # substrate — what a static scheduler would have committed to)
        arrivals = sorted(arrivals, key=lambda a: a.time)
        arrival_entries = []
        for n, a in enumerate(arrivals):
            if a.job._result is None:
                a.job.plan(
                    mode=a.mode, barriers=result.barriers,
                    n_restarts=n_restarts, steps=steps, seed=seed + 101 * n,
                    device=dev if a.job.device is None else a.job.device,
                )
            acfg = dataclasses.replace(
                a.cfg if a.cfg is not None else template, start_time=a.time
            )
            arrival_entries.append((a.job.platform, a.job.planned.plan, acfg))

        # the frozen baseline: identical jobs, releases and drift — no loop
        static_sim = simulate_schedule(
            entries + arrival_entries, substrate=self.substrate,
            stage_links=self._links or None,
        )

        # candidate decision points (arrivals first among equal times, so a
        # newcomer is admitted before the policy reacts to the same instant)
        events: List[Tuple[float, str, list]] = []
        for t_a in sorted({e[2].start_time for e in arrival_entries}):
            group = [e for e in arrival_entries if e[2].start_time == t_a]
            events.append((t_a, "arrival", group))
        for t_d in self.substrate.drift_times():
            events.append((t_d, "drift", []))
        fail_times = set()
        for _, _, c in entries + arrival_entries:
            for ev in c.failures:
                # the decision never pre-dates the job: a failure timed
                # before an arrival's release is observed at the release
                fail_times.add(max(float(ev.time), c.start_time))
        # substrate-wide faults (and their repairs — restored capacity is
        # as much a re-planning trigger as lost capacity)
        fail_times.update(self.substrate.failure_times())
        for t_f in sorted(fail_times):
            events.append((t_f, "failure", []))
        events.sort(key=lambda e: (e[0], 0 if e[1] == "arrival" else 1))

        eng = open_schedule(entries, substrate=self.substrate,
                            stage_links=self._links or None)
        decisions: List[Decision] = []
        n_replans = 0
        # the charged solver cost: a fixed estimate when the config pins
        # one, otherwise the measured EMA of this run's solve times (a
        # solver key's first call in the process excluded — its set-up is
        # paid once, not per decision)
        ema = SolveTimeEMA(fixed=ocfg.solver_cost_s)

        def timed(fn, *args, **kwargs):
            """One solve on ``dev``, timed between two synchronizations
            of it (the clock must not read an unfinished launch)."""
            c0 = solver_cache_stats()["compiles"]
            synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, device=dev, **kwargs)
            synchronize(dev)
            ema.observe(time.perf_counter() - t0,
                        compiled=solver_cache_stats()["compiles"] > c0)
            return out

        def replan_solo(kind, t, sub_t, snap, injected):
            """Solo decision path: every live job re-planned independently
            — but solved as ONE batched solve per barrier group (same
            shapes batch into one program), with per-job seeds as a
            sequential loop would draw them."""
            nonlocal n_replans
            live = [jp for jp in snap.jobs
                    if not jp.done and jp.job not in injected]
            if not live:
                return
            runs = [eng.runs[jp.job] for jp in live]
            views = [
                sub_t.view(g.p.D, g.p.alpha, name=f"{g.p.name}@{t:g}s")
                for g in runs
            ]
            befores = [
                CostModel(view, g.cfg.barriers).residual_makespan(jp, g.plan)
                for view, g, jp in zip(views, runs, live)
            ]
            seeds = [seed + 977 * (n_replans + 1 + i)
                     for i in range(len(live))]
            n_replans += len(live)
            results: List[Optional[PlanResult]] = [None] * len(live)
            by_barriers: Dict[str, List[int]] = {}
            for i, g in enumerate(runs):
                by_barriers.setdefault(g.cfg.barriers, []).append(i)
            for barriers, idxs in by_barriers.items():
                group = timed(
                    replan_batch,
                    [views[i] for i in idxs], [runs[i].plan for i in idxs],
                    progresses=[live[i] for i in idxs], barriers=barriers,
                    n_restarts=n_restarts, steps=steps,
                    seeds=[seeds[i] for i in idxs],
                    incremental=ocfg.incremental,
                )
                for i, res in zip(idxs, group):
                    results[i] = res
            for jp, g, view, before, res in zip(
                live, runs, views, befores, results
            ):
                charge = 0.0
                if res.plan is g.plan:
                    # the incumbent won: replan only returns a different
                    # object when it is strictly better in float64
                    action = "keep"
                elif ocfg.hysteresis == 0.0:
                    eng.swap_plan(jp.job, res.plan)
                    action = "swap"
                else:
                    # cost-aware solo policy: the same hysteresis gate the
                    # shared path applies
                    charge = swap_charge(view, jp, g.plan, res.plan,
                                         ema.charge_s())
                    savings = before - res.makespan
                    if np.isfinite(ocfg.hysteresis) \
                            and savings > ocfg.hysteresis * charge:
                        eng.swap_plan(jp.job, res.plan)
                        action = "swap"
                    else:
                        action = "reject"
                decisions.append(Decision(
                    time=t, event=kind, job=jp.job, action=action,
                    modeled_before=before,
                    modeled_after=(before if action == "reject"
                                   else res.makespan),
                    charge=charge,
                ))

        def co_replan(kind, t, sub_t, snap, fresh=frozenset()):
            """Schedule-aware decision: co-replan every live job's residual
            jointly, then adopt the stack **as a unit** iff its aggregate
            modeled savings clear the hysteresis-weighted total charge.
            The stack's pricing (and its never-modeled-worse guarantee) is
            joint, so partial adoption would execute a mix the solver never
            scored — and a sacrificial swap that worsens one job's own span
            to cut the bottleneck's must not be vetoed job-by-job.
            ``fresh`` holds job indices injected at this very instant —
            their queued bytes have not begun moving, so they contribute no
            data-movement charge (like the solo arrival path)."""
            nonlocal n_replans
            live = snap.residual_view()
            if not live:
                return
            incumbents = [eng.runs[idx].plan for idx, _ in live]
            progs = [jp for _, jp in live]
            n_replans += 1
            res = timed(
                replan_schedule, sub_t, incumbents, progs,
                barriers=result.barriers, n_restarts=n_restarts,
                steps=steps, seed=seed + 977 * n_replans,
                incremental=ocfg.incremental,
            )
            # replan_schedule returns either the incumbent objects (the
            # stack won) or one whole new stack — changed is all-or-nothing
            changed = [slot for slot in range(len(live))
                       if res.plans[slot] is not incumbents[slot]]
            charges = [0.0] * len(live)
            for slot in changed:
                idx, jp = live[slot]
                move = 0.0 if idx in fresh else swap_charge(
                    sub_t, jp, incumbents[slot], res.plans[slot],
                    solver_cost_s=0.0,
                )
                # one joint solve serves every job: its wall-clock charge
                # is counted once, pro-rated across the changed records
                charges[slot] = move + ema.charge_s() / len(changed)
            before_spans = list(res.before)
            after_spans = list(res.after)
            savings = max(res.before) - res.makespan
            strictly_better = bool(changed)
            if changed and ocfg.candidate_pricing == "fluid":
                # fluid-rollout gate: price BOTH stacks with the same
                # drift-aware float64 fluid drain from this instant, and
                # adopt only on a strict fluid improvement — the
                # incumbent competes under the pricing in force, so the
                # never-priced-worse guarantee survives the switch
                f_entries = [
                    (eng.runs[idx].p, incumbents[slot],
                     eng.runs[idx].cfg, jp)
                    for slot, (idx, jp) in enumerate(live)
                ]
                f_before = fluid_score_residual(
                    self.substrate, f_entries, now=t
                )
                f_after = fluid_score_residual(
                    self.substrate,
                    [(p, res.plans[slot], c, jp)
                     for slot, (p, _, c, jp) in enumerate(f_entries)],
                    now=t,
                )
                before_spans, after_spans = f_before, f_after
                savings = max(f_before) - max(f_after)
                strictly_better = max(f_after) < max(f_before)
            adopt = bool(
                changed and strictly_better
                and np.isfinite(ocfg.hysteresis)
                and savings > ocfg.hysteresis * sum(charges)
            )
            for slot, (idx, jp) in enumerate(live):
                if slot not in changed:
                    decisions.append(Decision(
                        time=t, event=kind, job=idx, action="keep",
                        modeled_before=before_spans[slot],
                        modeled_after=before_spans[slot],
                    ))
                    continue
                if adopt:
                    eng.swap_plan(idx, res.plans[slot])
                decisions.append(Decision(
                    time=t, event=kind, job=idx,
                    action="swap" if adopt else "reject",
                    modeled_before=before_spans[slot],
                    modeled_after=(after_spans[slot] if adopt
                                   else before_spans[slot]),
                    charge=charges[slot],
                ))

        ei = 0
        next_tick = replan_dt
        while True:
            t_next, kind, payload = None, None, []
            if ei < len(events):
                t_next, kind, payload = events[ei]
            if next_tick is not None and (t_next is None or next_tick < t_next):
                t_next, kind, payload = next_tick, "tick", []
            if t_next is None:
                break
            more_arrivals = any(k == "arrival" for _, k, _ in events[ei:])
            if eng.finished and not more_arrivals:
                break  # nothing left to steer; ticks would spin forever
            # a failure decision must observe the failure itself: drain the
            # events AT the instant before snapshotting (arrivals instead
            # act before same-time events, matching the offline seed order)
            eng.run_until(t_next, inclusive=(kind == "failure"))
            if kind == "tick":
                next_tick = t_next + replan_dt
            else:
                ei += 1
            snap = eng.snapshot()
            decide = policy_fn(kind, snap)
            sub_t = self.substrate.at(t_next) if (decide or payload) \
                else self.substrate
            injected = set()
            if kind == "arrival":
                for platform, frozen, acfg in payload:
                    view = sub_t.view(platform.D, platform.alpha,
                                      name=f"{platform.name}@{t_next:g}s")
                    cm_t = CostModel(view, acfg.barriers)
                    plan = frozen
                    arrival_charge, arrival_rejected = 0.0, None
                    if decide and not ocfg.shared and gate_open:
                        # plan the newcomer against the capacities in force
                        # (solo path; the shared path injects the frozen
                        # plan and lets the joint co-replan — which models
                        # the newcomer's contention — steer it, gated by
                        # the same hysteresis as everyone else).  The
                        # newcomer has nothing queued yet, so its charge is
                        # the solver estimate alone.
                        res = timed(
                            replan, view, frozen, progress=None,
                            barriers=acfg.barriers, n_restarts=n_restarts,
                            steps=steps, seed=seed + 977 * len(decisions),
                            incremental=ocfg.incremental,
                        )
                        if res.plan is not frozen:
                            if (cm_t.makespan(frozen) - res.makespan
                                    > ocfg.hysteresis * ema.charge_s()):
                                plan = res.plan
                                # charged only under cost-aware gating, so
                                # hysteresis=0 keeps its zero-charge records
                                if ocfg.hysteresis > 0:
                                    arrival_charge = ema.charge_s()
                            else:
                                arrival_rejected = ema.charge_s()
                    idx = eng.inject([(platform, plan, acfg)])[0]
                    injected.add(idx)
                    before = cm_t.makespan(frozen)
                    decisions.append(Decision(
                        time=t_next, event="arrival", job=idx,
                        action="inject", modeled_before=before,
                        modeled_after=(before if plan is frozen
                                       else cm_t.makespan(plan)),
                        charge=arrival_charge,
                    ))
                    if arrival_rejected is not None:
                        # the gate declined the newcomer's better plan: on
                        # the record, like any other rejected candidate
                        decisions.append(Decision(
                            time=t_next, event="arrival", job=idx,
                            action="reject", modeled_before=before,
                            modeled_after=before, charge=arrival_rejected,
                        ))
            if decide and gate_open and kind == "failure" \
                    and ocfg.speculation is not None:
                # the policy's fault-reaction knob: flip speculative
                # execution for every live job the instant a failure is
                # observed (recovery traffic creates the stragglers
                # speculation hedges)
                for jp in snap.jobs:
                    if not jp.done and jp.released:
                        eng.set_speculation(jp.job, ocfg.speculation)
            if decide and gate_open:
                if injected:
                    snap = eng.snapshot()  # include the newcomers' state
                if ocfg.shared:
                    # newcomers are NOT skipped here: the joint residual
                    # objective prices their contention alongside everyone
                    # else's, which is the point of co-replanning
                    co_replan(kind, t_next, sub_t, snap, fresh=injected)
                else:
                    replan_solo(kind, t_next, sub_t, snap, injected)

        sim = eng.run()
        return OnlineReport(
            policy=policy,
            sim=sim,
            static_sim=static_sim,
            decisions=tuple(decisions),
            plans=tuple(g.plan for g in eng.runs),
            barriers=result.barriers,
        )
