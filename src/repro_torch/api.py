"""`GeoJob` — the planning/execution facade, on the port.

The single-job slice of :mod:`repro.api`: model a platform, optimize a
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
``mode``.  Multi-job schedules, online control and pipelines are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ._device import DeviceLike
from .analysis.validate import validate_plan_shapes
from .core.makespan import BARRIERS_GGL, CostModel
from .core.optimize import PlanResult, available_modes, optimize_plan
from .core.plan import ExecutionPlan, uniform_plan
from .core.platform import Platform
from .core.simulate import SimConfig, SimResult, simulate
from .mapreduce.engine import GeoMapReduce, MRApp, PhaseStats, Records

__all__ = ["GeoJob", "JobReport", "split_sources"]


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
