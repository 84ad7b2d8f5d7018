"""Multi-stage pipelines: DAGs of MapReduce stages over one substrate.

Real geo-analytics workloads are rarely a single MapReduce job — they are
chains (and DAGs) of stages where one stage's reduce output is the next
stage's source data.  This module is the *plan layer* of that extension:

* :class:`StageSpec` — one stage: its platform view (``D`` is authoritative
  only for root stages), the upstream stages feeding it, and the stage's
  reduce-output scale (output MB per reduce-input MB).
* :class:`PipelineSpec` — the validated stage DAG: upstream indices must
  form an acyclic graph (cycles are rejected at construction), every stage
  must live on the same :class:`~repro.core.platform.Substrate`, and a
  dependent stage requires ``nS == nR`` so that upstream reducer ``r`` is
  downstream source ``r`` (each substrate node hosts one source, one
  mapper, one reducer — the layout every generator in
  :mod:`repro.core.platform` produces).

The *cross-stage coupling* lives in :meth:`PipelineSpec.derived_D`: a
downstream stage's source vector is a function of its upstream stages'
shuffle fractions ``y`` — placing stage ``k``'s reducers decides where
stage ``k+1``'s data sits.  A stagewise-greedy planner ignores that
coupling (it places stage-``k`` reducers where stage ``k`` finishes
fastest, even when that strands stage ``k+1``'s input behind slow
backbone links); the ``end_to_end`` pipeline planner in
:mod:`repro.core.optimize` differentiates straight through it.  Pricing
lives in :meth:`repro.core.makespan.CostModel.price_pipeline`; execution
(with real per-source release gating) in :mod:`repro.core.simulate`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.validate import validate_stage_coupling
from .plan import ExecutionPlan
from .platform import Platform, Substrate

__all__ = ["PipelineSpec", "StageSpec", "chain_spec"]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a pipeline: a MapReduce job plus its upstream edges.

    Attributes:
      platform:  the stage's substrate view.  ``platform.D`` is the stage's
                 source data only for *root* stages (no ``deps``); for a
                 dependent stage the effective ``D`` is derived from the
                 upstream stages' reduce output (see
                 :meth:`PipelineSpec.derived_D`) and the view's own ``D``
                 is ignored.
      deps:      indices of the upstream stages whose reduce output feeds
                 this stage (source ``s`` receives upstream reducer ``s``'s
                 output).
      out_scale: reduce-output MB per reduce-input MB of this stage — the
                 reduce-side analogue of ``alpha`` (1.0: the reducers emit
                 what they ingest, e.g. a sort; 0.1: a 10x aggregation).
      name:      label for reports.
    """

    platform: Platform
    deps: Tuple[int, ...] = ()
    out_scale: float = 1.0
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "deps", tuple(int(d) for d in self.deps))
        if self.out_scale < 0:
            raise ValueError(f"out_scale must be >= 0, got {self.out_scale}")
        if len(set(self.deps)) != len(self.deps):
            raise ValueError(f"duplicate deps {self.deps}")

    @property
    def alpha(self) -> float:
        """The stage's map expansion factor (read off its platform view)."""
        return float(self.platform.alpha)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A validated DAG of :class:`StageSpec`\\ s over one substrate."""

    stages: Tuple[StageSpec, ...]

    def __post_init__(self):
        stages = tuple(self.stages)
        object.__setattr__(self, "stages", stages)
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        n = len(stages)
        sub = Substrate.of(stages[0].platform)
        for k, stage in enumerate(stages):
            if not sub.compatible(Substrate.of(stage.platform)):
                raise ValueError(
                    f"stage {k} ({stage.platform.name!r}) does not share the "
                    "substrate — build stage platforms with Substrate.view()"
                )
            validate_stage_coupling(
                k, stage.platform.nS, stage.platform.nR, stage.deps, n
            )
        object.__setattr__(self, "_topo", self._toposort())

    # -- structure ---------------------------------------------------------
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def substrate(self) -> Substrate:
        return Substrate.of(self.stages[0].platform)

    def _toposort(self) -> Tuple[int, ...]:
        """Kahn topological order; raises on cycles."""
        n = len(self.stages)
        indeg = [len(s.deps) for s in self.stages]
        children: List[List[int]] = [[] for _ in range(n)]
        for k, stage in enumerate(self.stages):
            for d in stage.deps:
                children[d].append(k)
        order = [k for k in range(n) if indeg[k] == 0]
        head = 0
        while head < len(order):
            for c in children[order[head]]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    order.append(c)
            head += 1
        if len(order) != n:
            cyclic = sorted(set(range(n)) - set(order))
            raise ValueError(
                f"pipeline stage graph has a cycle through stages {cyclic}"
            )
        return tuple(order)

    def topo_order(self) -> Tuple[int, ...]:
        """Stage indices in dependency order (upstream before downstream)."""
        return self._topo

    def children(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-stage downstream stage indices (the transpose of ``deps``)."""
        out: List[List[int]] = [[] for _ in self.stages]
        for k, stage in enumerate(self.stages):
            for d in stage.deps:
                out[d].append(k)
        return tuple(tuple(c) for c in out)

    def sinks(self) -> Tuple[int, ...]:
        """Stages no other stage consumes (the pipeline's outputs)."""
        consumed = {d for s in self.stages for d in s.deps}
        return tuple(k for k in range(len(self.stages)) if k not in consumed)

    # -- cross-stage data coupling ----------------------------------------
    def derived_D(
        self, plans: Sequence[ExecutionPlan]
    ) -> List[np.ndarray]:
        """Each stage's effective source vector (MB) under ``plans``.

        Root stages keep their platform's ``D``.  A dependent stage's
        source ``s`` receives every upstream stage ``u``'s reduce output at
        reducer ``s``: ``out_scale_u · alpha_u · total_u · y_u[s]`` where
        ``total_u`` is stage ``u``'s total map input (== its own derived
        ``D`` summed, since push fractions conserve volume).  This is the
        inter-stage coupling — downstream ``D`` is a function of upstream
        ``y`` — that end-to-end pipeline planning differentiates through
        and stagewise planning ignores.
        """
        if len(plans) != len(self.stages):
            raise ValueError(
                f"one plan per stage, got {len(plans)} plans for "
                f"{len(self.stages)} stages"
            )
        out: List[Optional[np.ndarray]] = [None] * len(self.stages)
        for k in self._topo:
            stage = self.stages[k]
            if not stage.deps:
                out[k] = np.asarray(stage.platform.D, dtype=np.float64).copy()
                continue
            D = np.zeros(stage.platform.nS, dtype=np.float64)
            for u in stage.deps:
                up = self.stages[u]
                total_u = float(out[u].sum())
                D += (
                    up.out_scale * up.alpha * total_u
                    * np.asarray(plans[u].y, dtype=np.float64)
                )
            out[k] = D
        return list(out)  # type: ignore[arg-type]

    def stage_platforms(
        self, plans: Sequence[ExecutionPlan]
    ) -> List[Platform]:
        """Per-stage platform views carrying the derived ``D`` — what the
        cost model prices and the facade adopts after planning."""
        sub = self.substrate
        return [
            sub.view(D, stage.alpha,
                     name=stage.name or f"{sub.name}/stage{k}")
            for k, (stage, D) in enumerate(
                zip(self.stages, self.derived_D(plans))
            )
        ]


def chain_spec(
    platforms: Sequence[Platform],
    out_scales: Optional[Sequence[float]] = None,
    names: Optional[Sequence[str]] = None,
) -> PipelineSpec:
    """A linear pipeline: stage ``k+1`` consumes stage ``k``'s reduce
    output — the dominant multi-stage shape (iterated MapReduce)."""
    if out_scales is None:
        out_scales = [1.0] * len(platforms)
    if names is None:
        names = [f"stage{k}" for k in range(len(platforms))]
    if not (len(platforms) == len(out_scales) == len(names)):
        raise ValueError("platforms, out_scales and names must align")
    stages = [
        StageSpec(
            platform=p,
            deps=(k - 1,) if k else (),
            out_scale=float(out_scales[k]),
            name=str(names[k]),
        )
        for k, p in enumerate(platforms)
    ]
    return PipelineSpec(stages=tuple(stages))
