"""Execution plans (paper §2.2): push fractions ``x_ij`` and shuffle
fractions ``y_k``.

A valid plan satisfies Equations 1–3 of the paper:

  (1) 0 ≤ x_ij ≤ 1
  (2) each node's outgoing fractions sum to 1
  (3) one-reducer-per-key: every mapper uses the same shuffle row,
      ``x_jk = y_k`` — so the shuffle side of a plan is a single simplex
      vector ``y`` of length nR.

Plans here are *dense* (every source may talk to every mapper); heuristic
constructors give the paper's baselines (uniform, local push).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..analysis.validate import validate_plan_arrays
from .platform import Platform

__all__ = ["ExecutionPlan", "uniform_plan", "local_push_plan", "validate_plan"]

_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A valid execution plan: ``x[i, j]`` push fractions, ``y[k]`` shuffle
    fractions (shared across mappers per the one-reducer-per-key constraint).
    """

    x: np.ndarray  # (nS, nM)
    y: np.ndarray  # (nR,)
    meta: str = ""

    def __post_init__(self):
        object.__setattr__(self, "x", np.asarray(self.x, dtype=np.float64))
        object.__setattr__(self, "y", np.asarray(self.y, dtype=np.float64))
        validate_plan(self.x, self.y)

    @property
    def nS(self) -> int:
        return self.x.shape[0]

    @property
    def nM(self) -> int:
        return self.x.shape[1]

    @property
    def nR(self) -> int:
        return self.y.shape[0]

    @classmethod
    def renormalized(cls, x, y, meta: str = "") -> "ExecutionPlan":
        """Build a plan from near-simplex candidates (e.g. float32 softmax
        output of the annealed solvers): clip negatives and renormalize the
        rows of ``x`` and ``y`` in float64 so the plan validates exactly."""
        x = np.clip(np.asarray(x, dtype=np.float64), 0.0, None)
        x = x / x.sum(axis=1, keepdims=True)
        y = np.clip(np.asarray(y, dtype=np.float64), 0.0, None)
        y = y / y.sum()
        return cls(x=x, y=y, meta=meta)

    def x_mr(self) -> np.ndarray:
        """The full (nM, nR) shuffle matrix implied by Equation 3."""
        return np.broadcast_to(self.y[None, :], (self.nM, self.nR)).copy()

    def map_load(self, platform: Platform) -> np.ndarray:
        """MB of input data arriving at each mapper."""
        return self.x.T @ platform.D

    def reduce_load(self, platform: Platform) -> np.ndarray:
        """MB of intermediate data arriving at each reducer."""
        return platform.alpha * float(self.map_load(platform).sum()) * self.y


def validate_plan(x: np.ndarray, y: np.ndarray, atol: float = _ATOL) -> None:
    """Equations 1–3 plus finiteness — the shared structural checker in
    :mod:`repro.analysis.validate`, which names the offending entries."""
    validate_plan_arrays(x, y, atol=atol)


def uniform_plan(platform: Platform) -> ExecutionPlan:
    """Uniform data placement (paper Equations 15/16)."""
    x = np.full((platform.nS, platform.nM), 1.0 / platform.nM)
    y = np.full(platform.nR, 1.0 / platform.nR)
    return ExecutionPlan(x=x, y=y, meta="uniform")


def local_push_plan(
    platform: Platform, y: Optional[np.ndarray] = None
) -> ExecutionPlan:
    """Each source pushes all data to mappers in its own cluster (uniformly
    across them); shuffle defaults to uniform.  This is Hadoop's
    data-locality baseline generalized to the wide area (paper §4.6.1).
    """
    x = np.zeros((platform.nS, platform.nM))
    for i in range(platform.nS):
        local = np.flatnonzero(platform.cluster_m == platform.cluster_s[i])
        if local.size == 0:  # no local mapper: fall back to best link
            local = np.array([int(np.argmax(platform.B_sm[i]))])
        x[i, local] = 1.0 / local.size
    if y is None:
        y = np.full(platform.nR, 1.0 / platform.nR)
    return ExecutionPlan(x=x, y=np.asarray(y), meta="local_push")
