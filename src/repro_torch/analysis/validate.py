"""Static structural validation of planner/executor inputs.

The solvers and the executor assume their matrix inputs are *well-formed*:
plan rows are simplexes, capacities are finite and strictly positive, byte
volumes are finite and non-negative, and a pipeline stage's shape couples
to its upstream stages (reducer ``r`` feeds source ``r``).  Violations used
to surface deep inside ``_adam_anneal`` or the event loop as NaN makespans
or broadcast errors; the checkers here fail **at construction** with a
message naming the offending entry.

This module is deliberately a *leaf*: it imports numpy only, so the core
model modules (:mod:`repro.core.plan`, :mod:`repro.core.platform`,
:mod:`repro.core.makespan`) and the :mod:`repro.api` front door can all
share it without an import cycle.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "require_finite",
    "require_nonnegative",
    "require_positive",
    "require_row_stochastic",
    "validate_capacities",
    "validate_plan_arrays",
    "validate_plan_shapes",
    "validate_stage_coupling",
    "validate_volumes",
]


def _offenders(mask: np.ndarray, limit: int = 4) -> str:
    """The first few offending indices of a boolean mask, for messages."""
    idx = np.argwhere(np.asarray(mask))
    shown = ", ".join(str(tuple(int(v) for v in row)) for row in idx[:limit])
    more = f" (+{len(idx) - limit} more)" if len(idx) > limit else ""
    return f"at {shown}{more}"


def require_finite(name: str, arr) -> np.ndarray:
    """``arr`` as float64, raising if any entry is NaN or infinite."""
    arr = np.asarray(arr, dtype=np.float64)
    bad = ~np.isfinite(arr)
    if np.any(bad):
        raise ValueError(
            f"{name} contains non-finite entries {_offenders(bad)}"
        )
    return arr


def require_nonnegative(name: str, arr, atol: float = 0.0) -> np.ndarray:
    """Finite and ``>= -atol`` everywhere."""
    arr = require_finite(name, arr)
    bad = arr < -atol
    if np.any(bad):
        raise ValueError(
            f"{name} contains negative entries {_offenders(bad)}"
        )
    return arr


def require_positive(name: str, arr) -> np.ndarray:
    """Finite and strictly positive everywhere (a capacity of 0 or NaN
    turns into a division blow-up inside the phase equations)."""
    arr = require_finite(name, arr)
    bad = arr <= 0
    if np.any(bad):
        raise ValueError(f"{name} must be strictly positive {_offenders(bad)}")
    return arr


def require_row_stochastic(
    name: str, arr, atol: float = 1e-6
) -> np.ndarray:
    """Finite, entries in ``[0, 1]`` and rows summing to 1 (a 1-D array is
    one row — the shuffle simplex ``y``)."""
    arr = require_finite(name, arr)
    if np.any(arr < -atol) or np.any(arr > 1 + atol):
        bad = (arr < -atol) | (arr > 1 + atol)
        raise ValueError(
            f"{name} fractions outside [0, 1] {_offenders(bad)}"
        )
    sums = arr.sum(axis=-1)
    if not np.allclose(sums, 1.0, atol=atol):
        raise ValueError(
            f"{name} rows do not sum to 1: {np.atleast_1d(sums)}"
        )
    return arr


def validate_plan_shapes(
    plan_dims: Tuple[int, int, int],
    platform_dims: Tuple[int, int, int],
    context: str = "plan",
) -> None:
    """A plan's ``(nS, nM, nR)`` must match its platform's — adopted plans
    from another platform used to fail later as broadcast errors deep in
    pricing or the executor."""
    if tuple(plan_dims) != tuple(platform_dims):
        raise ValueError(
            f"{context} shape (nS, nM, nR)={tuple(plan_dims)} does not match "
            f"the platform's {tuple(platform_dims)}"
        )


def validate_plan_arrays(x, y, atol: float = 1e-6) -> None:
    """Equations 1–3 plus finiteness: ``x`` a (nS, nM) row-stochastic
    matrix, ``y`` an (nR,) simplex."""
    x = np.asarray(x)
    y = np.asarray(y)
    if x.ndim != 2 or y.ndim != 1:
        raise ValueError(f"bad plan shapes x{x.shape} y{y.shape}")
    require_row_stochastic("x", x, atol=atol)
    require_row_stochastic("y", y, atol=atol)


def validate_capacities(
    B_sm, B_mr, C_m, C_r, D=None, context: str = "platform"
) -> None:
    """Finite, strictly-positive capacity arrays with coupled shapes, plus
    an optional finite non-negative data vector ``D``."""
    B_sm = require_positive(f"{context}.B_sm", B_sm)
    B_mr = require_positive(f"{context}.B_mr", B_mr)
    C_m = require_positive(f"{context}.C_m", C_m)
    C_r = require_positive(f"{context}.C_r", C_r)
    nS, nM = B_sm.shape
    nM2, nR = B_mr.shape
    if nM != nM2:
        raise ValueError(
            f"{context}: B_sm/B_mr mapper dims disagree: {nM} vs {nM2}"
        )
    if C_m.shape != (nM,):
        raise ValueError(f"{context}: C_m shape {C_m.shape} != ({nM},)")
    if C_r.shape != (nR,):
        raise ValueError(f"{context}: C_r shape {C_r.shape} != ({nR},)")
    if D is not None:
        D = require_nonnegative(f"{context}.D", D)
        if D.shape != (nS,):
            raise ValueError(f"{context}: D shape {D.shape} != ({nS},)")


def validate_volumes(
    V_push, V_map, V_shuffle, V_reduce,
    dims: Optional[Tuple[int, int, int]] = None,
    atol: float = 1e-9,
) -> None:
    """Per-phase byte volumes must be finite and non-negative (and, when
    ``dims`` is given, shaped like the platform) before they are priced —
    a NaN volume otherwise propagates silently into every phase end.
    ``atol`` absorbs the ~1e-18 MB negatives that residual-snapshot
    subtraction can leave behind."""
    V_push = require_nonnegative("V_push", V_push, atol=atol)
    V_map = require_nonnegative("V_map", V_map, atol=atol)
    V_shuffle = require_nonnegative("V_shuffle", V_shuffle, atol=atol)
    V_reduce = require_nonnegative("V_reduce", V_reduce, atol=atol)
    if dims is not None:
        nS, nM, nR = dims
        want = {
            "V_push": ((nS, nM), V_push.shape),
            "V_map": ((nM,), V_map.shape),
            "V_shuffle": ((nM, nR), V_shuffle.shape),
            "V_reduce": ((nR,), V_reduce.shape),
        }
        for name, (expect, got) in want.items():
            if got != expect:
                raise ValueError(
                    f"{name} shape {got} does not match the platform's "
                    f"{expect}"
                )


def validate_stage_coupling(
    stage: int, nS: int, nR: int, deps: Sequence[int], n_stages: int
) -> None:
    """A dependent pipeline stage's sources are its upstream reducer nodes,
    so it needs ``nS == nR``; dep indices must name existing, distinct,
    non-self stages."""
    deps = [int(d) for d in deps]
    if len(set(deps)) != len(deps):
        raise ValueError(f"stage {stage} has duplicate deps {tuple(deps)}")
    for d in deps:
        if not 0 <= d < n_stages:
            raise ValueError(
                f"stage {stage} depends on unknown stage {d} "
                f"(pipeline has {n_stages} stages)"
            )
        if d == stage:
            raise ValueError(f"stage {stage} depends on itself")
    if deps and nS != nR:
        raise ValueError(
            f"stage {stage} has upstream deps but nS={nS} != nR={nR} — a "
            "dependent stage's sources must be the upstream reducer nodes"
        )
