"""The paper's MIP linearization (§2.3), implemented as a *verifier*.

The paper removes two nonlinearities to obtain a Mixed Integer Program:

1. ``max`` operators become bound constraints (``max_i z_i = Z`` →
   ``∀i: z_i ≤ Z`` with ``Z`` minimized).  This transform is exact.
2. Bilinear terms ``x_ij · y_k`` (shuffle/reduce loads) are rewritten in
   separable form ``w² − w'²`` with ``w = (x+y)/2``, ``w' = (x−y)/2``, and
   each quadratic is replaced by a piecewise-linear approximation over ~9
   segments (the paper reports a worst-case deviation of 4.15%).

A Gurobi-class MIP solver is unavailable in this environment (and
un-JAX-like), so we do not *solve* the MIP here — plan search is done by the
annealed gradient solver in :mod:`repro.core.optimize`, validated by brute
force.  What this module establishes is that the paper's *linearization is a
faithful stand-in for the exact model*: ``linearized_makespan`` evaluates the
model with every bilinear term routed through the separable piecewise-linear
approximation, and the tests check it tracks the exact model within the
paper's reported tolerance on random plans and platforms.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .makespan import BARRIERS_ALL_GLOBAL, makespan
from .plan import ExecutionPlan
from .platform import Platform

__all__ = [
    "pwl_square",
    "separable_product",
    "linearized_makespan",
    "worst_case_pwl_deviation",
]


def pwl_square(w: np.ndarray, lo: float, hi: float, segments: int = 9) -> np.ndarray:
    """Piecewise-linear (chord) approximation of ``w²`` over ``[lo, hi]``.

    The chord approximation is what an LP/MIP expresses with convex
    combination (lambda) variables; evaluating it directly is equivalent to
    the MIP's choice of the active segment.
    """
    w = np.asarray(w, dtype=np.float64)
    knots = np.linspace(lo, hi, segments + 1)
    vals = knots**2
    idx = np.clip(np.searchsorted(knots, w, side="right") - 1, 0, segments - 1)
    w0, w1 = knots[idx], knots[idx + 1]
    f0, f1 = vals[idx], vals[idx + 1]
    t = np.where(w1 > w0, (w - w0) / np.where(w1 > w0, w1 - w0, 1.0), 0.0)
    return f0 + t * (f1 - f0)


def separable_product(
    x: np.ndarray, y: np.ndarray, segments: int = 9
) -> np.ndarray:
    """The paper's separable-form product: ``x·y = w² − w'²`` with both
    quadratics piecewise-linearized.  ``x``/``y`` broadcast; both in [0, 1].
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w = 0.5 * (x + y)  # in [0, 1]
    wp = 0.5 * (x - y)  # in [-0.5, 0.5]
    return pwl_square(w, 0.0, 1.0, segments) - pwl_square(wp, -0.5, 0.5, segments)


def worst_case_pwl_deviation(segments: int = 9, n: int = 100_001) -> float:
    """Max absolute deviation of the separable PWL product from the true
    product over a dense grid of ``(x, y) ∈ [0,1]²``."""
    g = np.linspace(0.0, 1.0, int(np.sqrt(n)))
    X, Y = np.meshgrid(g, g)
    approx = separable_product(X, Y, segments)
    return float(np.max(np.abs(approx - X * Y)))


def linearized_makespan(
    platform: Platform,
    plan: ExecutionPlan,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    segments: int = 9,
) -> float:
    """Makespan with every bilinear ``x_ij·y_k`` term evaluated through the
    paper's separable piecewise-linear approximation (global barriers follow
    Equations 4–11; relaxed barriers follow 12–14)."""
    D, B_sm, B_mr, C_m, C_r, alpha = platform.as_arrays()
    x, y = plan.x, plan.y
    b_pm, b_ms, b_sr = barriers

    push_end = np.max((D[:, None] * x) / B_sm, axis=0)
    map_in = x.T @ D
    map_time = map_in / C_m
    map_start = np.full_like(push_end, push_end.max()) if b_pm == "G" else push_end
    map_end = (
        np.maximum(map_start, map_time) if b_pm == "P" else map_start + map_time
    )

    # shuffle load uses the linearized product: D_i * lin(x_ij, y_k)
    # summed over i — this is exactly the term the paper linearizes (Eq 8).
    lin_xy = separable_product(x[:, :, None], y[None, None, :], segments)
    load_jk = alpha * np.einsum("i,ijk->jk", D, lin_xy)  # (nM, nR)
    shuffle_t = load_jk / B_mr
    shuffle_start = (
        np.full_like(map_end, map_end.max()) if b_ms == "G" else map_end
    )
    if b_ms == "P":
        shuffle_end = np.max(np.maximum(shuffle_start[:, None], shuffle_t), axis=0)
    else:
        shuffle_end = np.max(shuffle_start[:, None] + shuffle_t, axis=0)

    reduce_time = load_jk.sum(axis=0) / C_r
    reduce_start = (
        np.full_like(shuffle_end, shuffle_end.max()) if b_sr == "G" else shuffle_end
    )
    reduce_end = (
        np.maximum(reduce_start, reduce_time)
        if b_sr == "P"
        else reduce_start + reduce_time
    )
    return float(reduce_end.max())


def linearization_gap(
    platform: Platform,
    plan: ExecutionPlan,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    segments: int = 9,
) -> float:
    """Relative |linearized − exact| / exact for one plan."""
    exact = makespan(platform, plan, barriers)
    lin = linearized_makespan(platform, plan, barriers, segments)
    return abs(lin - exact) / max(exact, 1e-12)
