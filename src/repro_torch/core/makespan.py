"""Makespan model (paper §2.2, Equations 4–14) and the shared cost model.

The model computes the end-to-end completion time of a MapReduce job for a
given platform, execution plan, and **barrier configuration**.  Each of the
three phase boundaries (push/map, map/shuffle, shuffle/reduce) is one of:

* ``'G'`` — global barrier: every node finishes the previous phase before any
  node starts the next (Equations 4–11).
* ``'L'`` — local barrier: a node starts the next phase as soon as *it* has
  all its inputs; the combination operator ``⊕`` is ``+`` (Equations 12–14).
* ``'P'`` — pipelined: a node starts as soon as the first byte arrives;
  ``⊕`` is ``max``.

The phase equations live in exactly one place — :func:`volume_model`, which
prices explicit per-phase data volumes (MB) through the platform's
bandwidths and compute rates.  Two front ends share it:

* the **analytic** path derives volumes from a plan (``D_i·x_ij`` etc.) —
  :func:`phase_model` for the differentiable torch optimizer,
  :class:`CostModel` (numpy, float64) for exact evaluation;
* the **measured** path prices byte matrices recorded by the execution
  engine (:meth:`CostModel.price_volumes`) — so model and measurement can
  never diverge.

``tau`` selects the max operator: ``tau=None`` (or 0) uses the exact hard
``max`` (use this for *evaluating* a plan); ``tau > 0`` uses the smooth
upper bound ``tau·logsumexp(v/tau)`` so that gradients flow into every
branch of the max (use this for *optimizing* a plan, annealing ``tau → 0``).

Times are expressed in seconds for platforms built by
:mod:`repro_torch.core.platform` (MB and MB/s units).

This is the port of :mod:`repro.core.makespan`: the float64 numpy half is
the reference's code unchanged; the differentiable half (the max ops,
:func:`phase_model`, :func:`makespan_model`) runs on torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

from ..analysis.validate import validate_volumes
from .plan import ExecutionPlan
from .platform import Platform

__all__ = [
    "BARRIERS_GGL",
    "BARRIERS_ALL_GLOBAL",
    "BARRIERS_ALL_PIPELINED",
    "CostModel",
    "JobProgress",
    "analytic_volumes",
    "attribute_phases",
    "makespan",
    "makespan_model",
    "phase_breakdown",
    "replication_matrix",
    "residual_volumes",
    "shared_effective_volumes",
    "volume_model",
]

#: Hadoop's effective configuration (paper §4.6.1): global push/map barrier
#: (separate DistCP-like push job), pipelined map/shuffle, local
#: shuffle/reduce barrier.
BARRIERS_GGL: Tuple[str, str, str] = ("G", "G", "L")
BARRIERS_ALL_GLOBAL: Tuple[str, str, str] = ("G", "G", "G")
BARRIERS_ALL_PIPELINED: Tuple[str, str, str] = ("P", "P", "P")

_VALID = frozenset("GLP")


def _check_barriers(barriers: Tuple[str, str, str]) -> Tuple[str, str, str]:
    barriers = tuple(barriers)
    if len(barriers) != 3 or any(b not in _VALID for b in barriers):
        raise ValueError(f"barriers must be a triple over G/L/P, got {barriers}")
    return barriers


def _flat(v, axis):
    """``(v, dim)`` for a torch reduction: ``axis=None`` reduces over every
    element, as numpy's and jnp's reductions do."""
    return (v.reshape(-1), 0) if axis is None else (v, axis)


def hard_ops():
    """Exact (max, pairwise-max) reduction ops."""

    def mx(v, axis=None):
        v, dim = _flat(v, axis)
        return torch.amax(v, dim=dim)

    return mx, torch.maximum


def smooth_ops(tau):
    """Smooth upper-bound ops, ``tau`` may be a tensor (annealing)."""

    def mx(v, axis=None):
        v, dim = _flat(v, axis)
        return tau * torch.logsumexp(v / tau, dim=dim)

    def pmax(a, b):
        return tau * torch.logaddexp(a / tau, b / tau)

    return mx, pmax


def volume_model(
    V_push, V_map, V_shuffle, V_reduce, B_sm, B_mr, C_m, C_r, barriers, mx, pmax, xp=torch
):
    """Phase-timing equations over explicit per-phase data volumes (MB).

    This is the single home of Equations 4–14.  ``V_push`` is the (nS, nM)
    MB pushed over each source→mapper link, ``V_map`` the (nM,) MB of map
    input per mapper, ``V_shuffle`` the (nM, nR) MB shuffled over each
    mapper→reducer link, and ``V_reduce`` the (nR,) MB of reduce input.
    The volumes may be analytic (derived from a plan) or measured (recorded
    by the execution engine) — the pricing is identical either way.

    ``xp`` selects the array module (``torch`` for the differentiable
    optimizer path, ``np`` for exact float64 evaluation); ``mx``/``pmax``
    select hard or smooth max reductions.
    """
    barriers = _check_barriers(barriers)
    b_pm, b_ms, b_sr = barriers

    def combine(op):
        # ⊕ (paper §2.2): after a G or L barrier phases run in sequence
        # (``+``); when pipelined they fully overlap (``max``).
        return (lambda a, b: a + b) if op in ("G", "L") else pmax

    # --- push phase (Equation 4) -------------------------------------------
    # push_end_j = max_i V_push_ij / B_ij
    push_t = V_push / B_sm  # (nS, nM)
    push_end = mx(push_t, axis=0)  # (nM,)

    # --- map phase (Equations 5/6 or 12) ------------------------------------
    map_time = V_map / C_m
    if b_pm == "G":
        map_start = xp.broadcast_to(mx(push_end), push_end.shape)
    else:
        map_start = push_end
    map_end = combine(b_pm)(map_start, map_time)  # (nM,)

    # --- shuffle phase (Equations 7/8 or 13) ---------------------------------
    shuffle_t = V_shuffle / B_mr  # (nM, nR)
    if b_ms == "G":
        shuffle_start = xp.broadcast_to(mx(map_end), map_end.shape)
    else:
        shuffle_start = map_end
    shuffle_end = mx(combine(b_ms)(shuffle_start[:, None], shuffle_t), axis=0)  # (nR,)

    # --- reduce phase (Equations 9/10 or 14) ---------------------------------
    reduce_time = V_reduce / C_r  # (nR,)
    if b_sr == "G":
        reduce_start = xp.broadcast_to(mx(shuffle_end), shuffle_end.shape)
    else:
        reduce_start = shuffle_end
    reduce_end = combine(b_sr)(reduce_start, reduce_time)  # (nR,)

    return {
        "push_end": push_end,
        "map_end": map_end,
        "shuffle_end": shuffle_end,
        "reduce_end": reduce_end,
        "makespan": mx(reduce_end),
        "push_time": mx(push_end),
        "map_time": mx(map_time),
        "shuffle_time": mx(shuffle_t),
        "reduce_time": mx(reduce_time),
    }


def analytic_volumes(D, x, y, alpha, xp=torch, rep=None):
    """Per-phase data volumes (MB) implied by a plan: ``D_i·x_ij`` pushed,
    ``xᵀD`` mapped, ``α·map_in_j·y_k`` shuffled, ``α·Σmap_in·y`` reduced.

    ``rep`` is an optional (nM, nM) replica-routing matrix
    (:func:`replication_matrix`): push volumes are right-multiplied by it,
    so link ``(i, t)`` carries the original push plus every replica write
    the executor routes to ``t``.  Map/shuffle/reduce volumes are *not*
    inflated — replica targets store the bytes but never run map work.
    """
    V_push = D[:, None] * x  # (nS, nM)
    map_in = x.T @ D  # (nM,)
    if rep is not None:
        V_push = V_push @ rep
    V_shuffle = alpha * (map_in[:, None] * y[None, :])  # (nM, nR)
    V_reduce = alpha * xp.sum(map_in) * y  # (nR,)
    return V_push, map_in, V_shuffle, V_reduce


def replication_matrix(
    cluster_m, replication: int = 1, cross_cluster: bool = False
) -> Optional[np.ndarray]:
    """The (nM, nM) push-volume routing matrix of ``replication``-way
    writes: entry ``(j, t)`` is how many copies of a chunk destined for
    mapper ``j`` the executor writes over the source's link to ``t``
    (identity + replica fan-out).  Mirrors the executor's deterministic
    target choice (:meth:`repro.core.simulate._MultiSim._replicate`):
    replicas of mapper ``j``'s chunks go to the other mappers of ``j``'s
    cluster (or, with ``cross_cluster``, to other clusters), round-robin
    from ``j+1``.  ``V_push @ replication_matrix(...)`` is the modeled
    per-link push traffic including replica writes — the term the cost
    model was silently missing for ``SimConfig.replication > 1``.

    Returns ``None`` for ``replication == 1`` (no inflation).
    """
    if replication <= 1:
        return None
    cluster_m = np.asarray(cluster_m)
    nM = cluster_m.shape[0]
    R = np.eye(nM)
    for j in range(nM):
        if cross_cluster:
            candidates = [m for m in range(nM)
                          if cluster_m[m] != cluster_m[j]]
        else:
            candidates = [m for m in range(nM)
                          if cluster_m[m] == cluster_m[j] and m != j]
        if not candidates:
            candidates = [m for m in range(nM) if m != j]
        if not candidates:  # single-mapper substrate: nowhere to replicate
            continue
        for r in range(replication - 1):
            R[j, candidates[(j + r + 1) % len(candidates)]] += 1.0
    return R


def shared_effective_volumes(volumes, kappa: float = 0.0, xp=np):
    """Congestion-effective per-job volumes on a shared substrate.

    ``volumes`` is a sequence of per-job ``(V_push, V_map, V_shuffle,
    V_reduce)`` tuples over the *same* substrate.  When concurrent jobs
    route data through the same link or compute node, a fair-share server
    finishes each job's demand only after serving everyone's: the time job
    ``g`` experiences on a resource is ``(V_g + Σ_{h≠g} V_h) / capacity``
    whenever job ``g`` uses the resource at all, and ``0`` when it does not.
    Those contention-inflated volumes are what this returns — feed them to
    :func:`volume_model` (or :meth:`CostModel.price_volumes`) and the
    ordinary single-job phase equations price the shared schedule, keeping
    one float64 home for model *and* measurement.

    ``kappa=0`` applies the exact hard usage gate ``1[V_g > 1e-9]`` — the
    same 1e-9 MB cutoff below which the executor emits no chunk at all, so
    softmax-epsilon plan entries are "unused" on both sides (use for
    evaluation); ``kappa > 0`` smooths it to ``V_g / (V_g + kappa)`` so the
    joint optimizer's gradients can trade contention against link speed
    (use a kappa small against typical per-resource volumes).
    """
    volumes = [tuple(v) for v in volumes]
    if len(volumes) <= 1:
        return list(volumes)
    totals = [sum(job[c] for job in volumes) for c in range(4)]
    out = []
    for job in volumes:
        eff = []
        for V, total in zip(job, totals):
            if kappa > 0:
                gate = V / (V + kappa)
            else:
                gate = xp.where(V > 1e-9, 1.0, 0.0)
            eff.append(V + gate * (total - V))
        out.append(tuple(eff))
    return out


@dataclasses.dataclass(frozen=True)
class JobProgress:
    """One job's *remaining* work at an observation instant, bucketed by
    what an online re-planner can still control.

    Captured by the executor's ``snapshot()`` (see
    :class:`repro.core.simulate.ProgressSnapshot`); priced by
    :meth:`CostModel.price_residual` through the same float64
    :func:`volume_model` equations as everything else, so online decisions
    stay on the one shared cost model.

    Attributes:
      resid_push:        (nS,) push MB still at the sources / queued but not
                         started — re-routable by a new ``x``.
      committed_push:    (nS, nM) push MB in service on a link — it will
                         land where it was sent.
      at_mapper:         (nM,) map-input MB already delivered (or gated)
                         at each mapper but not yet mapped.
      shuffle_pool:      (nM,) map-*output* MB at each mapper awaiting
                         shuffle (gated or queued, not started) —
                         re-routable by a new ``y``.
      committed_shuffle: (nM, nR) shuffle MB in service on a link.
      at_reducer:        (nR,) reduce-input MB delivered/queued at each
                         reducer but not yet reduced.
      map_alive:         (nM,) bool worker liveness at the observation
                         instant (``None`` = all alive) — a re-planner must
                         route around dead mappers, not just around slow
                         links.
      red_alive:         (nR,) bool reducer liveness (``None`` = all
                         alive) — the executor bounces emissions off dead
                         reducers, so pricing masks the plan's ``y`` to
                         the survivors (:func:`_live_plan_arrays`).
    """

    job: int
    released: bool
    done: bool
    resid_push: np.ndarray
    committed_push: np.ndarray
    at_mapper: np.ndarray
    shuffle_pool: np.ndarray
    committed_shuffle: np.ndarray
    at_reducer: np.ndarray
    alpha: float
    total_push_mb: float
    map_alive: Optional[np.ndarray] = None
    red_alive: Optional[np.ndarray] = None

    @classmethod
    def fresh(cls, platform: Platform, job: int = 0) -> "JobProgress":
        """The zero-progress snapshot: every byte still at its source —
        pricing it reproduces :meth:`CostModel.price_plan` exactly."""
        nS, nM, nR = platform.nS, platform.nM, platform.nR
        return cls(
            job=job, released=False, done=False,
            resid_push=platform.D.copy(),
            committed_push=np.zeros((nS, nM)),
            at_mapper=np.zeros(nM),
            shuffle_pool=np.zeros(nM),
            committed_shuffle=np.zeros((nM, nR)),
            at_reducer=np.zeros(nR),
            alpha=float(platform.alpha),
            total_push_mb=float(platform.D.sum()),
            map_alive=np.ones(nM, dtype=bool),
            red_alive=np.ones(nR, dtype=bool),
        )

    #: the six residual buckets, in the positional order
    #: :func:`residual_volumes` (and every residual solver) consumes them
    RESIDUAL_FIELDS = ("resid_push", "committed_push", "at_mapper",
                       "shuffle_pool", "committed_shuffle", "at_reducer")

    @classmethod
    def stack(cls, progresses) -> "Tuple[np.ndarray, ...]":
        """Stack the six residual buckets of ``progresses`` along a new
        leading job axis — the ``(J, ...)`` float64 arrays the batched and
        joint residual solvers consume (one stacking discipline, so the
        solo-batched, shared, and pricing paths can never disagree on
        bucket order)."""
        return tuple(
            np.stack([
                np.asarray(getattr(pr, field), dtype=np.float64)
                for pr in progresses
            ])
            for field in cls.RESIDUAL_FIELDS
        )

    def reroutable_mb(self) -> Dict[str, float]:
        """MB an online plan swap would pull back and re-route: push bytes
        still queued at the sources (steered by a new ``x``) and map-output
        bytes pooled at the mappers awaiting shuffle (steered by a new
        ``y``).  Committed/delivered buckets are excluded — a swap cannot
        move them.  This is the volume the replan-cost hysteresis charges
        (see :func:`repro.core.optimize.swap_charge`)."""
        return {
            "push": float(self.resid_push.sum()),
            "shuffle": float(self.shuffle_pool.sum()),
        }

    def remaining_mb(self) -> Dict[str, float]:
        """Remaining MB per phase (push/map input; shuffle/reduce output)."""
        push = float(self.resid_push.sum() + self.committed_push.sum())
        map_in = push + float(self.at_mapper.sum())
        shuffle = (
            self.alpha * map_in
            + float(self.shuffle_pool.sum() + self.committed_shuffle.sum())
        )
        reduce = shuffle + float(self.at_reducer.sum())
        return {"push": push, "map": map_in, "shuffle": shuffle,
                "reduce": reduce}

    def undeliver_reducer(
        self, k: int, by_mapper: Optional[np.ndarray] = None
    ) -> "JobProgress":
        """Return a copy with reducer ``k``'s volume un-delivered — the
        model-side mirror of the executor's reducer-kill claw-back: bytes
        on the wire toward (or landed at) the dead reducer return to their
        origin mappers' shuffle pools for re-routing, and ``red_alive[k]``
        flips dead.  ``by_mapper`` ((nM,) MB) is the full provenance of the
        landed + already-reduced volume lost with the node (the executor's
        ``reduced_by`` ledger); without it the landed bucket is spread
        evenly over the mappers."""
        nM = self.at_mapper.shape[0]
        k = int(k)
        pool = np.asarray(self.shuffle_pool, dtype=np.float64).copy()
        committed = np.asarray(
            self.committed_shuffle, dtype=np.float64
        ).copy()
        at_red = np.asarray(self.at_reducer, dtype=np.float64).copy()
        pool += committed[:, k]
        committed[:, k] = 0.0
        landed = float(at_red[k])
        at_red[k] = 0.0
        if by_mapper is not None:
            add = np.asarray(by_mapper, dtype=np.float64)
            if add.shape != (nM,):
                raise ValueError(
                    f"by_mapper must have shape ({nM},), got {add.shape}"
                )
            pool += add
        elif landed > 0:
            pool += landed / nM
        red_alive = (
            np.ones(at_red.shape[0], dtype=bool)
            if self.red_alive is None
            else np.asarray(self.red_alive, dtype=bool).copy()
        )
        red_alive[k] = False
        return dataclasses.replace(
            self, shuffle_pool=pool, committed_shuffle=committed,
            at_reducer=at_red, red_alive=red_alive,
        )

    def completion(self) -> Dict[str, float]:
        """Per-phase completion fraction in [0, 1]."""
        rem = self.remaining_mb()
        tot_in = max(self.total_push_mb, 1e-12)
        tot_out = max(self.alpha * self.total_push_mb, 1e-12)
        return {
            "push": 1.0 - min(rem["push"] / tot_in, 1.0),
            "map": 1.0 - min(rem["map"] / tot_in, 1.0),
            "shuffle": 1.0 - min(rem["shuffle"] / tot_out, 1.0),
            "reduce": 1.0 - min(rem["reduce"] / tot_out, 1.0),
        }


def _live_plan_arrays(
    progress: JobProgress, plan: ExecutionPlan
) -> Tuple[np.ndarray, np.ndarray]:
    """The plan arrays the executor *effectively* routes by at this
    snapshot: ``y`` masked to surviving reducers and renormalized (the
    executor bounces emissions off dead reducers and re-splits them over
    the survivors — pricing must route the same way to stay exact), ``x``
    as-is (dead mappers are handled by recovery + capacity degradation,
    not by re-normalizing the split).  Identity when every reducer is
    alive, so failure-free pricing stays on the exact original float
    path."""
    x = np.asarray(plan.x)
    y = np.asarray(plan.y)
    ra = progress.red_alive
    if ra is not None:
        ra = np.asarray(ra, dtype=bool)
        if not ra.all():
            live = np.where(ra, y, 0.0)
            if live.sum() <= 1e-12:
                live = np.where(ra, 1.0, 0.0)
                if live.sum() == 0:
                    raise ValueError("all reducers dead")
            y = live / live.sum()
    return x, y


def residual_volumes(
    resid_push, committed_push, at_mapper, shuffle_pool, committed_shuffle,
    at_reducer, alpha, x, y, xp=torch, rep=None,
):
    """Per-phase volumes of the *remaining* work under a candidate plan.

    The re-routable buckets flow through the candidate ``x``/``y`` exactly
    like :func:`analytic_volumes` routes a fresh job; the committed buckets
    enter as fixed per-resource volumes.  With zero committed/delivered
    buckets this degenerates to ``analytic_volumes(resid_push, x, y,
    alpha)`` — a fresh job is the special case of an untouched residual.
    ``rep`` (see :func:`replication_matrix`) inflates the re-routable push
    with its replica writes; committed transfers are already on the wire
    and enter as-is.
    """
    V_push = resid_push[:, None] * x
    if rep is not None:
        V_push = V_push @ rep
    V_push = V_push + committed_push
    map_in = x.T @ resid_push + at_mapper + xp.sum(committed_push, axis=0)
    out = alpha * map_in + shuffle_pool  # map-output MB leaving each mapper
    V_shuffle = out[:, None] * y[None, :] + committed_shuffle
    V_reduce = (
        xp.sum(out) * y + xp.sum(committed_shuffle, axis=0) + at_reducer
    )
    return V_push, map_in, V_shuffle, V_reduce


def phase_model(
    D, B_sm, B_mr, C_m, C_r, alpha, x, y, barriers, mx, pmax
) -> Dict[str, torch.Tensor]:
    """Analytic phase-timing model parameterized by the max ops (the same
    equations serve exact evaluation and smooth optimization)."""
    V_push, V_map, V_shuffle, V_reduce = analytic_volumes(D, x, y, alpha, xp=torch)
    return volume_model(
        V_push, V_map, V_shuffle, V_reduce, B_sm, B_mr, C_m, C_r,
        barriers, mx, pmax, xp=torch,
    )


def makespan_model(
    D: torch.Tensor,
    B_sm: torch.Tensor,
    B_mr: torch.Tensor,
    C_m: torch.Tensor,
    C_r: torch.Tensor,
    alpha: float,
    x: torch.Tensor,
    y: torch.Tensor,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    tau: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Full phase-timing model with a fixed smoothing temperature.

    ``tau=None`` evaluates the exact model; a positive ``tau`` gives the
    smooth upper bound.  (The optimizer uses :func:`phase_model` with
    :func:`smooth_ops` directly so the temperature can be annealed.)
    """
    mx, pmax = smooth_ops(tau) if tau else hard_ops()
    return phase_model(D, B_sm, B_mr, C_m, C_r, alpha, x, y, tuple(barriers),
                       mx, pmax)


def _np_hard_ops():
    """Exact (max, pairwise-max) reduction ops for the float64 numpy path."""
    return (lambda v, axis=None: np.max(v, axis=axis)), np.maximum


def attribute_phases(out) -> Dict[str, float]:
    """Sequential attribution of the makespan to the four phases, for the
    stacked-bar figures (Figs 5/6/9).  Under global barriers this is exact;
    under relaxed barriers overlapped time is attributed to the earlier
    phase (matching how the paper plots Hadoop's overlapped phases).
    """
    push = float(np.max(np.asarray(out["push_end"])))
    map_e = float(np.max(np.asarray(out["map_end"])))
    shuf_e = float(np.max(np.asarray(out["shuffle_end"])))
    total = float(out["makespan"])
    return {
        "push": push,
        "map": max(map_e - push, 0.0),
        "shuffle": max(shuf_e - map_e, 0.0),
        "reduce": max(total - shuf_e, 0.0),
        "makespan": total,
    }


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The shared pricing model: one set of phase equations for analytic
    plan volumes *and* measured byte matrices.

    ``price_plan`` derives ``D_i·x_ij``-style volumes from a plan;
    ``price_volumes`` accepts explicit per-phase MB volumes (e.g. the byte
    matrices recorded by :class:`repro.mapreduce.engine.GeoMapReduce`,
    converted to MB).  Both run the exact hard-max equations in float64, so
    pricing the analytic volumes of a plan reproduces :func:`makespan`
    bit-for-bit.

    ``replication``/``cross_cluster_replication`` mirror the executor's
    :class:`repro.core.simulate.SimConfig` fields: every *derived* push
    volume (plan, residual, shared, pipeline pricing) is inflated by the
    replica-routing matrix (:func:`replication_matrix`), so the model
    prices the replica writes the executor actually performs.  Explicit
    volumes passed to :meth:`price_volumes` are taken as-is — measured
    byte matrices already contain whatever traffic really moved.
    """

    platform: Platform
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL
    replication: int = 1
    cross_cluster_replication: bool = False

    def __post_init__(self):
        object.__setattr__(self, "barriers", _check_barriers(self.barriers))
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}"
            )

    def _barriers(self, barriers) -> Tuple[str, str, str]:
        return self.barriers if barriers is None else _check_barriers(barriers)

    def _rep(self) -> Optional[np.ndarray]:
        """The replica-routing matrix, ``None`` for replication=1."""
        return replication_matrix(
            self.platform.cluster_m, self.replication,
            self.cross_cluster_replication,
        )

    # -- volume derivation ---------------------------------------------------
    def analytic_volumes(self, plan: ExecutionPlan):
        """(V_push, V_map, V_shuffle, V_reduce) in MB implied by ``plan``
        (push inflated by replica writes when ``replication > 1``)."""
        p = self.platform
        return analytic_volumes(p.D, np.asarray(plan.x), np.asarray(plan.y),
                                p.alpha, xp=np, rep=self._rep())

    # -- pricing -------------------------------------------------------------
    def price_volumes(
        self, V_push, V_map, V_shuffle, V_reduce, barriers=None
    ) -> Dict[str, np.ndarray]:
        """Price explicit per-phase volumes (MB); returns the phase-end
        arrays plus the scalar ``makespan`` (seconds)."""
        p = self.platform
        V_push = np.asarray(V_push, dtype=np.float64)
        V_map = np.asarray(V_map, dtype=np.float64)
        V_shuffle = np.asarray(V_shuffle, dtype=np.float64)
        V_reduce = np.asarray(V_reduce, dtype=np.float64)
        validate_volumes(V_push, V_map, V_shuffle, V_reduce,
                         dims=(p.nS, p.nM, p.nR))
        mx, pmax = _np_hard_ops()
        return volume_model(
            V_push, V_map, V_shuffle, V_reduce,
            p.B_sm, p.B_mr, p.C_m, p.C_r,
            self._barriers(barriers), mx, pmax, xp=np,
        )

    def price_plan(self, plan: ExecutionPlan, barriers=None) -> Dict[str, np.ndarray]:
        """Price the analytic volumes of ``plan`` (the model side)."""
        return self.price_volumes(*self.analytic_volumes(plan), barriers=barriers)

    def price_residual(
        self, progress: JobProgress, plan: ExecutionPlan, barriers=None
    ) -> Dict[str, np.ndarray]:
        """Price the *remaining* work of an observed job under a candidate
        plan: the snapshot's re-routable volumes flow through ``plan``'s
        ``x``/``y``, the committed ones enter as fixed per-resource load,
        and everything runs through the identical float64 phase equations
        (:func:`residual_volumes` → :func:`volume_model`).  Pricing a
        zero-progress snapshot (:meth:`JobProgress.fresh`) reproduces
        :meth:`price_plan` exactly — online and offline decisions share one
        cost model."""
        x, y = _live_plan_arrays(progress, plan)
        return self.price_volumes(
            *residual_volumes(
                progress.resid_push, progress.committed_push,
                progress.at_mapper, progress.shuffle_pool,
                progress.committed_shuffle, progress.at_reducer,
                progress.alpha, x, y,
                xp=np, rep=self._rep(),
            ),
            barriers=barriers,
        )

    def residual_makespan(
        self, progress: JobProgress, plan: ExecutionPlan, barriers=None
    ) -> float:
        """Modeled seconds to finish the observed job under ``plan``."""
        return float(self.price_residual(progress, plan, barriers)["makespan"])

    # -- scalar / report conveniences ---------------------------------------
    def makespan(self, plan: ExecutionPlan, barriers=None) -> float:
        return float(self.price_plan(plan, barriers)["makespan"])

    def breakdown(self, plan: ExecutionPlan, barriers=None) -> Dict[str, float]:
        return attribute_phases(self.price_plan(plan, barriers))

    def breakdown_volumes(
        self, V_push, V_map, V_shuffle, V_reduce, barriers=None
    ) -> Dict[str, float]:
        return attribute_phases(
            self.price_volumes(V_push, V_map, V_shuffle, V_reduce, barriers)
        )

    # -- multi-job pricing ---------------------------------------------------
    def price_shared(
        self, volumes_list, barriers=None
    ) -> "list[Dict[str, np.ndarray]]":
        """Price N concurrent jobs' volumes on the shared substrate: each
        job's per-phase volumes are inflated by the other jobs' demand on
        every resource it touches (:func:`shared_effective_volumes`, hard
        gate) and priced through the identical float64 phase equations.
        ``volumes_list`` holds one ``(V_push, V_map, V_shuffle, V_reduce)``
        tuple per job — analytic or measured, exactly as for
        :meth:`price_volumes`.  When the model replicates
        (``replication > 1``), each job's push volumes are inflated by the
        replica writes *before* contention — so concurrent jobs contend
        for the replica traffic too (pass measured volumes through a
        replication-1 model; they already contain the real traffic)."""
        rep = self._rep()
        if rep is not None:
            volumes_list = [
                (np.asarray(v[0], dtype=np.float64) @ rep, v[1], v[2], v[3])
                for v in volumes_list
            ]
        eff = shared_effective_volumes(volumes_list, kappa=0.0, xp=np)
        return [self.price_volumes(*v, barriers=barriers) for v in eff]

    def schedule_makespan(self, volumes_list, barriers=None) -> float:
        """Aggregate (max over jobs) modeled makespan of N concurrent jobs
        under shared-capacity pricing."""
        return max(
            float(out["makespan"])
            for out in self.price_shared(volumes_list, barriers)
        )

    def price_residual_shared(
        self, progress_list, plans, barriers=None
    ) -> "list[Dict[str, np.ndarray]]":
        """Price N concurrent jobs' *remaining* work jointly on the shared
        substrate: each job's residual volumes under its candidate plan
        (:func:`residual_volumes`) are inflated by the other jobs' residual
        demand on every resource it touches (:func:`shared_effective_volumes`,
        hard gate) and priced through the identical float64 phase equations.
        This is what schedule-aware online re-planning optimizes — the
        multi-job analogue of :meth:`price_residual`, and with fresh
        zero-progress snapshots it reproduces :meth:`price_shared` of the
        plans' analytic volumes exactly (a fresh schedule is the special
        case of an untouched residual)."""
        if len(progress_list) != len(plans):
            raise ValueError(
                f"one plan per progress, got {len(progress_list)} progresses "
                f"and {len(plans)} plans"
            )
        rep = self._rep()
        vols = [
            residual_volumes(
                pr.resid_push, pr.committed_push, pr.at_mapper,
                pr.shuffle_pool, pr.committed_shuffle, pr.at_reducer,
                pr.alpha, *_live_plan_arrays(pr, plan), xp=np,
                rep=rep,
            )
            for pr, plan in zip(progress_list, plans)
        ]
        eff = shared_effective_volumes(vols, kappa=0.0, xp=np)
        return [self.price_volumes(*v, barriers=barriers) for v in eff]

    def residual_schedule_makespan(
        self, progress_list, plans, barriers=None
    ) -> float:
        """Aggregate (max over jobs) modeled seconds to finish the observed
        jobs' residuals under their candidate plans, with shared-capacity
        contention."""
        return max(
            float(out["makespan"])
            for out in self.price_residual_shared(progress_list, plans,
                                                  barriers)
        )

    # -- pipeline pricing ----------------------------------------------------
    def price_pipeline(self, spec, plans, barriers=None) -> Dict[str, object]:
        """Price a stage DAG end to end: chain the identical float64 phase
        equations across stages, with each downstream stage's ``D`` derived
        from its upstream stages' shuffle placement
        (:meth:`repro.core.pipeline.PipelineSpec.derived_D` — the
        inter-stage coupling flows through the one home of the phase
        equations) and makespans composed along the DAG's critical path: a
        stage starts when every upstream stage's reduce output has landed
        (the inter-stage barrier the executor gates per source; the
        scalar-start composition here is its tight upper bound).

        Returns ``{"stages": [per-stage price_volumes dicts], "start":
        [...], "finish": [...], "D": [derived per-stage D], "makespan"}``.
        A single root stage reproduces :meth:`price_plan` exactly.
        """
        barriers = self._barriers(barriers)
        if len(plans) != spec.n_stages:
            raise ValueError(
                f"one plan per stage, got {len(plans)} plans for "
                f"{spec.n_stages} stages"
            )
        D_list = spec.derived_D(plans)
        sub = spec.substrate
        rep = self._rep()
        n = spec.n_stages
        outs: "list" = [None] * n
        start = [0.0] * n
        finish = [0.0] * n
        mx, pmax = _np_hard_ops()
        for k in spec.topo_order():
            stage = spec.stages[k]
            V = analytic_volumes(
                D_list[k], np.asarray(plans[k].x), np.asarray(plans[k].y),
                stage.alpha, xp=np, rep=rep,
            )
            outs[k] = volume_model(
                *V, sub.B_sm, sub.B_mr, sub.C_m, sub.C_r,
                barriers, mx, pmax, xp=np,
            )
            start[k] = max((finish[u] for u in stage.deps), default=0.0)
            finish[k] = start[k] + float(outs[k]["makespan"])
        return {
            "stages": outs,
            "start": start,
            "finish": finish,
            "D": D_list,
            "makespan": max(finish),
        }

    def pipeline_makespan(self, spec, plans, barriers=None) -> float:
        """Modeled end-to-end seconds of the whole stage DAG."""
        return float(self.price_pipeline(spec, plans, barriers)["makespan"])


def makespan(
    platform: Platform,
    plan: ExecutionPlan,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    tau: Optional[float] = None,
    device: Optional[DeviceLike] = None,
) -> float:
    """Evaluate the (hard, by default) makespan of ``plan`` on ``platform``.

    The hard evaluation runs through the shared :class:`CostModel` (exact,
    float64, on the host); a positive ``tau`` evaluates the smooth float32
    upper bound the optimizer uses, on ``device``.
    """
    if tau:
        dev = resolve_device(device)
        D, B_sm, B_mr, C_m, C_r, alpha = platform.as_arrays()
        t = [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
             for a in (D, B_sm, B_mr, C_m, C_r, plan.x, plan.y)]
        out = makespan_model(*t[:5], float(alpha), t[5], t[6],
                             barriers=tuple(barriers), tau=tau)
        return float(out["makespan"])
    return CostModel(platform, tuple(barriers)).makespan(plan)


def phase_breakdown(
    platform: Platform,
    plan: ExecutionPlan,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
) -> Dict[str, float]:
    """Sequential phase attribution of ``plan``'s modeled makespan (see
    :func:`attribute_phases`)."""
    return CostModel(platform, tuple(barriers)).breakdown(plan)
