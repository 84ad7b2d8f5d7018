"""Model-driven execution-plan optimization (paper §2.3 and §4), on torch.

This is :mod:`repro.core.optimize`, ported from jit-compiled jnp to
batched torch: single-job planning, multi-job schedules on a shared
substrate, online re-planning of running jobs, and multi-stage pipelines.
The paper's *model* is kept exactly
(Equations 1–14); the *solver* is the reference's:

* validity (Equations 1–3) holds **by construction** — plans are parametrized
  by row-softmax logits for ``x`` and softmax logits for ``y``;
* every ``max`` is annealed through ``tau·logsumexp(·/tau)`` with the
  temperature ``tau`` geometrically decayed over the Adam steps (so
  gradients reach every branch early and the objective converges to the
  exact piecewise model late);
* many Adam restarts run in parallel (random inits plus the paper's
  heuristic plans as warm starts), then every candidate is re-evaluated
  under the **exact hard-max** model and the best is kept.

``lax.scan`` becomes a Python loop over the anneal steps; ``jax.grad``
inside ``vmap(vmap(...))`` becomes :func:`torch.func.grad` under
:func:`torch.func.vmap` over restarts and requests, so
:func:`repro_torch.core.makespan.volume_model` stays unbatched and shared
with the float64 numpy path; Adam is elementwise on the ``(B, R, ...)``
tensors.  Everything runs in float32 with TF32 off, and the temperature,
its schedule fraction and Adam's bias corrections are float32, as in the
reference, so trajectories follow the reference's.  Initial logits come
from the reference's numpy RNG, bit for bit.

Planner modes (mirroring the paper's §4 comparisons):

* ``uniform``        — Equations 15/16, no optimization.
* ``local_push``     — Hadoop-like locality push + uniform shuffle.
* ``myopic_push``    — minimize *push duration* only (locally optimal).
* ``myopic_multi``   — myopic push, then myopic shuffle given that push.
* ``e2e_push``       — minimize end-to-end makespan controlling ``x`` only.
* ``e2e_shuffle``    — minimize makespan controlling ``y`` only.
* ``e2e_multi``      — the paper's proposed optimization: makespan over both.

New strategies plug in through the **planner registry**:
``register_planner(name)`` decorates a function ``(platform, barriers, *,
n_restarts, steps, seed, fixed_x, device) -> (plan, objective)``, and
:func:`optimize_plan` (and the :class:`repro_torch.api.GeoJob` facade)
dispatch to it by name.  ``device`` is the resolved :class:`torch.device`
the solve runs on.

Multi-job schedule policies (``independent`` / ``sequential`` / ``joint``)
plug in through :func:`register_schedule_planner` and online re-planning
policies through :func:`register_online_policy`, pipeline planners
(``stagewise`` / ``end_to_end``) through :func:`register_pipeline_planner`.
The joint, residual and pipeline solvers share :func:`_adam_anneal` with
the single-job solver: a solver over one stacked problem gets a request
axis of one.  Every candidate they
return is re-priced in float64 numpy, and the incumbent competes, so the
selection never depends on float32.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from .._device import DeviceLike, resolve_device
from .makespan import (
    BARRIERS_ALL_GLOBAL,
    CostModel,
    JobProgress,
    _live_plan_arrays,
    _np_hard_ops,
    analytic_volumes,
    attribute_phases,
    hard_ops,
    makespan,
    phase_breakdown,
    phase_model,
    residual_volumes,
    shared_effective_volumes,
    smooth_ops,
    volume_model,
)
from .pipeline import PipelineSpec
from .plan import ExecutionPlan, local_push_plan, uniform_plan
from .platform import Platform, Substrate

__all__ = [
    "MODES",
    "SCHEDULE_OBJECTIVES",
    "OnlineConfig",
    "PipelinePlanResult",
    "PlanResult",
    "SchedulePlanResult",
    "ScheduleReplanResult",
    "available_modes",
    "available_online_policies",
    "available_pipeline_modes",
    "available_policies",
    "brute_force_plan",
    "get_online_config",
    "get_online_policy",
    "get_pipeline_planner",
    "get_planner",
    "get_schedule_planner",
    "optimize_pipeline",
    "optimize_plan",
    "optimize_plan_batch",
    "optimize_schedule",
    "register_online_policy",
    "register_pipeline_planner",
    "register_planner",
    "register_schedule_planner",
    "replan",
    "replan_batch",
    "replan_schedule",
    "reset_solver_cache_stats",
    "score_residual_shared",
    "solver_cache_occupancy",
    "solver_cache_stats",
    "swap_charge",
    "SolveTimeEMA",
    "SolverService",
]

#: The paper's built-in planner modes (the live set is
#: :func:`available_modes`).
MODES = (
    "uniform",
    "local_push",
    "myopic_push",
    "myopic_multi",
    "e2e_push",
    "e2e_shuffle",
    "e2e_multi",
)

# ---------------------------------------------------------------------------
# planner registry
# ---------------------------------------------------------------------------

#: name -> fn(platform, barriers, *, n_restarts, steps, seed, fixed_x, device)
#:         -> (ExecutionPlan, objective)
_PLANNERS: Dict[str, Callable] = {}


def register_planner(name: str, fn: Optional[Callable] = None):
    """Register a planning strategy under ``name``.

    Usable as a decorator (``@register_planner("my_mode")``) or a direct
    call.  A registered planner takes ``(platform, barriers, *, n_restarts,
    steps, seed, fixed_x, device)`` and returns ``(plan, objective)`` where
    ``objective`` is the value of the strategy's own loss (== the makespan
    for end-to-end strategies).  Registered names are immediately usable in
    :func:`optimize_plan` and :meth:`repro_torch.api.GeoJob.plan`.
    """
    if fn is None:
        return lambda f: register_planner(name, f)
    if name in _PLANNERS:
        raise ValueError(f"planner {name!r} is already registered")
    _PLANNERS[name] = fn
    return fn


def get_planner(name: str) -> Callable:
    """Look up a registered planner; raises ``ValueError`` for unknown names."""
    try:
        return _PLANNERS[name]
    except KeyError:
        raise ValueError(
            f"mode must be one of {available_modes()}, got {name!r}"
        ) from None


def available_modes() -> Tuple[str, ...]:
    """Names of every registered planner, built-in and user-added."""
    return tuple(_PLANNERS)


@dataclasses.dataclass(frozen=True)
class PlanResult:
    plan: ExecutionPlan
    makespan: float
    breakdown: Dict[str, float]
    mode: str
    barriers: Tuple[str, str, str]
    objective: float  # value of the mode's own objective (== makespan for e2e)

    def __repr__(self):
        return (
            f"PlanResult(mode={self.mode}, barriers={''.join(self.barriers)}, "
            f"makespan={self.makespan:.1f}s)"
        )


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _push_duration(D, B_sm, x, mx):
    return mx((D[:, None] * x) / B_sm)


def _shuffle_duration(D, B_mr, alpha, x, y, mx):
    map_in = x.T @ D
    return mx(alpha * (map_in[:, None] * y[None, :]) / B_mr)


def _objective_fn(mode: str, barriers) -> Callable:
    """Return loss(arrays, x, y, mx, pmax) -> scalar for the given mode."""

    def e2e(arrs, x, y, mx, pmax):
        D, B_sm, B_mr, C_m, C_r, alpha = arrs
        out = phase_model(D, B_sm, B_mr, C_m, C_r, alpha, x, y, barriers, mx, pmax)
        return out["makespan"]

    def push(arrs, x, y, mx, pmax):
        D, B_sm, _, _, _, _ = arrs
        return _push_duration(D, B_sm, x, mx)

    def shuffle(arrs, x, y, mx, pmax):
        D, _, B_mr, _, _, alpha = arrs
        return _shuffle_duration(D, B_mr, alpha, x, y, mx)

    return {"e2e": e2e, "push": push, "shuffle": shuffle}[mode]


# ---------------------------------------------------------------------------
# the annealed multi-restart solver
# ---------------------------------------------------------------------------

def _adam_anneal(grad_fn, params0, steps: int, scale, lr, tau0_frac, tau1_frac):
    """The annealed-Adam loop: minimize over ``params0`` (a dict of
    ``(B, R, ...)`` tensors) for ``steps`` iterations, with ``grad_fn(params,
    tau)`` giving the gradients and the smoothing temperature ``tau`` (one
    per request, ``(B,)``) geometrically decayed from ``scale*tau0_frac``
    to ``scale*tau1_frac``.  The schedule and the bias corrections are
    float32, computed as the reference's scan computes them from a float32
    step counter."""
    t = torch.arange(steps, dtype=torch.float32, device=scale.device)
    frac = t / max(steps - 1, 1)
    ratio = torch.tensor(tau1_frac / tau0_frac, dtype=torch.float32,
                         device=scale.device)
    taus = ((scale[:, None] * tau0_frac) * ratio ** frac[None, :]).unbind(1)
    b1, b2, eps = 0.9, 0.999, 1e-8
    t1 = t + 1.0
    bc1 = (1 - torch.full_like(t1, b1) ** t1).unbind(0)
    bc2 = (1 - torch.full_like(t1, b2) ** t1).unbind(0)
    params = dict(params0)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    for i in range(steps):
        g = grad_fn(params, taus[i])
        for k in params:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
            mhat = m[k] / bc1[i]
            vhat = v[k] / bc2[i]
            params[k] = params[k] - lr * mhat / (torch.sqrt(vhat) + eps)
    return params


# ---------------------------------------------------------------------------
# solver service plumbing: shape-keyed call counters
# ---------------------------------------------------------------------------

#: cumulative counters over every counted-solver call in this process; read
#: with :func:`solver_cache_stats`, zero with :func:`reset_solver_cache_stats`.
#: Torch runs eagerly, so there is no executable to cache: a "compile" is
#: the first call of a key in the life of the process, and a reset zeroes
#: the accounting (like the reference's, whose executables outlive it).
_SOLVER_STATS = {"calls": 0, "hits": 0, "misses": 0, "compiles": 0}
_SOLVER_KEYS: set = set()
_SEEN_KEYS: set = set()


def _leaves(val):
    """The leaves of a (nested) tuple/list/dict argument, in order."""
    if isinstance(val, (tuple, list)):
        for item in val:
            yield from _leaves(item)
    elif isinstance(val, dict):
        for k in sorted(val):
            yield from _leaves(val[k])
    else:
        yield val


def _abstract_leaf(leaf):
    """A leaf's contribution to the cache key: tensors key by shape+dtype
    only; bare Python scalars by their type, not their value (what lets a
    re-solve with another ``lr`` share the key)."""
    if isinstance(leaf, torch.Tensor):
        return ("arr", tuple(leaf.shape), str(leaf.dtype))
    return ("weak", type(leaf).__name__)


def _counted_solver(static_argnames: Tuple[str, ...] = ()):
    """Cache accounting around a solver: every call is classified as a hit
    (the same function, tensor shapes/dtypes and static values were
    requested before) or a miss, and the first call of a key in the process
    counts as its compile.  The counters feed the cache-semantics tests and
    the solver-service stats."""
    statics = tuple(static_argnames)

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            parts: list = [fn.__name__]
            for pname, val in bound.arguments.items():
                if pname in statics:
                    parts.append((pname, "static", val))
                else:
                    parts.append((pname, tuple(
                        _abstract_leaf(leaf) for leaf in _leaves(val)
                    )))
            key = tuple(parts)
            _SOLVER_STATS["calls"] += 1
            if key in _SOLVER_KEYS:
                _SOLVER_STATS["hits"] += 1
            else:
                _SOLVER_STATS["misses"] += 1
                _SOLVER_KEYS.add(key)
            if key not in _SEEN_KEYS:
                _SOLVER_STATS["compiles"] += 1
                _SEEN_KEYS.add(key)
            return fn(*args, **kwargs)

        return wrapper

    return deco


#: entry count past which :func:`solver_cache_occupancy` raises its growth
#: warning: a shape population past this bound usually means a caller is
#: leaking shapes (e.g. ragged batch sizes) rather than reusing them.
CACHE_GROWTH_WARN_ENTRIES = 256


def _occupancy_label(key) -> str:
    """Human-readable shape group of one cache key: the solver name plus
    its tensor shapes (statics and scalars are folded out)."""
    dims = []
    for part in key[1:]:
        if len(part) == 2:  # (pname, leaf_abstracts)
            for leaf in part[1]:
                if leaf[0] == "arr":
                    dims.append("x".join(map(str, leaf[1])) or "()")
    return f"{key[0]}[{';'.join(dims)}]" if dims else str(key[0])


def solver_cache_occupancy() -> Dict[str, object]:
    """Per-shape occupancy of the key set: ``entries`` (total keys),
    ``by_shape`` (entry count per solver+shape group), and
    ``growth_warning`` (a message once ``entries`` crosses
    :data:`CACHE_GROWTH_WARN_ENTRIES`, else ``None``)."""
    by_shape: Dict[str, int] = {}
    for key in _SOLVER_KEYS:
        label = _occupancy_label(key)
        by_shape[label] = by_shape.get(label, 0) + 1
    entries = len(_SOLVER_KEYS)
    warning = None
    if entries >= CACHE_GROWTH_WARN_ENTRIES:
        warning = (
            f"solver key set holds {entries} entries across "
            f"{len(by_shape)} shape groups — check for shape churn (ragged "
            "batch sizes, per-call static values)"
        )
    return {"entries": entries, "by_shape": by_shape,
            "growth_warning": warning}


def solver_cache_stats() -> Dict[str, int]:
    """Cumulative solver counters for this process: ``calls``,
    ``hits``/``misses`` (against the shape+static key), ``compiles``
    (first calls of a key in the process), plus ``entries`` (distinct keys
    since the last reset) and ``shapes`` (distinct solver+shape groups)."""
    labels = {_occupancy_label(key) for key in _SOLVER_KEYS}
    return dict(_SOLVER_STATS, entries=len(_SOLVER_KEYS),
                shapes=len(labels))


def reset_solver_cache_stats() -> None:
    """Zero the counters and the key set; a key seen before the reset does
    not count as a compile again."""
    for k in _SOLVER_STATS:
        _SOLVER_STATS[k] = 0
    _SOLVER_KEYS.clear()


@_counted_solver(
    static_argnames=("loss_kind", "barriers", "opt_x", "opt_y", "steps")
)
def _solve_batch_many(
    arrs,  # 6-tuple of (B, ...) tensors: D, B_sm, B_mr, C_m, C_r, alpha
    logits_x0,  # (B, R, nS, nM)
    logits_y0,  # (B, R, nR)
    x_fixed,  # (B, nS, nM) used when opt_x=False
    y_fixed,  # (B, nR)     used when opt_y=False
    scale,  # (B,) — typical makespan per request, sets the tau units
    loss_kind: str,
    barriers: Tuple[str, str, str],
    opt_x: bool,
    opt_y: bool,
    steps: int,
    lr: float = 0.08,
    tau0_frac: float = 0.3,
    tau1_frac: float = 1e-3,
):
    """Run ``B`` independent solve requests × ``R`` Adam restarts of
    ``steps`` annealed iterations as one batched program on the tensors'
    device; return per-request, per-restart final ``(x, y)`` plus their
    exact hard-model objectives.  Float32 matrix products run in full
    float32: TF32 is switched off here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    loss_core = _objective_fn(loss_kind, barriers)

    def build(params, xf, yf):
        x = torch.softmax(params["x"], dim=-1) if opt_x else xf
        y = torch.softmax(params["y"], dim=-1) if opt_y else yf
        return x, y

    def loss(params, tau, arrs_b, xf, yf, sc):
        mx, pmax = smooth_ops(tau)
        x, y = build(params, xf, yf)
        return loss_core(arrs_b, x, y, mx, pmax) / sc

    def exact(params, arrs_b, xf, yf):
        x, y = build(params, xf, yf)
        mx, pmax = hard_ops()
        return x, y, loss_core(arrs_b, x, y, mx, pmax)

    # inner vmap over restarts (per-request data shared), outer over requests
    per_restart = (0, None, None, None, None, None)
    grad_all = vmap(vmap(grad(loss), in_dims=per_restart))

    def grad_fn(params, tau):
        return grad_all(params, tau, arrs, x_fixed, y_fixed, scale)

    params0 = {}
    if opt_x:
        params0["x"] = logits_x0
    if opt_y:
        params0["y"] = logits_y0
    params = _adam_anneal(grad_fn, params0, steps, scale, lr, tau0_frac,
                          tau1_frac)
    return vmap(vmap(exact, in_dims=(0, None, None, None)))(
        params, arrs, x_fixed, y_fixed
    )


def _f32(a, device) -> torch.Tensor:
    """A float64 numpy array (or scalar) cast once to a float32 tensor on
    ``device``."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           dtype=torch.float32, device=device)


def _initial_logits(platform: Platform, n_restarts: int, seed: int):
    """Random inits plus deterministic warm starts (uniform, local push,
    bandwidth-greedy), from the reference's numpy RNG stream; float32 CPU
    tensors."""
    rng = np.random.default_rng(seed)
    nS, nM, nR = platform.nS, platform.nM, platform.nR
    eps = 1e-9

    warm_x = [
        np.zeros((nS, nM)),  # uniform
        np.log(local_push_plan(platform).x + eps),  # locality
        np.log(platform.B_sm / platform.B_sm.max() + eps),  # bandwidth-greedy
    ]
    warm_y = [
        np.zeros(nR),  # uniform
        np.log(platform.C_r / platform.C_r.max() + eps),  # compute-greedy
        np.log(np.mean(platform.B_mr, axis=0) / platform.B_mr.max() + eps),
    ]
    lx = list(warm_x)
    ly = list(warm_y)
    while len(lx) < n_restarts:
        sigma = rng.uniform(0.3, 3.0)
        lx.append(rng.normal(0.0, sigma, size=(nS, nM)))
        ly.append(rng.normal(0.0, sigma, size=(nR,)))
    lx = np.stack(lx[:n_restarts]).astype(np.float32)
    ly = np.stack(ly[:n_restarts]).astype(np.float32)
    return torch.from_numpy(lx), torch.from_numpy(ly)


def _run_solver_many(
    platforms: Sequence[Platform],
    loss_kind: str,
    barriers,
    opt_x: bool,
    opt_y: bool,
    x_fixed_list: Optional[Sequence[Optional[np.ndarray]]],
    y_fixed_list: Optional[Sequence[Optional[np.ndarray]]],
    n_restarts: int,
    steps: int,
    seeds: Sequence[int],
    device: torch.device,
) -> "list[Tuple[np.ndarray, np.ndarray, float]]":
    """Solve ``B`` same-shape requests as one batched program on ``device``.

    Every platform must share ``(nS, nM, nR)`` (callers group by shape —
    see :func:`optimize_plan_batch`); per-request ``D``/``alpha``/
    capacities/seeds are free.  Returns one ``(x, y, exact)`` per request,
    the best restart under the exact hard-max model, float64-renormalized.
    """
    B = len(platforms)
    raw = [p.as_arrays() for p in platforms]
    arrs = tuple(
        _f32(np.stack([np.asarray(r[i], dtype=np.float64) for r in raw]),
             device)
        for i in range(6)
    )
    if x_fixed_list is None:
        x_fixed_list = [None] * B
    if y_fixed_list is None:
        y_fixed_list = [None] * B
    xf = np.stack([
        uniform_plan(p).x if x is None else np.asarray(x)
        for p, x in zip(platforms, x_fixed_list)
    ])
    yf = np.stack([
        uniform_plan(p).y if y is None else np.asarray(y)
        for p, y in zip(platforms, y_fixed_list)
    ])
    scales = np.array([
        max(makespan(p, uniform_plan(p), barriers=barriers), 1e-6)
        for p in platforms
    ])
    inits = [_initial_logits(p, n_restarts, s)
             for p, s in zip(platforms, seeds)]
    xs, ys, exact = _solve_batch_many(
        arrs,
        torch.stack([lx for lx, _ in inits]).to(device),
        torch.stack([ly for _, ly in inits]).to(device),
        _f32(xf, device),
        _f32(yf, device),
        _f32(scales, device),
        loss_kind,
        tuple(barriers),
        opt_x,
        opt_y,
        steps,
    )
    xs, ys, exact = xs.cpu().numpy(), ys.cpu().numpy(), exact.cpu().numpy()
    out = []
    for b in range(B):
        best = int(np.argmin(exact[b]))
        # renormalize against float32 round-off so the plan validates
        plan = ExecutionPlan.renormalized(xs[b, best], ys[b, best])
        out.append((plan.x, plan.y, float(exact[b, best])))
    return out


def _run_solver(
    platform: Platform,
    loss_kind: str,
    barriers,
    opt_x: bool,
    opt_y: bool,
    x_fixed: Optional[np.ndarray],
    y_fixed: Optional[np.ndarray],
    n_restarts: int,
    steps: int,
    seed: int,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """One solve request — a batch of one through the batched path, so
    single plans and batched plans share one solver key."""
    return _run_solver_many(
        [platform], loss_kind, barriers, opt_x, opt_y,
        [x_fixed], [y_fixed], n_restarts, steps, [seed], device,
    )[0]


# ---------------------------------------------------------------------------
# built-in planners
# ---------------------------------------------------------------------------

@register_planner("uniform")
def _uniform_planner(platform, barriers, *, n_restarts, steps, seed, fixed_x,
                     device):
    plan = uniform_plan(platform)
    return plan, makespan(platform, plan, barriers)


@register_planner("local_push")
def _local_push_planner(platform, barriers, *, n_restarts, steps, seed,
                        fixed_x, device):
    plan = local_push_plan(platform)
    return plan, makespan(platform, plan, barriers)


@register_planner("myopic_push")
def _myopic_push_planner(platform, barriers, *, n_restarts, steps, seed,
                         fixed_x, device):
    x, _, obj = _run_solver(
        platform, "push", barriers, True, False, None, None,
        n_restarts, steps, seed, device,
    )
    return ExecutionPlan(x=x, y=uniform_plan(platform).y, meta="myopic_push"), obj


@register_planner("myopic_multi")
def _myopic_multi_planner(platform, barriers, *, n_restarts, steps, seed,
                          fixed_x, device):
    # locally-optimal push, then locally-optimal shuffle given that push
    x, _, _ = _run_solver(
        platform, "push", barriers, True, False, None, None,
        n_restarts, steps, seed, device,
    )
    _, y, obj = _run_solver(
        platform, "shuffle", barriers, False, True, x, None,
        n_restarts, steps, seed + 1, device,
    )
    return ExecutionPlan(x=x, y=y, meta="myopic_multi"), obj


@register_planner("e2e_push")
def _e2e_push_planner(platform, barriers, *, n_restarts, steps, seed, fixed_x,
                      device):
    x, _, obj = _run_solver(
        platform, "e2e", barriers, True, False, None, None,
        n_restarts, steps, seed, device,
    )
    return ExecutionPlan(x=x, y=uniform_plan(platform).y, meta="e2e_push"), obj


@register_planner("e2e_shuffle")
def _e2e_shuffle_planner(platform, barriers, *, n_restarts, steps, seed,
                         fixed_x, device):
    _, y, obj = _run_solver(
        platform, "e2e", barriers, False, True, fixed_x, None,
        n_restarts, steps, seed, device,
    )
    x = uniform_plan(platform).x if fixed_x is None else np.asarray(fixed_x)
    return ExecutionPlan(x=x, y=y, meta="e2e_shuffle"), obj


@register_planner("e2e_multi")
def _e2e_multi_planner(platform, barriers, *, n_restarts, steps, seed, fixed_x,
                       device):
    x, y, obj = _run_solver(
        platform, "e2e", barriers, True, True, None, None,
        n_restarts, steps, seed, device,
    )
    return ExecutionPlan(x=x, y=y, meta="e2e_multi"), obj


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def optimize_plan(
    platform: Platform,
    mode: str = "e2e_multi",
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 24,
    steps: int = 500,
    seed: int = 0,
    fixed_x: Optional[np.ndarray] = None,
    device: Optional[DeviceLike] = None,
) -> PlanResult:
    """Produce an execution plan for ``platform`` with the given planner
    ``mode`` (any name in :func:`available_modes`), evaluated under
    ``barriers``; the solve runs on ``device`` (default: the process
    default, the card).

    ``fixed_x`` pins the push matrix for the shuffle-only modes
    (``e2e_shuffle``); defaults to the uniform push of Equation 15.
    """
    dev = resolve_device(device)
    planner = get_planner(mode)
    barriers = tuple(barriers)
    plan, obj = planner(
        platform, barriers,
        n_restarts=n_restarts, steps=steps, seed=seed, fixed_x=fixed_x,
        device=dev,
    )
    return PlanResult(
        plan=plan,
        makespan=makespan(platform, plan, barriers),
        breakdown=phase_breakdown(platform, plan, barriers),
        mode=mode,
        barriers=barriers,
        objective=float(obj),
    )


# ---------------------------------------------------------------------------
# planner-as-a-service: batched concurrent solve requests
# ---------------------------------------------------------------------------

#: built-in modes whose planner is exactly one `_run_solver` call —
#: batchable as (loss_kind, opt_x, opt_y).  ``myopic_multi`` (two chained
#: solves) is batched as two rounds; anything else falls back to a
#: per-request planner loop.
_BATCHED_SOLVES = {
    "myopic_push": ("push", True, False),
    "e2e_push": ("e2e", True, False),
    "e2e_shuffle": ("e2e", False, True),
    "e2e_multi": ("e2e", True, True),
}


def _plan_group(platforms, mode, barriers, n_restarts, steps, seeds,
                fixed_xs, device) -> "list[Tuple[ExecutionPlan, float]]":
    """Plan one same-shape group of requests, batching the solver
    dispatches where the mode allows; mirrors the built-in planners'
    construction exactly (same warm starts, seeds, and plan assembly)."""
    if mode == "myopic_multi":
        # locally-optimal push, then locally-optimal shuffle given that
        # push — two batched rounds, round 2 reseeded at seed+1 like the
        # sequential planner
        r1 = _run_solver_many(platforms, "push", barriers, True, False,
                              None, None, n_restarts, steps, seeds, device)
        xs = [x for x, _, _ in r1]
        r2 = _run_solver_many(platforms, "shuffle", barriers, False, True,
                              xs, None, n_restarts, steps,
                              [s + 1 for s in seeds], device)
        return [
            (ExecutionPlan(x=x, y=y, meta="myopic_multi"), obj)
            for x, (_, y, obj) in zip(xs, r2)
        ]
    if mode in _BATCHED_SOLVES:
        loss_kind, opt_x, opt_y = _BATCHED_SOLVES[mode]
        xf = fixed_xs if not opt_x else [None] * len(platforms)
        solved = _run_solver_many(platforms, loss_kind, barriers, opt_x,
                                  opt_y, xf, None, n_restarts, steps, seeds,
                                  device)
        plans = []
        for p, fx, (x, y, obj) in zip(platforms, fixed_xs, solved):
            if not opt_y:
                y = uniform_plan(p).y
            if not opt_x:
                x = uniform_plan(p).x if fx is None else np.asarray(fx)
            plans.append((ExecutionPlan(x=x, y=y, meta=mode), obj))
        return plans
    # heuristic or externally-registered mode: per-request dispatch
    planner = get_planner(mode)
    return [
        planner(p, barriers, n_restarts=n_restarts, steps=steps, seed=s,
                fixed_x=fx, device=device)
        for p, s, fx in zip(platforms, seeds, fixed_xs)
    ]


def optimize_plan_batch(
    platforms: Sequence[Platform],
    mode: str = "e2e_multi",
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 24,
    steps: int = 500,
    seed: int = 0,
    seeds: Optional[Sequence[int]] = None,
    fixed_x: Optional[Sequence[Optional[np.ndarray]]] = None,
    device: Optional[DeviceLike] = None,
) -> "list[PlanResult]":
    """Plan ``N`` independent jobs in as few batched solves as their shapes
    allow — the batched front door of the solver service.

    Requests are grouped by ``(nS, nM, nR)``; each same-shape group of a
    solver-backed mode runs as **one** batched solve
    (:func:`_solve_batch_many`) on ``device``.  ``seeds`` gives one seed
    per request (default ``seed + 17*g``); ``fixed_x`` one pinned push
    matrix per request for the shuffle-only modes.  Results are
    per-request :class:`PlanResult`\\ s, identical (to float32 batching
    round-off) to calling :func:`optimize_plan` per request.
    """
    dev = resolve_device(device)
    platforms = list(platforms)
    barriers = tuple(barriers)
    if seeds is None:
        seeds = [seed + 17 * g for g in range(len(platforms))]
    seeds = list(seeds)
    if len(seeds) != len(platforms):
        raise ValueError(
            f"one seed per platform, got {len(seeds)} seeds for "
            f"{len(platforms)} platforms"
        )
    if fixed_x is None:
        fixed_x = [None] * len(platforms)
    fixed_x = list(fixed_x)
    if len(fixed_x) != len(platforms):
        raise ValueError(
            f"one fixed_x per platform, got {len(fixed_x)} for "
            f"{len(platforms)} platforms"
        )
    get_planner(mode)  # validate the mode before any solve
    groups: Dict[Tuple[int, int, int], list] = {}
    for g, p in enumerate(platforms):
        groups.setdefault((p.nS, p.nM, p.nR), []).append(g)
    results: "list[Optional[PlanResult]]" = [None] * len(platforms)
    for idxs in groups.values():
        planned = _plan_group(
            [platforms[g] for g in idxs], mode, barriers, n_restarts,
            steps, [seeds[g] for g in idxs], [fixed_x[g] for g in idxs], dev,
        )
        for g, (plan, obj) in zip(idxs, planned):
            results[g] = PlanResult(
                plan=plan,
                makespan=makespan(platforms[g], plan, barriers),
                breakdown=phase_breakdown(platforms[g], plan, barriers),
                mode=mode,
                barriers=barriers,
                objective=float(obj),
            )
    return results  # type: ignore[return-value]


class SolverService:
    """Planner-as-a-service facade: batched same-shape solves and the
    process-wide solver counters.

    A service object only carries request defaults (including the device);
    ``plan``/``plan_many`` route through :func:`optimize_plan_batch`
    (same-shape requests share one batched solve); ``replan_many`` through
    :func:`replan_batch` (optionally warm-started incremental re-solves)."""

    def __init__(
        self,
        mode: str = "e2e_multi",
        barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
        n_restarts: int = 24,
        steps: int = 500,
        device: Optional[DeviceLike] = None,
    ):
        self.mode = mode
        self.barriers = tuple(barriers)
        self.n_restarts = int(n_restarts)
        self.steps = int(steps)
        self.device = device

    def _defaults(self, overrides: dict) -> dict:
        kw = dict(mode=self.mode, barriers=self.barriers,
                  n_restarts=self.n_restarts, steps=self.steps,
                  device=self.device)
        kw.update(overrides)
        return kw

    def plan(self, platform: Platform, seed: int = 0,
             **overrides) -> PlanResult:
        """One request (a batch of one)."""
        return self.plan_many([platform], seeds=[seed], **overrides)[0]

    def plan_many(self, platforms: Sequence[Platform],
                  seeds: Optional[Sequence[int]] = None,
                  **overrides) -> "list[PlanResult]":
        """N concurrent plan requests, batched per shape group."""
        return optimize_plan_batch(
            platforms, seeds=seeds, **self._defaults(overrides)
        )

    def replan_many(
        self,
        platforms: Sequence[Platform],
        incumbents: Sequence[ExecutionPlan],
        progresses=None,
        seeds: Optional[Sequence[int]] = None,
        incremental: bool = False,
        **overrides,
    ) -> "list[PlanResult]":
        """N concurrent residual re-plan requests, batched per shape
        group (see :func:`replan_batch`)."""
        kw = self._defaults(overrides)
        kw.pop("mode", None)
        return replan_batch(
            platforms, incumbents, progresses, seeds=seeds,
            incremental=incremental, **kw,
        )

    @staticmethod
    def stats() -> Dict[str, int]:
        """The process-wide solver counters (:func:`solver_cache_stats`)."""
        return solver_cache_stats()

    @staticmethod
    def reset_stats() -> None:
        reset_solver_cache_stats()


# ---------------------------------------------------------------------------
# multi-job scheduling: policies over a shared substrate
# ---------------------------------------------------------------------------

#: name -> fn(substrate, platforms, barriers, *, mode, n_restarts, steps,
#:            seed, device) -> [ExecutionPlan, ...] (one per job)
_SCHEDULE_PLANNERS: Dict[str, Callable] = {}


def register_schedule_planner(name: str, fn: Optional[Callable] = None):
    """Register a multi-job scheduling policy under ``name`` (decorator or
    direct call, mirroring :func:`register_planner`).  A policy takes
    ``(substrate, platforms, barriers, *, mode, n_restarts, steps, seed,
    device)`` — ``platforms`` being per-job views of ``substrate`` — and
    returns one :class:`ExecutionPlan` per job.  Registered names are
    immediately usable in :func:`optimize_schedule` and
    :meth:`repro_torch.api.GeoSchedule.plan`."""
    if fn is None:
        return lambda f: register_schedule_planner(name, f)
    if name in _SCHEDULE_PLANNERS:
        raise ValueError(f"schedule policy {name!r} is already registered")
    _SCHEDULE_PLANNERS[name] = fn
    return fn


def get_schedule_planner(name: str) -> Callable:
    try:
        return _SCHEDULE_PLANNERS[name]
    except KeyError:
        raise ValueError(
            f"policy must be one of {available_policies()}, got {name!r}"
        ) from None


def available_policies() -> Tuple[str, ...]:
    """Names of every registered multi-job scheduling policy."""
    return tuple(_SCHEDULE_PLANNERS)


@dataclasses.dataclass(frozen=True)
class SchedulePlanResult:
    """N per-job plans priced together on their shared substrate.  Each
    per-job :class:`PlanResult` carries the job's *contended* makespan
    (shared-capacity pricing — the other jobs' demand inflates every
    resource the job touches); ``makespan`` is the modeled aggregate.
    ``objective`` records what the policy optimized (see
    :data:`SCHEDULE_OBJECTIVES`)."""

    results: Tuple[PlanResult, ...]
    makespan: float
    policy: str
    mode: str
    barriers: Tuple[str, str, str]
    objective: str = "makespan"

    @property
    def plans(self) -> Tuple[ExecutionPlan, ...]:
        return tuple(r.plan for r in self.results)

    def __repr__(self):
        per_job = " ".join(f"{r.makespan:.1f}s" for r in self.results)
        return (
            f"SchedulePlanResult(policy={self.policy}, mode={self.mode}, "
            f"jobs={len(self.results)}, makespan={self.makespan:.1f}s "
            f"[{per_job}])"
        )


def _job_volumes(platforms, plans):
    """Per-job analytic volumes (numpy float64) for shared pricing."""
    return [
        analytic_volumes(p.D, np.asarray(plan.x), np.asarray(plan.y),
                         p.alpha, xp=np)
        for p, plan in zip(platforms, plans)
    ]


def _shared_schedule_result(
    platforms, plans, barriers, policy: str, mode: str,
    objective: str = "makespan",
) -> SchedulePlanResult:
    """Price per-job plans under shared-capacity float64 equations and wrap
    them in per-job PlanResults + the aggregate."""
    cm = CostModel(platforms[0], barriers)
    priced = cm.price_shared(_job_volumes(platforms, plans), barriers)
    results = []
    for plan, out in zip(plans, priced):
        breakdown = attribute_phases(out)
        results.append(
            PlanResult(
                plan=plan,
                makespan=breakdown["makespan"],
                breakdown=breakdown,
                mode=f"{policy}:{mode}",
                barriers=tuple(barriers),
                objective=breakdown["makespan"],
            )
        )
    return SchedulePlanResult(
        results=tuple(results),
        makespan=max(r.makespan for r in results),
        policy=policy,
        mode=mode,
        barriers=tuple(barriers),
        objective=objective,
    )


def optimize_schedule(
    platforms: "list[Platform]",
    policy: str = "joint",
    mode: str = "e2e_multi",
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 24,
    steps: int = 500,
    seed: int = 0,
    objective: str = "makespan",
    device: Optional[DeviceLike] = None,
) -> SchedulePlanResult:
    """Plan N concurrent jobs sharing one substrate; the solves run on
    ``device`` (default: the process default, the card).

    ``platforms`` are the jobs' substrate views (same capacities, per-job
    ``D``/``alpha``); ``policy`` is any name in
    :func:`available_policies` — built in:

    * ``independent`` — every job planned as the sole tenant (``mode``
      planner on the full-capacity view); the myopic baseline.
    * ``sequential``  — greedy: jobs planned largest-first, each on the
      capacity left over after earlier jobs' committed utilization.
    * ``joint``       — one optimization over all jobs' stacked ``x``/``y``
      against the shared-capacity pricing (never worse than
      ``independent`` under the model, because the independent plans are a
      candidate).

    ``objective`` selects what the policy minimizes
    (:data:`SCHEDULE_OBJECTIVES`): the aggregate ``makespan``, or
    ``min_max_slowdown`` — the worst per-job contended makespan over its
    sole-tenant makespan.  It is forwarded to policies that accept an
    ``objective`` keyword (the built-in ``joint`` does); requesting a
    non-default objective from a policy that does not is an error.

    The result prices every job with shared-capacity float64 equations, so
    policies are compared on exactly the surface the executor measures.
    """
    if not platforms:
        raise ValueError("optimize_schedule needs at least one job")
    if objective not in SCHEDULE_OBJECTIVES:
        raise ValueError(
            f"objective must be one of {SCHEDULE_OBJECTIVES}, got {objective!r}"
        )
    dev = resolve_device(device)
    sub = Substrate.of(platforms[0])
    for p in platforms[1:]:
        if not sub.compatible(Substrate.of(p)):
            raise ValueError(
                f"platform {p.name!r} does not share the substrate — build "
                "job platforms with Substrate.view()"
            )
    planner = get_schedule_planner(policy)
    barriers = tuple(barriers)
    kwargs = dict(mode=mode, n_restarts=n_restarts, steps=steps, seed=seed,
                  device=dev)
    if "objective" in inspect.signature(planner).parameters:
        kwargs["objective"] = objective
    elif objective != "makespan":
        raise ValueError(
            f"policy {policy!r} does not take an objective — register it "
            "with an `objective` keyword to opt in"
        )
    plans = planner(sub, list(platforms), barriers, **kwargs)
    return _shared_schedule_result(
        platforms, plans, barriers, policy, mode, objective
    )


@register_schedule_planner("independent")
def _independent_policy(substrate, platforms, barriers, *, mode, n_restarts,
                        steps, seed, device):
    """Each job planned as if it owned the whole substrate (the per-job
    myopic baseline).  All jobs share one batched solve per shape group
    (:func:`optimize_plan_batch`, per-job seeds ``seed + 17*g``)."""
    return [
        res.plan
        for res in optimize_plan_batch(
            platforms, mode=mode, barriers=barriers,
            n_restarts=n_restarts, steps=steps, seed=seed, device=device,
        )
    ]


@register_schedule_planner("sequential")
def _sequential_policy(substrate, platforms, barriers, *, mode, n_restarts,
                       steps, seed, device):
    """Greedy multi-job planning: jobs are planned largest-data-first, and
    after each job commits, its planned per-resource utilization (busy
    seconds over its own makespan) is deducted from the substrate the
    remaining jobs see (:meth:`Substrate.residual`)."""
    planner = get_planner(mode)
    order = sorted(
        range(len(platforms)), key=lambda g: -float(platforms[g].D.sum())
    )
    plans: List[Optional[ExecutionPlan]] = [None] * len(platforms)
    frac_push = np.zeros_like(substrate.B_sm)
    frac_shuf = np.zeros_like(substrate.B_mr)
    frac_map = np.zeros_like(substrate.C_m)
    frac_red = np.zeros_like(substrate.C_r)
    for step_idx, g in enumerate(order):
        residual = substrate.residual(frac_push, frac_shuf, frac_map, frac_red)
        view = residual.view(platforms[g].D, platforms[g].alpha,
                             name=f"{platforms[g].name}/residual")
        plan, _ = planner(view, barriers, n_restarts=n_restarts, steps=steps,
                          seed=seed + 17 * step_idx, fixed_x=None,
                          device=device)
        plans[g] = plan
        # commit the job's utilization at FULL capacity (the fraction of
        # wall-clock each resource spends on it while the job runs)
        V_push, V_map, V_shuf, V_red = _job_volumes([platforms[g]], [plan])[0]
        T = max(makespan(platforms[g], plan, barriers), 1e-9)
        frac_push += (V_push / substrate.B_sm) / T
        frac_shuf += (V_shuf / substrate.B_mr) / T
        frac_map += (V_map / substrate.C_m) / T
        frac_red += (V_red / substrate.C_r) / T
    return plans


#: Selectable aggregation objectives for multi-job scheduling:
#: ``makespan`` minimizes the schedule's aggregate (max-over-jobs) makespan;
#: ``min_max_slowdown`` minimizes the worst per-job *slowdown* — the job's
#: contended makespan divided by its independent-plan (sole-tenant)
#: makespan — so no job is sacrificed to shorten the schedule.
SCHEDULE_OBJECTIVES = ("makespan", "min_max_slowdown")


def _anneal_stack(aggregate, logits_x0, logits_y0, scale, steps, lr,
                  tau0_frac, tau1_frac):
    """Anneal ``R`` restarts of one stacked problem — ``aggregate(x, y, mx,
    pmax)`` over ``(J, nS, nM)``/``(J, nR)`` plans — through the shared
    :func:`_adam_anneal`, as a batch of one request; return the restarts'
    ``(x, y, exact)`` with the hard max."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def loss(params, tau):
        mx, pmax = smooth_ops(tau)
        x = torch.softmax(params["x"], dim=-1)
        y = torch.softmax(params["y"], dim=-1)
        return aggregate(x, y, mx, pmax) / scale

    def exact(params):
        x = torch.softmax(params["x"], dim=-1)
        y = torch.softmax(params["y"], dim=-1)
        mx, pmax = hard_ops()
        return x, y, aggregate(x, y, mx, pmax)

    grad_all = vmap(vmap(grad(loss), in_dims=(0, None)))
    params = _adam_anneal(
        grad_all, {"x": logits_x0[None], "y": logits_y0[None]}, steps,
        scale.reshape(1), lr, tau0_frac, tau1_frac,
    )
    xs, ys, ex = vmap(vmap(exact))(params)
    return xs[0], ys[0], ex[0]


@_counted_solver(
    static_argnames=("barriers", "steps", "kappa", "objective")
)
def _solve_joint_batch(
    D_stack,  # (J, nS)
    alpha_stack,  # (J,)
    B_sm,
    B_mr,
    C_m,
    C_r,
    logits_x0,  # (R, J, nS, nM)
    logits_y0,  # (R, J, nR)
    scale,  # () — typical makespan, sets the tau schedule units
    refs,  # (J,) per-job reference makespans (1s for the makespan objective)
    kappa: float,  # static — smooth-usage-gate width, MB
    barriers: Tuple[str, str, str],
    steps: int,
    objective: str = "makespan",
    lr: float = 0.08,
    tau0_frac: float = 0.3,
    tau1_frac: float = 1e-3,
):
    """Anneal all jobs' stacked plans jointly against shared-capacity
    pricing; return per-restart (x, y) stacks plus their exact hard-max,
    smooth-gate aggregate objective values (the final selection re-prices
    in float64 with the hard gate)."""

    def aggregate(x, y, mx, pmax):
        # one vmapped instance of the volume/pricing graph regardless of J
        # (see _stacked_effective_volumes)
        vols = vmap(
            lambda D, xg, yg, a: analytic_volumes(D, xg, yg, a, xp=torch)
        )(D_stack, x, y, alpha_stack)
        eff = _stacked_effective_volumes(vols, kappa)
        spans = vmap(
            lambda *v: volume_model(*v, B_sm, B_mr, C_m, C_r, barriers, mx,
                                    pmax, xp=torch)["makespan"]
        )(*eff)
        if objective == "min_max_slowdown":
            spans = spans / refs * scale  # keep the tau schedule's units
        return mx(spans)

    return _anneal_stack(aggregate, logits_x0, logits_y0, scale, steps, lr,
                         tau0_frac, tau1_frac)


def _stacked_effective_volumes(vols, kappa: float, xp=torch, bg=None):
    """Batched :func:`shared_effective_volumes` over job-stacked volumes.

    ``vols`` is a 4-tuple of (J, ...) arrays (one entry per resource
    class, leading axis = job).  The contention inflation is one batched
    expression regardless of J: a per-job Python loop would grow the
    solver's per-step operation count (and, in the reference, its XLA
    compile time) linearly with the live jobs.

    ``bg`` optionally adds fixed per-resource background demand (a
    4-tuple of unbatched arrays) to every total: the residual volumes of
    live jobs *outside* the annealed stack, held at their incumbent
    routing (see the stack cap in :func:`replan_schedule`)."""
    out = []
    for c, V in enumerate(vols):
        total = V.sum(axis=0, keepdims=True)
        if bg is not None:
            total = total + bg[c][None]
        if kappa > 0:
            gate = V / (V + kappa)
        else:
            gate = xp.where(V > 1e-9, 1.0, 0.0)
        out.append(V + gate * (total - V))
    return tuple(out)


def _normalized_plans(xs, ys, meta: str) -> "list[ExecutionPlan]":
    """float64-renormalize a stacked (J, nS, nM)/(J, nR) candidate so every
    per-job plan validates exactly.

    Softmax-epsilon entries are zeroed below 1e-6 of their row max before
    renormalizing: warm-start logits put ~e^-20 mass on routes the
    incumbent never used, and at multi-GB job sizes those epsilon routes
    would otherwise materialize thousands of microscopic flows/chunks in
    the executors while carrying <1e-6 of the volume."""
    xs = np.clip(np.asarray(xs, dtype=np.float64), 0.0, None)
    ys = np.clip(np.asarray(ys, dtype=np.float64), 0.0, None)
    xs = np.where(xs >= 1e-6 * xs.max(axis=-1, keepdims=True), xs, 0.0)
    ys = np.where(ys >= 1e-6 * ys.max(axis=-1, keepdims=True), ys, 0.0)
    return [
        ExecutionPlan.renormalized(xs[g], ys[g], meta)
        for g in range(xs.shape[0])
    ]


@register_schedule_planner("joint")
def _joint_policy(substrate, platforms, barriers, *, mode, n_restarts, steps,
                  seed, device, objective: str = "makespan"):
    """The paper's end-to-end argument lifted across jobs: one annealed
    optimization over every job's stacked ``x``/``y`` against
    shared-capacity pricing.  Warm starts include the independent per-job
    plans (so the joint result is never worse than ``independent`` under
    the model) and node-rotated anti-affinity variants that bias different
    jobs toward different substrate entries.  ``objective`` selects the
    aggregate being annealed *and* the float64 selection criterion:
    ``makespan`` or ``min_max_slowdown`` (per-job contended makespan over
    its independent-plan sole-tenant makespan)."""
    J, nS, nM, nR = len(platforms), substrate.nS, substrate.nM, substrate.nR
    indep = _independent_policy(
        substrate, platforms, barriers,
        mode=mode, n_restarts=n_restarts, steps=steps, seed=seed,
        device=device,
    )
    rng = np.random.default_rng(seed)
    eps = 1e-9

    indep_x = np.stack([np.log(plan.x + eps) for plan in indep])
    indep_y = np.stack([np.log(plan.y + eps) for plan in indep])
    greedy_x = np.log(substrate.B_sm / substrate.B_sm.max() + eps)
    greedy_y = np.log(substrate.C_r / substrate.C_r.max() + eps)
    lx = [
        indep_x,  # the myopic candidate itself
        np.zeros((J, nS, nM)),  # uniform
        # anti-affinity: rotate each job's bandwidth-greedy bias so jobs
        # prefer different mappers/reducers
        np.stack([np.roll(greedy_x, g, axis=1) for g in range(J)]),
    ]
    ly = [
        indep_y,
        np.zeros((J, nR)),
        np.stack([np.roll(greedy_y, g) for g in range(J)]),
    ]
    while len(lx) < n_restarts:
        sigma = rng.uniform(0.3, 3.0)
        lx.append(rng.normal(0.0, sigma, size=(J, nS, nM)))
        ly.append(rng.normal(0.0, sigma, size=(J, nR)))

    D_stack = np.stack([p.D for p in platforms])
    alpha_stack = np.array([p.alpha for p in platforms])
    scale = max(
        makespan(platforms[0], uniform_plan(platforms[0]), barriers=barriers),
        1e-6,
    )
    # per-job fairness references: what each job would take as sole tenant
    # under its own independent plan (slowdown = contended / this)
    refs = np.maximum(
        np.array([
            makespan(p, plan, barriers=barriers)
            for p, plan in zip(platforms, indep)
        ]),
        1e-9,
    )
    # smooth usage-gate width: small against a typical per-link volume
    kappa = max(1e-3 * float(D_stack.sum()) / max(nM, 1), 1e-9)
    xs, ys, _ = _solve_joint_batch(
        _f32(D_stack, device),
        _f32(alpha_stack, device),
        *(_f32(a, device) for a in (substrate.B_sm, substrate.B_mr,
                                    substrate.C_m, substrate.C_r)),
        _f32(np.stack(lx[:n_restarts]), device),
        _f32(np.stack(ly[:n_restarts]), device),
        _f32(scale, device),
        _f32(refs, device),
        kappa=float(kappa),
        barriers=tuple(barriers),
        steps=steps,
        objective=objective,
    )
    xs, ys = xs.cpu().numpy(), ys.cpu().numpy()

    # exact float64 shared pricing picks the winner; the independent stack
    # competes as candidate -1
    cm = CostModel(platforms[0], barriers)
    candidates = [
        _normalized_plans(xs[r], ys[r], "joint") for r in range(xs.shape[0])
    ]
    candidates.append([
        dataclasses.replace(plan, meta="joint") for plan in indep
    ])

    def score(plans):
        priced = cm.price_shared(_job_volumes(platforms, plans), barriers)
        spans = np.array([float(out["makespan"]) for out in priced])
        if objective == "min_max_slowdown":
            return float(np.max(spans / refs))
        return float(np.max(spans))

    scores = [score(plans) for plans in candidates]
    return candidates[int(np.argmin(scores))]


# ---------------------------------------------------------------------------
# online re-planning: warm-started residual optimization + policy registry
# ---------------------------------------------------------------------------

@_counted_solver(static_argnames=("barriers", "steps"))
def _solve_residual_batch_many(
    resid,  # 6-tuple of (B, ...) tensors: resid_push, committed_push,
            # at_mapper, shuffle_pool, committed_shuffle, at_reducer
    caps,  # 4-tuple of (B, ...) tensors: B_sm, B_mr, C_m, C_r
    alpha,  # (B,)
    logits_x0,  # (B, R, nS, nM)
    logits_y0,  # (B, R, nR)
    scale,  # (B,)
    barriers: Tuple[str, str, str],
    steps: int,
    lr: float = 0.08,
    tau0_frac: float = 0.3,
    tau1_frac: float = 1e-3,
):
    """Anneal ``B`` independent jobs' *residual* makespans × ``R``
    restarts as one batched program — the remaining work of each observed
    job (re-routable buckets through candidate x/y, committed buckets
    fixed) priced by the same phase equations.  Per-request capacities
    carry each job's own dead-worker degradation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def residual_span(x, y, mx, pmax, resid_b, caps_b, alpha_b):
        V = residual_volumes(*resid_b, alpha_b, x, y, xp=torch)
        return volume_model(*V, *caps_b, barriers, mx, pmax,
                            xp=torch)["makespan"]

    def loss(params, tau, resid_b, caps_b, alpha_b, sc):
        mx, pmax = smooth_ops(tau)
        x = torch.softmax(params["x"], dim=-1)
        y = torch.softmax(params["y"], dim=-1)
        return residual_span(x, y, mx, pmax, resid_b, caps_b, alpha_b) / sc

    def exact(params, resid_b, caps_b, alpha_b):
        x = torch.softmax(params["x"], dim=-1)
        y = torch.softmax(params["y"], dim=-1)
        mx, pmax = hard_ops()
        return x, y, residual_span(x, y, mx, pmax, resid_b, caps_b, alpha_b)

    # inner vmap over restarts (per-request data shared), outer over requests
    per_restart = (0, None, None, None, None, None)
    grad_all = vmap(vmap(grad(loss), in_dims=per_restart))

    def grad_fn(params, tau):
        return grad_all(params, tau, resid, caps, alpha, scale)

    params = _adam_anneal(grad_fn, {"x": logits_x0, "y": logits_y0}, steps,
                          scale, lr, tau0_frac, tau1_frac)
    return vmap(vmap(exact, in_dims=(0, None, None, None)))(
        params, resid, caps, alpha
    )


def _incremental_budget(n_restarts: int, steps: int) -> Tuple[int, int]:
    """The warm-start incremental re-solve budget: at most 4 restarts
    (the incumbent plus jittered copies — heuristic restarts add nothing
    when the answer is already near the incumbent) and an eighth of the
    anneal, floored at 25 steps so Adam can still move mass."""
    return max(min(n_restarts, 4), 1), max(steps // 8, 25)


def _shared_incremental_budget(
    n_restarts: int, steps: int, n_jobs: int
) -> Tuple[int, int]:
    """One warm-start anneal budget for the whole *stack*:
    :func:`replan_schedule` solves every live job in a single batched
    anneal whose per-step cost already scales with the live-job count, so
    the incremental polish divides the per-job step budget by the stack
    size instead of paying :func:`_incremental_budget` once per job.  The
    divisor is quantized to powers of two, so as the live set grows and
    shrinks across decision points the budget lands on a handful of values
    (25 / 12 / 8) and the solver keys keep hitting.  Floored at 8 steps:
    the polish starts at the incumbent logits and the float64 selection
    keeps the never-modeled-worse guarantee regardless of how short it
    is."""
    n_eff, steps_eff = _incremental_budget(n_restarts, steps)
    if n_jobs > 1:
        div = 1 << int(np.ceil(np.log2(n_jobs)))
        steps_eff = max(steps_eff // div, 8)
    return n_eff, steps_eff


def _replan_logits(platform, incumbent, n_restarts, seed, incremental):
    """Warm-start logits for one residual re-solve, float32 numpy: the
    incumbent first (it must compete), then — full mode — the standard
    heuristic+random restarts, or — incremental mode — small jitters of
    the incumbent itself (stay in its basin, polish at low temperature)."""
    eps = 1e-9
    lx_inc = np.log(np.asarray(incumbent.x) + eps)
    ly_inc = np.log(np.asarray(incumbent.y) + eps)
    if incremental:
        rng = np.random.default_rng(seed)
        lx, ly = [lx_inc], [ly_inc]
        while len(lx) < n_restarts:
            lx.append(lx_inc + rng.normal(0.0, 0.25, size=lx_inc.shape))
            ly.append(ly_inc + rng.normal(0.0, 0.25, size=ly_inc.shape))
        return (np.stack(lx[:n_restarts]).astype(np.float32),
                np.stack(ly[:n_restarts]).astype(np.float32))
    lx0, ly0 = _initial_logits(platform, max(n_restarts - 1, 1), seed)
    lx = np.concatenate([lx_inc[None], lx0.numpy()])[:n_restarts]
    ly = np.concatenate([ly_inc[None], ly0.numpy()])[:n_restarts]
    return lx.astype(np.float32), ly.astype(np.float32)

#: low-temperature anneal for incremental re-solves: the tau schedule
#: starts already almost hard (the incumbent is assumed near-optimal) and
#: the learning rate is dropped so the polish cannot jump basins.
_INCREMENTAL_ANNEAL = dict(lr=0.05, tau0_frac=0.02, tau1_frac=1e-3)

#: incremental co-replans anneal at most this many live jobs at once (the
#: most-behind ones); the rest keep their incumbent routing and enter the
#: solve as fixed background contention.  Keeps a decision point's anneal
#: tensors — and its wall-clock — flat as jobs accumulate; the float64
#: selection still re-prices the full live stack, so never-modeled-worse
#: is unaffected.
_INCREMENTAL_STACK_CAP = 16


def _degraded_platform(platform: Platform, progress: JobProgress):
    """``platform`` with this job's dead mappers collapsed 1000x.  A dead
    worker is a capacity fact the drift traces cannot express: collapse
    its compute and ingest links so the solver (and the float64
    selection) routes the residual around it.  Not zero — softmax plans
    keep epsilon mass everywhere and the phase equations have no usage
    gate on push links."""
    changes = {}
    if progress.map_alive is not None and not progress.map_alive.all():
        alive = progress.map_alive.astype(bool)
        changes.update(
            C_m=np.where(alive, platform.C_m, platform.C_m * 1e-3),
            B_sm=np.where(alive[None, :], platform.B_sm,
                          platform.B_sm * 1e-3),
        )
    if progress.red_alive is not None and not progress.red_alive.all():
        alive_r = progress.red_alive.astype(bool)
        changes.update(
            C_r=np.where(alive_r, platform.C_r, platform.C_r * 1e-3),
            B_mr=np.where(alive_r[None, :], platform.B_mr,
                          platform.B_mr * 1e-3),
        )
    if not changes:
        return platform
    return dataclasses.replace(platform, **changes)


def replan_batch(
    platforms: Sequence[Platform],
    incumbents: Sequence[ExecutionPlan],
    progresses=None,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 8,
    steps: int = 200,
    seed: int = 0,
    seeds: Optional[Sequence[int]] = None,
    incremental: bool = False,
    device: Optional[DeviceLike] = None,
) -> "list[PlanResult]":
    """Re-optimize ``N`` running jobs' plans against their *remaining*
    work, solo residual pricing per job, batched into one solve per shape
    group on ``device`` — the residual counterpart of
    :func:`optimize_plan_batch` (and exactly N :func:`replan` calls).
    ``progresses`` is one :class:`~repro_torch.core.makespan.JobProgress`
    (or ``None`` = fresh) per job; ``seeds`` one seed per job (default:
    ``seed`` for all).

    ``incremental=True`` swaps the full anneal for a warm-started polish:
    at most 4 restarts (incumbent + jitters), an eighth of the steps, and
    a low-temperature schedule (:data:`_INCREMENTAL_ANNEAL`) — the cheap
    mode whose measured wall-clock :class:`SolveTimeEMA` feeds into
    :func:`swap_charge`.  Every candidate is still re-priced in float64
    and the incumbent still competes, so "never modeled-worse" holds in
    both modes.
    """
    dev = resolve_device(device)
    barriers = tuple(barriers)
    platforms = list(platforms)
    incumbents = list(incumbents)
    if progresses is None:
        progresses = [None] * len(platforms)
    progresses = [
        JobProgress.fresh(p) if pr is None else pr
        for p, pr in zip(platforms, progresses)
    ]
    if not (len(platforms) == len(incumbents) == len(progresses)):
        raise ValueError(
            f"one incumbent+progress per platform, got {len(platforms)} "
            f"platforms, {len(incumbents)} incumbents, "
            f"{len(progresses)} progresses"
        )
    if seeds is None:
        seeds = [seed] * len(platforms)
    seeds = list(seeds)
    n_eff, steps_eff = (
        _incremental_budget(n_restarts, steps) if incremental
        else (n_restarts, steps)
    )
    anneal = _INCREMENTAL_ANNEAL if incremental else {}

    degraded = [
        _degraded_platform(p, pr) for p, pr in zip(platforms, progresses)
    ]
    cms = [CostModel(p, barriers) for p in degraded]
    inc_outs = [
        cm.price_residual(pr, inc)
        for cm, pr, inc in zip(cms, progresses, incumbents)
    ]
    inc_spans = [float(out["makespan"]) for out in inc_outs]

    groups: Dict[Tuple[int, int, int], list] = {}
    for g, p in enumerate(platforms):
        groups.setdefault((p.nS, p.nM, p.nR), []).append(g)
    results: "list[Optional[PlanResult]]" = [None] * len(platforms)
    for idxs in groups.values():
        logits = [
            _replan_logits(degraded[g], incumbents[g], n_eff, seeds[g],
                           incremental)
            for g in idxs
        ]
        resid = tuple(
            _f32(a, dev)
            for a in JobProgress.stack([progresses[g] for g in idxs])
        )
        caps = tuple(
            _f32(np.stack([
                np.asarray(getattr(degraded[g], f), dtype=np.float64)
                for g in idxs
            ]), dev)
            for f in ("B_sm", "B_mr", "C_m", "C_r")
        )
        xs, ys, _ = _solve_residual_batch_many(
            resid,
            caps,
            _f32(np.array([progresses[g].alpha for g in idxs]), dev),
            torch.from_numpy(np.stack([lx for lx, _ in logits])).to(dev),
            torch.from_numpy(np.stack([ly for _, ly in logits])).to(dev),
            _f32(np.array([max(inc_spans[g], 1e-6) for g in idxs]), dev),
            barriers=barriers,
            steps=steps_eff,
            **anneal,
        )
        xs, ys = xs.cpu().numpy(), ys.cpu().numpy()
        for b, g in enumerate(idxs):
            best_plan, best_span, best_out = (
                incumbents[g], inc_spans[g], inc_outs[g]
            )
            for r in range(xs.shape[1]):
                plan = ExecutionPlan.renormalized(xs[b, r], ys[b, r],
                                                  "replan")
                out = cms[g].price_residual(progresses[g], plan)
                if float(out["makespan"]) < best_span:
                    best_plan, best_span, best_out = (
                        plan, float(out["makespan"]), out
                    )
            results[g] = PlanResult(
                plan=best_plan,
                makespan=best_span,
                breakdown=attribute_phases(best_out),
                mode="replan",
                barriers=barriers,
                objective=best_span,
            )
    return results  # type: ignore[return-value]


def replan(
    platform: Platform,
    incumbent: ExecutionPlan,
    progress: Optional[JobProgress] = None,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 8,
    steps: int = 200,
    seed: int = 0,
    incremental: bool = False,
    device: Optional[DeviceLike] = None,
) -> PlanResult:
    """Re-optimize a running job's plan against its *remaining* work.

    ``platform`` should be the **current view** of the fabric
    (:meth:`repro_torch.core.platform.Substrate.at` folds capacity drift
    in); ``progress`` is the executor's observed residual
    (:class:`repro_torch.core.makespan.JobProgress`; ``None`` means the
    job has not started — ordinary planning).  The annealed solver
    **warm-starts from the incumbent plan's logits** (plus the standard
    heuristic and random restarts), every candidate is re-priced in
    float64 through :meth:`CostModel.price_residual`, and the incumbent
    itself competes — so the returned plan is never modeled worse than
    keeping it, and is the *same object* when keeping it wins.

    ``incremental=True`` is the cheap warm-started mode (see
    :func:`replan_batch`).  The returned :class:`PlanResult`'s
    ``makespan``/``breakdown`` are the modeled **remaining** seconds from
    the observation instant.  This is a batch of one through
    :func:`replan_batch`.
    """
    return replan_batch(
        [platform], [incumbent], [progress], barriers=barriers,
        n_restarts=n_restarts, steps=steps, seed=seed,
        incremental=incremental, device=device,
    )[0]


# ---------------------------------------------------------------------------
# schedule-aware online re-planning: joint residual optimization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleReplanResult:
    """The outcome of one joint residual co-replan over all live jobs.

    ``plans`` holds one plan per input job (the incumbent object itself for
    done jobs, and for every job when keeping the whole incumbent stack
    won); ``before``/``after`` are the per-job modeled remaining seconds
    under shared-capacity residual pricing for the incumbent stack and the
    returned stack respectively.  The incumbent stack competes as a
    candidate, so ``makespan`` (the aggregate ``max(after)``) is never
    modeled worse than ``max(before)``."""

    plans: Tuple[ExecutionPlan, ...]
    before: Tuple[float, ...]
    after: Tuple[float, ...]
    makespan: float
    barriers: Tuple[str, str, str]

    @property
    def improvement(self) -> float:
        """Aggregate modeled seconds the co-replan removed (>= 0)."""
        return max(self.before, default=0.0) - self.makespan


@_counted_solver(static_argnames=("barriers", "steps", "kappa"))
def _solve_residual_shared_batch(
    resid_stack,  # 6-tuple stacked over jobs: (J,nS) (J,nS,nM) (J,nM)
                  #                            (J,nM) (J,nM,nR) (J,nR)
    caps_stack,  # 4-tuple stacked over jobs (dead workers degraded per job)
    alpha_stack,  # (J,)
    bg_stack,  # 4-tuple unbatched: residual demand of live jobs OUTSIDE
               # the annealed stack, held at their incumbent routing
    logits_x0,  # (R, J, nS, nM)
    logits_y0,  # (R, J, nR)
    scale,  # ()
    kappa: float,  # static — smooth-usage-gate width, MB
    barriers: Tuple[str, str, str],
    steps: int,
    lr: float = 0.08,
    tau0_frac: float = 0.3,
    tau1_frac: float = 1e-3,
):
    """Anneal ``R`` restarts of the *joint* residual objective: every live
    job's remaining work under its candidate plan, contention-inflated by
    the other jobs' residual demand (:func:`shared_effective_volumes`) and
    priced through the shared phase equations."""

    def aggregate(x, y, mx, pmax):
        # one vmapped instance of the volume/pricing graph regardless of J
        vols = vmap(
            lambda r, a, xg, yg: residual_volumes(*r, a, xg, yg, xp=torch)
        )(resid_stack, alpha_stack, x, y)
        eff = _stacked_effective_volumes(vols, kappa, bg=bg_stack)
        spans = vmap(
            lambda v, c: volume_model(*v, *c, barriers, mx, pmax,
                                      xp=torch)["makespan"]
        )(eff, caps_stack)
        return mx(spans)

    return _anneal_stack(aggregate, logits_x0, logits_y0, scale, steps, lr,
                         tau0_frac, tau1_frac)


def _degraded_caps(substrate, progress: JobProgress):
    """Per-job capacity arrays with this job's dead mappers *and
    reducers* collapsed 1000x (same rationale as :func:`replan`: liveness
    is a capacity fact traces cannot express; not zero because softmax
    plans keep epsilon mass)."""
    B_sm, B_mr = substrate.B_sm, substrate.B_mr
    C_m, C_r = substrate.C_m, substrate.C_r
    if progress.map_alive is not None and not progress.map_alive.all():
        alive = progress.map_alive.astype(bool)
        C_m = np.where(alive, C_m, C_m * 1e-3)
        B_sm = np.where(alive[None, :], B_sm, B_sm * 1e-3)
    if progress.red_alive is not None and not progress.red_alive.all():
        alive_r = progress.red_alive.astype(bool)
        C_r = np.where(alive_r, C_r, C_r * 1e-3)
        B_mr = np.where(alive_r[None, :], B_mr, B_mr * 1e-3)
    return B_sm, B_mr, C_m, C_r


def _score_residual_stack(caps_list, progresses, plans, barriers):
    """float64 shared-residual pricing of one candidate stack: per-job
    residual volumes, hard-gate contention inflation, exact phase equations
    with each job's (possibly liveness-degraded) capacities."""
    vols = [
        residual_volumes(
            pr.resid_push, pr.committed_push, pr.at_mapper, pr.shuffle_pool,
            pr.committed_shuffle, pr.at_reducer, pr.alpha,
            *_live_plan_arrays(pr, plan), xp=np,
        )
        for pr, plan in zip(progresses, plans)
    ]
    eff = shared_effective_volumes(vols, kappa=0.0, xp=np)
    mx, pmax = _np_hard_ops()
    return [
        float(volume_model(
            np.asarray(v[0], dtype=np.float64),
            np.asarray(v[1], dtype=np.float64),
            np.asarray(v[2], dtype=np.float64),
            np.asarray(v[3], dtype=np.float64),
            *caps, barriers, mx, pmax, xp=np,
        )["makespan"])
        for v, caps in zip(eff, caps_list)
    ]


def score_residual_shared(
    substrate, progresses, plans,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
) -> "list[float]":
    """Per-job modeled remaining seconds of ``plans`` under shared-capacity
    residual pricing (float64, hard gate, per-job dead workers degraded) —
    the exact selection metric :func:`replan_schedule` uses.  Exposed so a
    caller that adopts only *part* of a co-replanned stack can re-price the
    mix it actually executes."""
    caps_list = [_degraded_caps(substrate, pr) for pr in progresses]
    return _score_residual_stack(caps_list, progresses, plans,
                                 tuple(barriers))


def replan_schedule(
    substrate,
    incumbents: Sequence[ExecutionPlan],
    progresses,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 8,
    steps: int = 200,
    seed: int = 0,
    incremental: bool = False,
    device: Optional[DeviceLike] = None,
) -> ScheduleReplanResult:
    """Co-replan **all** live jobs' residuals jointly on their shared
    substrate — the schedule-aware counterpart of :func:`replan`; the
    anneal runs on ``device``.

    Re-optimizing each job's residual *solo* re-introduces at the schedule
    level exactly the myopia the paper's end-to-end argument is about:
    every job grabs the same fast links because none of them models the
    others.  Here one annealed optimization steers every live job's
    stacked ``x``/``y`` against :meth:`CostModel.price_residual_shared` —
    each job's remaining work inflated by the other jobs' residual demand
    on every resource it touches — warm-started from the stacked incumbent
    logits.

    ``substrate`` should be the current view of the fabric
    (:meth:`repro_torch.core.platform.Substrate.at` folds drift in);
    ``progresses`` is a sequence of :class:`JobProgress` (or a
    :class:`repro_torch.core.simulate.ProgressSnapshot`, whose ``jobs``
    are used), parallel to ``incumbents``.  Done jobs pass through
    untouched with zero residual spans; every candidate stack is re-priced
    in float64 and the incumbent stack competes, so the returned aggregate
    is never modeled worse than keeping every plan (and the plan *objects*
    are the incumbents when keeping wins).

    ``incremental=True`` is the warm-started cheap mode (mirroring
    :func:`replan_batch`): at most 4 restarts — the incumbent stack plus
    jittered copies of it — and one shared anneal budget for the whole
    stack (:func:`_shared_incremental_budget`) at a low-temperature
    schedule.  Past :data:`_INCREMENTAL_STACK_CAP` live jobs only the
    most-behind ones enter the anneal; the rest keep their incumbent
    routing and enter the solve as fixed background contention.  The
    float64 selection (and with it the never-modeled-worse guarantee) is
    identical in both modes.
    """
    dev = resolve_device(device)
    barriers = tuple(barriers)
    if hasattr(progresses, "jobs"):  # a ProgressSnapshot
        progresses = list(progresses.jobs)
    progresses = list(progresses)
    incumbents = list(incumbents)
    if len(progresses) != len(incumbents):
        raise ValueError(
            f"one incumbent per progress, got {len(incumbents)} incumbents "
            f"and {len(progresses)} progresses"
        )
    live = [g for g, pr in enumerate(progresses) if not pr.done]
    n = len(progresses)
    plans_out: List[ExecutionPlan] = list(incumbents)
    before_out = [0.0] * n
    after_out = [0.0] * n
    if not live:
        return ScheduleReplanResult(
            plans=tuple(plans_out), before=tuple(before_out),
            after=tuple(after_out), makespan=0.0, barriers=barriers,
        )

    live_prog = [progresses[g] for g in live]
    live_inc = [incumbents[g] for g in live]
    caps_list = [_degraded_caps(substrate, pr) for pr in live_prog]
    before = _score_residual_stack(caps_list, live_prog, live_inc, barriers)
    scale = max(max(before), 1e-6)

    J, nS, nM, nR = len(live), substrate.nS, substrate.nM, substrate.nR
    eps = 1e-9
    rng = np.random.default_rng(seed)
    n_eff, steps_eff = (
        _shared_incremental_budget(n_restarts, steps, J) if incremental
        else (n_restarts, steps)
    )
    anneal = _INCREMENTAL_ANNEAL if incremental else {}
    # incremental stack cap: anneal only the K most-behind live jobs and
    # hold everyone else at their incumbent routing, folded into the
    # solver's contention totals as fixed background demand.  The f64
    # selection below still re-prices the FULL live stack (hot candidates
    # spliced over incumbent plans), so the never-modeled-worse guarantee
    # is unchanged.
    if incremental and J > _INCREMENTAL_STACK_CAP:
        worst = np.argsort(np.asarray(before))[::-1]
        hot = sorted(int(s) for s in worst[:_INCREMENTAL_STACK_CAP])
    else:
        hot = list(range(J))
    cold = sorted(set(range(J)) - set(hot))
    hot_prog = [live_prog[s] for s in hot]
    hot_inc = [live_inc[s] for s in hot]
    K = len(hot)
    inc_x = np.stack([np.log(np.asarray(p.x) + eps) for p in hot_inc])
    inc_y = np.stack([np.log(np.asarray(p.y) + eps) for p in hot_inc])
    lx = [inc_x]
    ly = [inc_y]
    if incremental:
        # stay in the incumbent stack's basin: jittered copies only
        while len(lx) < n_eff:
            lx.append(inc_x + rng.normal(0.0, 0.25, size=inc_x.shape))
            ly.append(inc_y + rng.normal(0.0, 0.25, size=inc_y.shape))
    else:
        lx.append(np.zeros((K, nS, nM)))
        ly.append(np.zeros((K, nR)))
        # anti-affinity rotations, as in the offline joint policy: bias
        # different jobs toward different substrate entries
        greedy_x = np.log(substrate.B_sm / substrate.B_sm.max() + eps)
        greedy_y = np.log(substrate.C_r / substrate.C_r.max() + eps)
        lx.append(np.stack([np.roll(greedy_x, g, axis=1) for g in range(K)]))
        ly.append(np.stack([np.roll(greedy_y, g) for g in range(K)]))
        while len(lx) < n_eff:
            sigma = rng.uniform(0.3, 3.0)
            lx.append(rng.normal(0.0, sigma, size=(K, nS, nM)))
            ly.append(rng.normal(0.0, sigma, size=(K, nR)))

    bg = [np.zeros((nS, nM)), np.zeros(nM), np.zeros((nM, nR)), np.zeros(nR)]
    for s in cold:
        pr, plan = live_prog[s], live_inc[s]
        v = residual_volumes(
            pr.resid_push, pr.committed_push, pr.at_mapper, pr.shuffle_pool,
            pr.committed_shuffle, pr.at_reducer, pr.alpha,
            *_live_plan_arrays(pr, plan), xp=np,
        )
        for c in range(4):
            bg[c] += v[c]
    total_resid = float(sum(
        pr.remaining_mb()["reduce"] for pr in live_prog
    ))
    kappa = max(1e-3 * total_resid / max(nM, 1), 1e-9)
    # quantize to half-decade buckets so successive decision points with
    # shrinking residuals share a solver key (it is a static argument)
    kappa = float(10.0 ** (round(np.log10(kappa) * 2.0) / 2.0))
    xs, ys, _ = _solve_residual_shared_batch(
        tuple(_f32(a, dev) for a in JobProgress.stack(hot_prog)),
        tuple(_f32(np.stack([caps_list[s][c] for s in hot]), dev)
              for c in range(4)),
        _f32(np.array([pr.alpha for pr in hot_prog]), dev),
        tuple(_f32(a, dev) for a in bg),
        _f32(np.stack(lx[:n_eff]), dev),
        _f32(np.stack(ly[:n_eff]), dev),
        _f32(scale, dev), kappa=float(kappa), barriers=barriers,
        steps=steps_eff, **anneal,
    )
    xs, ys = xs.cpu().numpy(), ys.cpu().numpy()

    best_live, best_after, best_score = live_inc, before, max(before)
    for r in range(xs.shape[0]):
        cand_hot = _normalized_plans(xs[r], ys[r], "replan_shared")
        cand = list(live_inc)
        for slot, s in enumerate(hot):
            cand[s] = cand_hot[slot]
        spans = _score_residual_stack(caps_list, live_prog, cand, barriers)
        if max(spans) < best_score:
            best_live, best_after, best_score = cand, spans, max(spans)

    for slot, g in enumerate(live):
        plans_out[g] = best_live[slot]
        before_out[g] = before[slot]
        after_out[g] = best_after[slot]
    return ScheduleReplanResult(
        plans=tuple(plans_out), before=tuple(before_out),
        after=tuple(after_out), makespan=best_score, barriers=barriers,
    )


# ---------------------------------------------------------------------------
# replan-cost hysteresis: pricing the swap itself
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """How an online policy re-plans when it fires.

    ``shared=True`` co-replans all live jobs jointly through
    :func:`replan_schedule` (shared-capacity residual pricing) instead of
    each job solo through :func:`replan`.

    ``hysteresis`` is the replan-cost damping factor: a candidate swap is
    charged :func:`swap_charge` (solver wall-clock plus the modeled data
    movement of re-routing its queued bytes) and fires only when its
    modeled savings exceed ``hysteresis ×`` that charge.  ``0`` swaps on
    any modeled improvement (independent of the solver cost); ``inf``
    never swaps, reproducing the ``static`` policy byte-for-byte (no
    solve is even attempted).

    ``solver_cost_s`` is the solver wall-clock the charge uses.  ``None``
    (the default) charges the **measured** cost: a
    :class:`SolveTimeEMA` of this run's observed solve times — first
    calls of a solver key excluded, quantized to half-decade buckets for stability —
    so a cheap incremental re-solve is charged what it actually costs
    instead of the old hardcoded 1-second guess.  A float pins the charge
    to that estimate (deterministic and host-independent).

    ``incremental=True`` re-plans in the warm-started incremental mode
    (few low-temperature steps from the incumbent — see
    :func:`replan_batch` / :func:`replan_schedule`) instead of a full
    anneal; paired with measured costs, the hysteresis gate then charges
    the *small* solve the policy actually runs.

    ``speculation`` steers the executor's speculative-execution knob on
    failure decisions: ``True`` turns speculation *on* for every live job
    once a failure has been observed (duplicate straggling work — a dead
    worker's recovery traffic creates exactly the stragglers speculation
    hedges), ``False`` forces it off, ``None`` (default) leaves each
    job's :class:`~repro_torch.core.simulate.SimConfig` untouched.

    ``candidate_pricing`` selects how the replan gate scores the
    incumbent stack against the co-replanned candidate stack.
    ``"model"`` (default) keeps the closed-form float64 residual model
    (:func:`score_residual_shared`).  ``"fluid"`` prices **both** stacks
    with a shared-capacity fluid rollout
    (:func:`repro_torch.core.fluid.fluid_score_residual`) from the decision
    instant — folding any remaining capacity drift into the horizon —
    and adopts the candidate only on a strict fluid improvement, so the
    incumbent still competes in float64 and the never-priced-worse
    guarantee carries over to the pricing in force.  Fluid pricing
    scores the *whole* stack at once and therefore requires
    ``shared=True``."""

    shared: bool = False
    hysteresis: float = 0.0
    solver_cost_s: Optional[float] = None
    incremental: bool = False
    speculation: Optional[bool] = None
    candidate_pricing: str = "model"

    def __post_init__(self):
        if not (self.hysteresis >= 0.0):  # rejects negatives and NaN
            raise ValueError(
                f"hysteresis must be >= 0 (inf allowed), got "
                f"{self.hysteresis}"
            )
        if self.solver_cost_s is not None \
                and not (self.solver_cost_s >= 0.0):
            raise ValueError(
                f"solver_cost_s must be >= 0 (or None = measured), got "
                f"{self.solver_cost_s}"
            )
        if self.candidate_pricing not in ("model", "fluid"):
            raise ValueError(
                'candidate_pricing must be "model" or "fluid", got '
                f"{self.candidate_pricing!r}"
            )
        if self.candidate_pricing == "fluid" and not self.shared:
            raise ValueError(
                'candidate_pricing="fluid" prices the whole co-replanned '
                "stack with one rollout — it requires shared=True"
            )


class SolveTimeEMA:
    """Running estimate of one re-planning solve's wall-clock seconds —
    what :func:`swap_charge` charges as ``solver_cost_s``.

    ``fixed`` pins the charge to a constant (deterministic,
    host-independent — the pre-measurement behavior); ``None`` tracks an
    exponential moving average of *observed* solve times.  Samples of a
    solver key's first call in the process are excluded — that call pays
    once-per-process set-up (on the card: the CUDA context and cuBLAS
    handles), not per decision, so charging it to one unlucky swap would
    be wrong in both directions.  The caller synchronizes the solve's
    device before both clock reads, so a sample is the solve, not its
    launches.  The reported charge is quantized
    to half-decade buckets (1.0, 0.32, 0.1, ...) so the hysteresis gate
    keys off the solve's order of magnitude, not scheduler noise; before
    the first warm sample it falls back to ``fallback`` (the historical
    1-second estimate)."""

    def __init__(self, fixed: Optional[float] = None, beta: float = 0.3,
                 fallback: float = 1.0):
        if fixed is not None and not (fixed >= 0.0):
            raise ValueError(f"fixed must be >= 0 or None, got {fixed}")
        if not (0.0 < beta <= 1.0):
            raise ValueError(f"beta must be in (0, 1], got {beta}")
        self.fixed = fixed
        self.beta = float(beta)
        self.fallback = float(fallback)
        self.ema: Optional[float] = None
        self.samples = 0
        self.excluded = 0

    def observe(self, seconds: float, compiled: bool = False) -> None:
        """Fold one measured solve in; ``compiled=True`` marks a cold
        sample (excluded from the average)."""
        if compiled or not np.isfinite(seconds) or seconds <= 0.0:
            self.excluded += 1
            return
        self.samples += 1
        self.ema = (
            float(seconds) if self.ema is None
            else (1.0 - self.beta) * self.ema + self.beta * float(seconds)
        )

    def charge_s(self) -> float:
        """The solver cost a swap is charged right now (seconds)."""
        if self.fixed is not None:
            return float(self.fixed)
        if self.ema is None:
            return self.fallback
        return float(10.0 ** (round(np.log10(max(self.ema, 1e-9)) * 2.0)
                              / 2.0))

    def __repr__(self):
        mode = (f"fixed={self.fixed}" if self.fixed is not None
                else f"ema={self.ema}")
        return (f"SolveTimeEMA({mode}, charge_s={self.charge_s():.3g}, "
                f"samples={self.samples}, excluded={self.excluded})")


def swap_charge(
    platform,
    progress: JobProgress,
    incumbent: ExecutionPlan,
    candidate: ExecutionPlan,
    solver_cost_s: float = 1.0,
) -> float:
    """Modeled cost (seconds) of swapping ``incumbent`` for ``candidate``
    on a running job — what replan-cost hysteresis charges a swap before
    it may fire.

    The charge is the solver wall-clock estimate plus the data-movement
    cost of re-routing the job's committed-but-queued bytes: push MB still
    queued at the sources move ``0.5·Σᵢ resid_push[i]·‖x'ᵢ − xᵢ‖₁`` (the MB
    whose destination actually changes) and pooled shuffle MB move
    ``0.5·Σⱼ pool[j]·‖y' − y‖₁``, each priced at the fabric's mean link
    bandwidth.  The executor itself re-queues pulled-back chunks for free —
    this is a *modeled* control charge (connection churn, re-registration,
    coordination) that damps thrash, per the communication-pattern modeling
    argument that re-planning overhead must be priced rather than assumed
    free."""
    x0, x1 = np.asarray(incumbent.x), np.asarray(candidate.x)
    y0, y1 = np.asarray(incumbent.y), np.asarray(candidate.y)
    moved_push = 0.5 * float(
        (progress.resid_push * np.abs(x1 - x0).sum(axis=1)).sum()
    )
    moved_shuf = 0.5 * float(
        (progress.shuffle_pool * np.abs(y1 - y0).sum()).sum()
    )
    return (
        float(solver_cost_s)
        + moved_push / max(float(np.mean(platform.B_sm)), 1e-9)
        + moved_shuf / max(float(np.mean(platform.B_mr)), 1e-9)
    )


#: name -> fn(kind, snapshot) -> bool (replan now?)
_ONLINE_POLICIES: Dict[str, Callable] = {}

#: name -> the OnlineConfig the policy registered with (default when absent)
_ONLINE_CONFIGS: Dict[str, OnlineConfig] = {}


def register_online_policy(
    name: str, fn: Optional[Callable] = None, *,
    config: Optional[OnlineConfig] = None,
):
    """Register an online re-planning policy under ``name`` (decorator or
    direct call, mirroring :func:`register_planner`).  A policy is called
    at every candidate decision point of
    :meth:`repro_torch.api.GeoSchedule.run_online` with ``(kind, snapshot)`` —
    ``kind`` one of ``"arrival"`` / ``"drift"`` / ``"failure"`` /
    ``"tick"``, ``snapshot`` the executor's
    :class:`repro_torch.core.simulate.ProgressSnapshot` at that instant — and
    returns whether to re-plan the active jobs now.

    ``config`` attaches an :class:`OnlineConfig` describing *how* the
    policy re-plans when it fires (solo vs shared co-replanning, the
    replan-cost hysteresis factor); it defaults to solo re-planning with no
    hysteresis, and callers of ``run_online`` may override it per run."""
    if fn is None:
        return lambda f: register_online_policy(name, f, config=config)
    if name in _ONLINE_POLICIES:
        raise ValueError(f"online policy {name!r} is already registered")
    _ONLINE_POLICIES[name] = fn
    if config is not None:
        _ONLINE_CONFIGS[name] = config
    return fn


def get_online_policy(name: str) -> Callable:
    try:
        return _ONLINE_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"online policy must be one of {available_online_policies()}, "
            f"got {name!r}"
        ) from None


def available_online_policies() -> Tuple[str, ...]:
    """Names of every registered online re-planning policy."""
    return tuple(_ONLINE_POLICIES)


def get_online_config(name: str) -> OnlineConfig:
    """The :class:`OnlineConfig` policy ``name`` registered with (the
    default — solo re-planning, no hysteresis — when it registered none)."""
    get_online_policy(name)  # validate the name
    return _ONLINE_CONFIGS.get(name, OnlineConfig())


@register_online_policy("static")
def _static_online_policy(kind, snapshot):
    """Never re-plan: the frozen offline pipeline, reproduced exactly —
    the baseline every online policy is measured against."""
    return False


@register_online_policy("reactive")
def _reactive_online_policy(kind, snapshot):
    """Re-plan whenever the world changes: a job arrives, a worker fails,
    or a traced capacity steps."""
    return kind in ("arrival", "failure", "drift")


@register_online_policy("horizon")
def _horizon_online_policy(kind, snapshot):
    """Re-plan on a fixed cadence (every ``replan_dt`` tick), ignoring
    event triggers — the rolling-horizon control baseline."""
    return kind == "tick"


@register_online_policy(
    "reactive_shared",
    config=OnlineConfig(shared=True, hysteresis=1.0),
)
def _reactive_shared_policy(kind, snapshot):
    """``reactive``'s triggers, but schedule-aware and cost-aware: every
    firing co-replans all live jobs' residuals jointly against
    shared-capacity pricing (:func:`replan_schedule`), and each per-job
    swap must beat its :func:`swap_charge` under hysteresis 1.0."""
    return kind in ("arrival", "failure", "drift")


@register_online_policy(
    "horizon_shared",
    config=OnlineConfig(shared=True, hysteresis=1.0),
)
def _horizon_shared_policy(kind, snapshot):
    """``horizon``'s fixed cadence with shared co-replanning and
    replan-cost hysteresis (see :data:`OnlineConfig`)."""
    return kind == "tick"


@register_online_policy(
    "reactive_incremental",
    config=OnlineConfig(shared=True, hysteresis=1.0, incremental=True),
)
def _reactive_incremental_policy(kind, snapshot):
    """``reactive_shared``'s triggers and shared co-replanning, but each
    firing runs the warm-started *incremental* solve (few low-temperature
    anneal steps from the incumbent logits) and the hysteresis gate
    charges the measured incremental solve time — the cheap-and-frequent
    corner of the replan-cost trade-off."""
    return kind in ("arrival", "failure", "drift")


@register_online_policy(
    "reactive_fluid",
    config=OnlineConfig(shared=True, hysteresis=1.0, incremental=True,
                        candidate_pricing="fluid"),
)
def _reactive_fluid_policy(kind, snapshot):
    """``reactive_incremental``'s triggers and warm-started shared
    solves, with the replan gate scored by a **fluid rollout**
    (``candidate_pricing="fluid"``): incumbent and candidate stacks are
    both drained through :func:`repro_torch.core.fluid.fluid_score_residual`
    from the decision instant — drift-aware, float64 — and the swap
    fires only on a strict fluid improvement that clears the hysteresis
    charge.  The scale-tier corner of the trade-off: pricing cost grows
    with flows, not chunks."""
    return kind in ("arrival", "failure", "drift")


@register_online_policy(
    "reactive_failover",
    config=OnlineConfig(shared=True, hysteresis=1.0, speculation=True),
)
def _reactive_failover_policy(kind, snapshot):
    """``reactive_shared``'s triggers and shared co-replanning, plus the
    fault-reaction knob: the first failure decision also switches every
    live job's speculative execution *on*
    (:meth:`_MultiSim.set_speculation`), so recovery-induced stragglers
    get hedged while the co-replan routes the residual around the dead
    resources (capacity collapsed until repair via
    :meth:`Substrate.at`)."""
    return kind in ("arrival", "failure", "drift")


# ---------------------------------------------------------------------------
# multi-stage pipelines: stagewise vs end-to-end cross-stage planning
# ---------------------------------------------------------------------------

#: name -> fn(spec, barriers, *, stage_mode, n_restarts, steps, seed, device)
#:         -> [ExecutionPlan, ...] (one per stage)
_PIPELINE_PLANNERS: Dict[str, Callable] = {}


def register_pipeline_planner(name: str, fn: Optional[Callable] = None):
    """Register a pipeline planning strategy under ``name`` (decorator or
    direct call, mirroring :func:`register_planner`).  A pipeline planner
    takes ``(spec, barriers, *, stage_mode, n_restarts, steps, seed,
    device)`` — ``spec`` a :class:`repro_torch.core.pipeline.PipelineSpec`
    — and returns one :class:`ExecutionPlan` per stage.  Registered names
    are immediately usable in :func:`optimize_pipeline` and
    :meth:`repro_torch.api.GeoPipeline.plan`."""
    if fn is None:
        return lambda f: register_pipeline_planner(name, f)
    if name in _PIPELINE_PLANNERS:
        raise ValueError(f"pipeline planner {name!r} is already registered")
    _PIPELINE_PLANNERS[name] = fn
    return fn


def get_pipeline_planner(name: str) -> Callable:
    try:
        return _PIPELINE_PLANNERS[name]
    except KeyError:
        raise ValueError(
            f"pipeline mode must be one of {available_pipeline_modes()}, "
            f"got {name!r}"
        ) from None


def available_pipeline_modes() -> Tuple[str, ...]:
    """Names of every registered pipeline planner."""
    return tuple(_PIPELINE_PLANNERS)


@dataclasses.dataclass(frozen=True)
class PipelinePlanResult:
    """One plan per stage of a pipeline, priced end to end through
    :meth:`repro_torch.core.makespan.CostModel.price_pipeline`.  Each
    per-stage :class:`PlanResult` carries that stage's *own* modeled span
    over its derived ``D``; ``starts``/``finishes`` compose them along the
    DAG's critical path and ``makespan`` is the end-to-end total."""

    results: Tuple[PlanResult, ...]
    makespan: float
    starts: Tuple[float, ...]
    finishes: Tuple[float, ...]
    #: each stage's derived source vector (MB) under the chosen plans
    stage_D: Tuple[np.ndarray, ...]
    mode: str
    stage_mode: str
    barriers: Tuple[str, str, str]
    objective: float

    @property
    def plans(self) -> Tuple[ExecutionPlan, ...]:
        return tuple(r.plan for r in self.results)

    @property
    def stage_makespans(self) -> Tuple[float, ...]:
        return tuple(r.makespan for r in self.results)

    def __repr__(self):
        stages = " ".join(
            f"{s:.1f}@{t:.1f}s" for s, t in
            zip(self.stage_makespans, self.starts)
        )
        return (
            f"PipelinePlanResult(mode={self.mode}, "
            f"barriers={''.join(self.barriers)}, "
            f"stages=[{stages}], makespan={self.makespan:.1f}s)"
        )


def _pipeline_result(
    spec: PipelineSpec, plans, barriers, mode: str, stage_mode: str,
    objective: float,
) -> PipelinePlanResult:
    """Price a stage stack end to end (float64) and wrap it."""
    cm = CostModel(spec.stages[0].platform, barriers)
    priced = cm.price_pipeline(spec, plans, barriers)
    results = []
    for k, (plan, out) in enumerate(zip(plans, priced["stages"])):
        breakdown = attribute_phases(out)
        results.append(PlanResult(
            plan=plan,
            makespan=breakdown["makespan"],
            breakdown=breakdown,
            mode=f"{mode}:{stage_mode}",
            barriers=tuple(barriers),
            objective=breakdown["makespan"],
        ))
    return PipelinePlanResult(
        results=tuple(results),
        makespan=float(priced["makespan"]),
        starts=tuple(float(t) for t in priced["start"]),
        finishes=tuple(float(t) for t in priced["finish"]),
        stage_D=tuple(priced["D"]),
        mode=mode,
        stage_mode=stage_mode,
        barriers=tuple(barriers),
        objective=objective,
    )


def optimize_pipeline(
    spec: PipelineSpec,
    mode: str = "end_to_end",
    stage_mode: str = "e2e_multi",
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    n_restarts: int = 16,
    steps: int = 400,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
) -> PipelinePlanResult:
    """Plan every stage of a pipeline with the given pipeline ``mode`` (any
    name in :func:`available_pipeline_modes`); every solve runs on
    ``device`` (default: the process default, the card).  Built in:

    * ``stagewise``   — plan each stage myopically in topological order
      with the per-stage ``stage_mode`` planner, each stage's ``D``
      derived from the already-fixed upstream plans.  This is the
      baseline the paper's end-to-end argument extends across stages: it
      places stage-``k`` reducers where stage ``k`` finishes fastest,
      even when that strands stage ``k+1``'s input behind slow links.
    * ``end_to_end``  — one annealed optimization over *all* stages'
      stacked ``x``/``y`` against the composed pipeline makespan, with
      gradients flowing through the inter-stage ``D`` coupling
      (downstream ``D`` is a function of upstream ``y``).  The stagewise
      stack competes as a float64 candidate, so ``end_to_end`` is never
      modeled-worse than ``stagewise``.

    The result prices every candidate stack end to end through the one
    float64 cost model (:meth:`CostModel.price_pipeline`)."""
    dev = resolve_device(device)
    planner = get_pipeline_planner(mode)
    barriers = tuple(barriers)
    plans = planner(
        spec, barriers,
        stage_mode=stage_mode, n_restarts=n_restarts, steps=steps, seed=seed,
        device=dev,
    )
    res = _pipeline_result(spec, plans, barriers, mode, stage_mode, 0.0)
    return dataclasses.replace(res, objective=res.makespan)


def _stagewise_plans(
    spec: PipelineSpec, barriers, *, stage_mode, n_restarts, steps, seed,
    device,
) -> "list[ExecutionPlan]":
    """Topological-greedy stage planning (shared by ``stagewise`` itself
    and the warm starts / competing candidate of ``end_to_end``)."""
    planner = get_planner(stage_mode)
    sub = spec.substrate
    plans: List[Optional[ExecutionPlan]] = [None] * spec.n_stages
    # topo order guarantees every ancestor is planned before its stage's D
    # is read, so filler plans in not-yet-planned slots never influence it
    # — and the coupling formula stays in its one home, derived_D
    filler = uniform_plan(sub.view(np.zeros(sub.nS), 1.0))
    for pos, k in enumerate(spec.topo_order()):
        stage = spec.stages[k]
        if stage.deps:
            D = spec.derived_D(
                [p if p is not None else filler for p in plans]
            )[k]
            view = sub.view(D, stage.alpha, name=f"{sub.name}/stage{k}")
        else:
            view = stage.platform
        plan, _ = planner(view, barriers, n_restarts=n_restarts, steps=steps,
                          seed=seed + 17 * pos, fixed_x=None, device=device)
        plans[k] = plan
    return plans  # type: ignore[return-value]


@register_pipeline_planner("stagewise")
def _stagewise_pipeline(spec, barriers, *, stage_mode, n_restarts, steps,
                        seed, device):
    """Each stage planned as if it were the last: the per-stage-myopic
    baseline (upstream plans fixed before a downstream stage is even
    looked at)."""
    return _stagewise_plans(
        spec, barriers, stage_mode=stage_mode, n_restarts=n_restarts,
        steps=steps, seed=seed, device=device,
    )


@_counted_solver(static_argnames=("topo", "deps", "barriers", "steps"))
def _solve_pipeline_batch(
    D_roots,  # (K, nS) — root stages' D (zero rows for dependent stages)
    alphas,  # (K,)
    out_scales,  # (K,)
    caps,  # 4-tuple: B_sm, B_mr, C_m, C_r
    logits_x0,  # (R, K, nS, nM)
    logits_y0,  # (R, K, nR)
    scale,
    topo: Tuple[int, ...],
    deps: Tuple[Tuple[int, ...], ...],
    barriers: Tuple[str, str, str],
    steps: int,
    lr: float = 0.08,
    tau0_frac: float = 0.3,
    tau1_frac: float = 1e-3,
):
    """Anneal ``R`` restarts of the *composed pipeline* makespan over all
    stages' stacked plans.  Each downstream stage's ``D`` is rebuilt from
    its upstream stages' ``y`` inside the loss, so gradients flow through
    the inter-stage coupling — reducer placement of stage ``k`` feels
    stage ``k+1``'s push costs.  The stage loop unrolls over ``topo``:
    each anneal step costs about ``K`` single-job step graphs."""
    K = logits_y0.shape[1]

    def pipeline_span(x, y, mx, pmax):
        total: list = [None] * K
        finish: list = [None] * K
        for k in topo:
            if deps[k]:
                Dk = sum(
                    out_scales[u] * alphas[u] * total[u] * y[u]
                    for u in deps[k]
                )
            else:
                Dk = D_roots[k]
            total[k] = torch.sum(Dk)
            vols = analytic_volumes(Dk, x[k], y[k], alphas[k], xp=torch)
            out = volume_model(*vols, *caps, barriers, mx, pmax, xp=torch)
            if deps[k]:
                start = mx(torch.stack([finish[u] for u in deps[k]]))
            else:
                start = 0.0
            finish[k] = start + out["makespan"]
        return mx(torch.stack(finish))

    return _anneal_stack(pipeline_span, logits_x0, logits_y0, scale, steps,
                         lr, tau0_frac, tau1_frac)


@register_pipeline_planner("end_to_end")
def _end_to_end_pipeline(spec, barriers, *, stage_mode, n_restarts, steps,
                         seed, device):
    """The paper's end-to-end argument lifted across stages: one annealed
    optimization over every stage's stacked ``x``/``y`` against the
    composed pipeline makespan.  Warm starts include the stagewise stack
    (which also competes in the float64 selection, so the result is never
    modeled-worse than ``stagewise``), a uniform stack, and a
    placement-aware stack that biases every non-sink stage's reducers
    toward nodes with fast *outgoing* push links — the sites the next
    stage can actually leave from."""
    K, sub = spec.n_stages, spec.substrate
    nS, nM, nR = sub.nS, sub.nM, sub.nR
    stagewise = _stagewise_plans(
        spec, barriers, stage_mode=stage_mode, n_restarts=n_restarts,
        steps=steps, seed=seed, device=device,
    )
    # the restarts' logits in the reference's order and draws, float64,
    # cast once: the stagewise stack, a uniform stack, the greedy x with
    # the exit-placed y, then random stacks from the numpy stream
    eps = 1e-9
    rng = np.random.default_rng(seed)
    sw_x = np.stack([np.log(np.asarray(p.x) + eps) for p in stagewise])
    sw_y = np.stack([np.log(np.asarray(p.y) + eps) for p in stagewise])

    greedy_x = np.broadcast_to(
        np.log(sub.B_sm / sub.B_sm.max() + eps), (K, nS, nM)
    ).copy()
    # reducers that downstream stages can leave from: bias stage k's y by
    # the mean outgoing push bandwidth of the node hosting each reducer
    # (reducer r == source r on a pipeline-capable substrate)
    has_children = [False] * K
    for stage in spec.stages:
        for u in stage.deps:
            has_children[u] = True
    exit_bias = (
        np.log(np.mean(sub.B_sm, axis=1) / sub.B_sm.max() + eps)
        if nS == nR else np.zeros(nR)
    )
    sink_bias = np.log(sub.C_r / sub.C_r.max() + eps)
    placed_y = np.stack([
        exit_bias if has_children[k] else sink_bias for k in range(K)
    ])
    lx = [sw_x, np.zeros((K, nS, nM)), greedy_x]
    ly = [sw_y, np.zeros((K, nR)), placed_y]
    while len(lx) < n_restarts:
        sigma = rng.uniform(0.3, 3.0)
        lx.append(rng.normal(0.0, sigma, size=(K, nS, nM)))
        ly.append(rng.normal(0.0, sigma, size=(K, nR)))

    D_roots = np.zeros((K, nS))
    for k, stage in enumerate(spec.stages):
        if not stage.deps:
            D_roots[k] = stage.platform.D
    cm = CostModel(spec.stages[0].platform, barriers)
    scale = max(
        float(cm.price_pipeline(spec, stagewise)["makespan"]), 1e-6
    )
    xs, ys, _ = _solve_pipeline_batch(
        _f32(D_roots, device),
        _f32([s.alpha for s in spec.stages], device),
        _f32([s.out_scale for s in spec.stages], device),
        tuple(_f32(a, device)
              for a in (sub.B_sm, sub.B_mr, sub.C_m, sub.C_r)),
        _f32(np.stack(lx[:n_restarts]), device),
        _f32(np.stack(ly[:n_restarts]), device),
        _f32(scale, device),
        topo=spec.topo_order(),
        deps=tuple(s.deps for s in spec.stages),
        barriers=tuple(barriers),
        steps=steps,
    )
    xs, ys = xs.cpu().numpy(), ys.cpu().numpy()

    # exact float64 end-to-end pricing picks the winner; the stagewise
    # stack competes as candidate -1
    candidates = [
        _normalized_plans(xs[r], ys[r], "end_to_end")
        for r in range(xs.shape[0])
    ]
    candidates.append([
        dataclasses.replace(p, meta="end_to_end") for p in stagewise
    ])
    scores = [
        float(cm.price_pipeline(spec, plans)["makespan"])
        for plans in candidates
    ]
    return candidates[int(np.argmin(scores))]


# ---------------------------------------------------------------------------
# brute force (validation on tiny instances)
# ---------------------------------------------------------------------------

def brute_force_plan(
    platform: Platform,
    barriers: Tuple[str, str, str] = BARRIERS_ALL_GLOBAL,
    grid: int = 20,
    device: Optional[DeviceLike] = None,
) -> PlanResult:
    """Exhaustive grid search over plans; only feasible for tiny platforms
    (it enumerates a simplex grid per source row and for ``y``).  The
    candidates are priced in float32 on ``device``, a chunk of ``x`` rows
    at a time against every ``y``; the first minimum in enumeration order
    wins, as in the reference's sequential scan."""
    dev = resolve_device(device)
    nS, nM, nR = platform.nS, platform.nM, platform.nR
    if nM > 3 or nR > 3 or nS > 3:
        raise ValueError("brute force only supported for <=3 nodes per tier")

    def simplex_grid(dim):
        pts = []
        for comb in itertools.product(range(grid + 1), repeat=dim - 1):
            if sum(comb) <= grid:
                last = grid - sum(comb)
                pts.append(tuple(c / grid for c in comb) + (last / grid,))
        return np.array(pts)

    rows = simplex_grid(nM)  # candidate rows for each source
    ys = simplex_grid(nR)

    arrs = platform.as_arrays()
    t = [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
         for a in arrs[:5]]
    ys_t = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    mx, pmax = hard_ops()

    def f(x, y):
        return phase_model(*t, arrs[5], x, y, tuple(barriers), mx,
                           pmax)["makespan"]

    eval_grid = vmap(vmap(f, in_dims=(None, 0)), in_dims=(0, None))
    choices = list(itertools.product(range(len(rows)), repeat=nS))
    best = (np.inf, None, None)
    chunk = 4096
    for lo in range(0, len(choices), chunk):
        xs = np.stack([np.stack([rows[r] for r in c])
                       for c in choices[lo:lo + chunk]])
        vals = eval_grid(torch.as_tensor(xs, dtype=torch.float32, device=dev),
                         ys_t).cpu().numpy()
        i, k = np.unravel_index(int(vals.argmin()), vals.shape)
        if vals[i, k] < best[0]:
            best = (float(vals[i, k]), xs[i], ys[k])

    plan = ExecutionPlan(x=best[1], y=best[2], meta="brute_force")
    return PlanResult(
        plan=plan,
        makespan=best[0],
        breakdown=phase_breakdown(platform, plan, barriers),
        mode="brute_force",
        barriers=tuple(barriers),
        objective=best[0],
    )
