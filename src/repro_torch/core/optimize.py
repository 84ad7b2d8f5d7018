"""Model-driven execution-plan optimization (paper §2.3 and §4), on torch.

This is the single-job part of :mod:`repro.core.optimize`, ported from
jit-compiled jnp to batched torch.  The paper's *model* is kept exactly
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
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import itertools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from .._device import DeviceLike, resolve_device
from .makespan import (
    BARRIERS_ALL_GLOBAL,
    hard_ops,
    makespan,
    phase_breakdown,
    phase_model,
    smooth_ops,
)
from .plan import ExecutionPlan, local_push_plan, uniform_plan
from .platform import Platform

__all__ = [
    "MODES",
    "PlanResult",
    "SolverService",
    "available_modes",
    "brute_force_plan",
    "get_planner",
    "optimize_plan",
    "optimize_plan_batch",
    "register_planner",
    "reset_solver_cache_stats",
    "solver_cache_occupancy",
    "solver_cache_stats",
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

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=torch.float32, device=device)

    raw = [p.as_arrays() for p in platforms]
    arrs = tuple(
        f32(np.stack([np.asarray(r[i], dtype=np.float64) for r in raw]))
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
        f32(xf),
        f32(yf),
        f32(scales),
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
    (same-shape requests share one batched solve)."""

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

    @staticmethod
    def stats() -> Dict[str, int]:
        """The process-wide solver counters (:func:`solver_cache_stats`)."""
        return solver_cache_stats()

    @staticmethod
    def reset_stats() -> None:
        reset_solver_cache_stats()


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
