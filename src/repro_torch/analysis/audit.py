"""Runtime sanitizer for the discrete-event executor.

Three audits over small, solver-free scenarios that cover the executor's
surface (barrier triples, shared multi-job substrates with capacity drift
and staggered releases, stage-linked pipelines, and the flow-level fluid
executor crossing rate-change events):

* **conservation** — run with ``SimConfig(audit=True)``: the engine checks
  gate-counter sanity after every event and byte conservation (pushed ==
  landed == mapped, shuffle created == landed == reduced) at completion.
* **snapshot sanity** — :class:`~repro.core.simulate.ProgressSnapshot`
  residuals must be non-negative always, and monotone non-increasing for
  runs where no mechanism re-adds work (no failure recovery, no
  stage-linked sources still being fed).
* **determinism** — re-run a scenario K times with *permuted*
  same-timestamp event tie-breaks and compare a per-timestamp canonical
  state digest.  The engine's ``(time, seq)`` discipline makes runs
  reproducible; this audit proves the stronger property that same-time
  event order does not leak into the trajectory.  Any divergence is an
  event-order race, reported with the offending timestamp and the two
  event batches.

The state digest is deliberately *canonical*: resource queues enter as
multisets of ``(job, size, kind)`` (no chunk ids, no insertion order), so
benign reorderings of identical work hash identically while any
order-dependent state change is caught.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.plan import ExecutionPlan
from ..core.platform import CapacityTrace, FailureEvent, Platform, \
    Substrate, planetlab_platform
from ..core.simulate import SimConfig, _MultiSim, open_schedule

__all__ = [
    "AuditReport",
    "Divergence",
    "QUICK_SCENARIOS",
    "conservation_audit",
    "determinism_audit",
    "locality_plan",
    "raced_engine",
    "run_all",
    "snapshot_audit",
    "swap_conservation_audit",
    "trajectory",
    "uniform_plan",
]


# ---------------------------------------------------------------------------
# heuristic plans (closed-form: the audits must not depend on the solver)
# ---------------------------------------------------------------------------


def uniform_plan(p: Platform) -> ExecutionPlan:
    """Spread everything evenly — exercises every link."""
    return ExecutionPlan(
        x=np.full((p.nS, p.nM), 1.0 / p.nM),
        y=np.full(p.nR, 1.0 / p.nR),
    )


def locality_plan(p: Platform) -> ExecutionPlan:
    """Each source pushes over its best link; reducers weighted by rate —
    one-hot rows and unequal chunk sizes, the shape a solver plan has."""
    x = np.zeros((p.nS, p.nM))
    x[np.arange(p.nS), np.argmax(np.asarray(p.B_sm), axis=1)] = 1.0
    y = np.asarray(p.C_r, dtype=np.float64)
    return ExecutionPlan(x=x, y=y / y.sum())


# ---------------------------------------------------------------------------
# quick scenarios (shared by the CLI, the regression tests and CI)
# ---------------------------------------------------------------------------


def _planetlab_engine(barriers: Tuple[str, str, str]) -> _MultiSim:
    p = planetlab_platform(4, alpha=1.7, seed=2)
    cfg = SimConfig(barriers=barriers, audit=True)
    return open_schedule([(p, uniform_plan(p), cfg)])


def _shared_online_substrate() -> Substrate:
    """Two 2-node clusters joined by thin WAN links, with a reducer
    brown-out and two push links degrading over time — the
    ``schedule_online_shared`` benchmark geometry."""
    return Substrate(
        B_sm=np.array([[200.0, 200, 1, 1], [200, 200, 1, 1],
                       [1, 1, 200, 200], [1, 1, 200, 200]]),
        B_mr=np.array([[200.0, 200], [200, 200], [1, 200], [1, 200]]),
        C_m=np.array([100.0, 100, 100, 100]),
        C_r=np.array([300.0, 60]),
        cluster_s=np.array([0, 0, 1, 1]),
        cluster_m=np.array([0, 0, 1, 1]),
        cluster_r=np.array([0, 1]),
        name="audit-shared",
        traces={
            "reduce[r0]": CapacityTrace.step(300.0, 40.0, 110.0),
            "push[s0->m2]": CapacityTrace.step(1.0, 0.9, 150.0),
            "push[s1->m2]": CapacityTrace.step(1.0, 0.9, 180.0),
        },
    )


def _shared_online_engine() -> _MultiSim:
    sub = _shared_online_substrate()
    steady = sub.view(np.array([8000.0, 8000, 0, 0]), 1.0, name="steady")
    late = sub.view(np.array([0.0, 0, 6000, 6000]), 1.0, name="late")
    return open_schedule(
        [
            (steady, locality_plan(steady), SimConfig(audit=True)),
            (late, locality_plan(late),
             SimConfig(audit=True, start_time=50.0)),
        ],
        substrate=sub,
    )


def _pipeline_engine() -> _MultiSim:
    """A 3-stage chain (ingest -> transform -> aggregate) with real
    per-source release gating — the ``pipeline_chain`` geometry."""
    sub = Substrate(
        B_sm=np.array([[4.0, 4], [200, 200]]),
        B_mr=np.array([[200.0, 200], [200, 200]]),
        C_m=np.array([100.0, 100]),
        C_r=np.array([300.0, 60]),
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name="audit-pipeline",
    )
    ingest = sub.view(np.array([0.0, 6000]), 1.0, name="ingest")
    transform = sub.view(np.zeros(2), 1.0, name="transform")
    aggregate = sub.view(np.zeros(2), 0.5, name="aggregate")
    jobs = [
        (ingest, locality_plan(ingest), SimConfig(audit=True)),
        (transform, uniform_plan(transform), SimConfig(audit=True)),
        (aggregate, uniform_plan(aggregate), SimConfig(audit=True)),
    ]
    return open_schedule(jobs, substrate=sub,
                         stage_links={1: [(0, 1.0)], 2: [(1, 1.0)]})


def _failover_engine() -> _MultiSim:
    """Every failure mechanism at once under replication: a per-job mapper
    kill (replica promotion), a substrate-wide reducer kill (claw-back +
    re-emission) and a cluster partition with repair (doomed transfers,
    park/resume) — the ``schedule_failover`` benchmark's fault surface.
    Failure times are deliberately non-round so they never tie with chunk
    completions under the permuted tie-break audit."""
    sub = _shared_online_substrate().with_failures([
        FailureEvent.reducer_kill(1, 97.0),
        FailureEvent.cluster_partition(0, 141.3, 191.3),
    ])
    steady = sub.view(np.array([8000.0, 8000, 0, 0]), 1.0, name="steady")
    late = sub.view(np.array([0.0, 0, 6000, 6000]), 1.0, name="late")
    return open_schedule(
        [
            (steady, locality_plan(steady),
             SimConfig(audit=True, replication=2,
                       failures=(FailureEvent.mapper_kill(0, 41.3),))),
            (late, locality_plan(late),
             SimConfig(audit=True, replication=2, start_time=50.0)),
        ],
        substrate=sub,
    )


def _traced_fluid_engine():
    """The shared-online geometry in fluid mode: the same reducer
    brown-out and push-link decays now hit the flow executor as
    rate-change events on its event horizon, so the fluid byte ledger
    and the split-invariance digests both cross capacity drift."""
    sub = _shared_online_substrate()
    steady = sub.view(np.array([8000.0, 8000, 0, 0]), 1.0, name="steady")
    late = sub.view(np.array([0.0, 0, 6000, 6000]), 1.0, name="late")
    return open_schedule(
        [
            (steady, locality_plan(steady),
             SimConfig(mode="fluid", audit=True)),
            (late, locality_plan(late),
             SimConfig(mode="fluid", audit=True, start_time=50.0)),
        ],
        substrate=sub,
    )


QUICK_SCENARIOS: Tuple[Tuple[str, Callable[[], _MultiSim]], ...] = (
    ("planetlab_GGL", lambda: _planetlab_engine(("G", "G", "L"))),
    ("planetlab_PPP", lambda: _planetlab_engine(("P", "P", "P"))),
    ("planetlab_LGP", lambda: _planetlab_engine(("L", "G", "P"))),
    ("shared_online", _shared_online_engine),
    ("pipeline_chain", _pipeline_engine),
    ("failover", _failover_engine),
    ("traced_fluid", _traced_fluid_engine),
)


def raced_engine() -> _MultiSim:
    """A deliberately raced fixture: two different-size chunks arrive at
    the *same mapper at the same instant* over two links (40 MB @ 10 MB/s
    and 80 MB @ 20 MB/s both land at t=4), so the mapper's service order —
    and the whole downstream trajectory — depends on the same-timestamp
    tie-break.  The determinism audit must flag it."""
    sub = Substrate(
        B_sm=np.array([[10.0], [20.0]]),
        B_mr=np.array([[50.0]]),
        C_m=np.array([100.0]),
        C_r=np.array([100.0]),
        cluster_s=np.zeros(2, dtype=int),
        cluster_m=np.zeros(1, dtype=int),
        cluster_r=np.zeros(1, dtype=int),
        name="raced",
    )
    p = sub.view(np.array([40.0, 80.0]), 1.0, name="raced-job")
    plan = ExecutionPlan(x=np.ones((2, 1)), y=np.ones(1))
    cfg = SimConfig(chunk_mb=128.0, barriers=("P", "P", "P"), audit=True)
    return open_schedule([(p, plan, cfg)], substrate=sub)


# ---------------------------------------------------------------------------
# determinism: permuted tie-breaks + canonical trajectory digest
# ---------------------------------------------------------------------------


def patch_tiebreak(eng: _MultiSim, rng: np.random.Generator) -> _MultiSim:
    """Replace the engine's seq tie-break with a random key: events at the
    same timestamp now pop in a permuted (but still total) order.  The
    dispatcher only reads slots 0/2/3, so the key shape is free."""

    def at(t: float, fn: str, *args):
        heapq.heappush(
            eng._heap, (t, (rng.random(), next(eng._seq)), fn, args)
        )

    eng.at = at
    return eng


def _digest(eng: _MultiSim) -> str:
    """Canonical state digest at the current instant.  Queue contents enter
    as sorted multisets of ``(job, size, kind)`` — chunk ids, sources and
    insertion order are deliberately excluded so benign same-timestamp
    reorderings of identical work hash identically."""
    parts: List[object] = [repr(eng.now)]
    for g in eng.runs:
        parts.append((
            g.idx, g.seeded,
            repr((g.pushed_mb, g.landed_mb, g.mapped_mb, g.shuf_created_mb,
                  g.shuf_landed_mb, g.reduced_mb)),
            repr((g.push_end, g.map_end, g.shuffle_end, g.reduce_end,
                  g.wasted_mb)),
            repr((g.lost_mb, g.reexec_mb)),
            g.recovered, g.total_map_chunks,
            tuple(g.push_inflight.tolist()),
            tuple(g.map_unfinished.tolist()),
            tuple(g.shuf_inflight.tolist()),
            tuple(g.reduce_outstanding.tolist()),
            tuple(g.map_alive.tolist()),
            tuple(g.red_alive.tolist()),
            tuple(g.reducer_final.tolist()),
            # provenance enters as per-reducer sorted multisets: *which*
            # equal-size chunk a reducer served first is a benign
            # same-timestamp reordering (sources are excluded from the
            # canon), and even column *sums* pick up ULP noise from
            # accumulation order — the multiset is exact
            tuple(tuple(sorted(repr(v) for v in col))
                  for col in np.asarray(g.reduced_by).T.tolist()),
            repr(tuple(g.dep_landed.tolist())),
            repr(tuple(g.delivered_out.tolist())),
            tuple(sorted((i, tuple(sorted(s)))
                         for i, s in g.dep_pending.items())),
            tuple(tuple(sorted(repr(c.size) for c in gated))
                  for gated in g.map_gated),
            tuple(tuple(sorted((k, repr(sc.size)) for k, sc in gated))
                  for gated in g.shuf_gated),
            tuple(tuple(sorted(repr(sc.size) for sc in gated))
                  for gated in g.red_gated),
        ))

    def link_state(link):
        cur = link.current
        return (
            link.name, link.busy, link.down,
            None if cur is None else (cur.run.idx, repr(cur.size), cur.fn),
            tuple(sorted((tr.run.idx, repr(tr.size), tr.fn)
                         for tr in link.queue)),
            repr((link.stats.busy_s, link.stats.waited_s,
                  link.stats.volume_mb, link.stats.n_chunks)),
        )

    def node_state(node):
        return (
            node.name, node.busy,
            None if node.current is None else (
                node.current.idx,
                repr(node.current_chunk.size)
                if node.current_chunk is not None else None,
            ),
            tuple(sorted((h.idx, repr(c.size)) for h, c, _ in node.queue)),
            repr((node.stats.busy_s, node.stats.waited_s,
                  node.stats.volume_mb, node.stats.n_chunks)),
        )

    for row in eng.push_links + eng.shuf_links:
        parts.extend(link_state(link) for link in row)
    parts.extend(node_state(n) for n in eng.mappers + eng.reducers)
    return hashlib.sha256(repr(parts).encode()).hexdigest()


#: one drained timestamp: (time, state digest, sorted event-name batch)
Step = Tuple[float, str, Tuple[str, ...]]


def trajectory(eng: _MultiSim) -> List[Step]:
    """Drain the engine, emitting one canonical state digest per distinct
    event timestamp (all same-time events are processed before hashing)."""
    eng._start()
    steps: List[Step] = []
    while eng._heap:
        t = eng._heap[0][0]
        batch: List[str] = []
        while eng._heap and eng._heap[0][0] == t:
            batch.append(eng._heap[0][2])
            eng._dispatch()
        steps.append((t, _digest(eng), tuple(sorted(batch))))
    if eng._audit:
        eng._audit_final()
    return steps


@dataclasses.dataclass(frozen=True)
class Divergence:
    """One detected event-order race."""

    scenario: str
    permutation: int
    time: float
    detail: str

    def __str__(self) -> str:
        return (f"{self.scenario}: permutation {self.permutation} diverges "
                f"at t={self.time:.6f}: {self.detail}")


def _compare(scenario: str, perm: int, base: List[Step],
             other: List[Step]) -> Optional[Divergence]:
    for i, ((ta, ha, ea), (tb, hb, eb)) in enumerate(zip(base, other)):
        if ta != tb or ha != hb:
            return Divergence(
                scenario, perm, min(ta, tb),
                f"step {i}: t={ta:.6f} events={list(ea)} vs "
                f"t={tb:.6f} events={list(eb)}",
            )
    if len(base) != len(other):
        i = min(len(base), len(other))
        longer = base if len(base) > len(other) else other
        return Divergence(
            scenario, perm, longer[i][0],
            f"trajectory lengths differ: {len(base)} vs {len(other)} steps",
        )
    return None


def _canon9(v):
    """Canonicalize floats to 9 significant digits: fluid state evolves by
    ``rem -= rate * dt``, so splitting an interval at a steering boundary
    legitimately perturbs the last ULP — a real steering leak is
    macroscopic, so 9 digits keeps the digest byte-stable without hiding
    one."""
    if isinstance(v, float):
        return f"{v:.9g}"
    if isinstance(v, dict):
        return tuple(sorted((k, _canon9(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon9(x) for x in v)
    return v


def _fluid_digest(snap) -> str:
    """Canonical fluid-state digest: every residual bucket of every job,
    plus the per-resource backlog."""
    parts: List[object] = [_canon9(float(snap.time))]
    for pr in snap.jobs:
        parts.append((
            pr.job, pr.released, pr.done,
            _canon9(pr.resid_push.tolist()),
            _canon9(pr.committed_push.tolist()),
            _canon9(pr.at_mapper.tolist()),
            _canon9(pr.shuffle_pool.tolist()),
            _canon9(pr.committed_shuffle.tolist()),
            _canon9(pr.at_reducer.tolist()),
        ))
    parts.append(_canon9(dict(snap.backlog)))
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def _fluid_trajectory(build, cuts: Tuple[float, ...] = ()):
    """Drain a fluid engine, digesting its state on a fixed observation
    grid that brackets every capacity-drift step.  Extra steering ``cuts``
    are run_until boundaries only — they must not change any digest."""
    eng = build()
    drift = tuple(getattr(eng.sub, "drift_times", tuple)())
    grid = sorted({30.0} | set(drift) | {t + 7.5 for t in drift})
    steps: List[Step] = []
    for t in sorted(set(grid) | set(cuts)):
        eng.run_until(t)
        if t in grid:
            steps.append((t, _fluid_digest(eng.snapshot()), ("observe",)))
    res = eng.run()
    final = hashlib.sha256(
        repr(_canon9(res.as_dict())).encode()).hexdigest()
    steps.append((round(res.makespan, 6), final, ("final",)))
    return steps, res.makespan


def _fluid_split_audit(
    name: str, build, k: int, seed: int
) -> List[Divergence]:
    """Determinism for the flow executor: there are no same-timestamp
    tie-breaks to permute, so the audited property is *split invariance* —
    ``k`` runs steered through random ``run_until`` boundaries (which
    straddle the drift steps) must reproduce the unsteered digests and
    final result exactly."""
    base, makespan = _fluid_trajectory(build)
    out: List[Divergence] = []
    rng = np.random.default_rng(seed)
    for i in range(1, k + 1):
        cuts = tuple(float(c) for c in rng.uniform(0.0, makespan, size=3))
        div = _compare(name, i, base, _fluid_trajectory(build, cuts)[0])
        if div is not None:
            out.append(div)
    return out


def determinism_audit(
    name: str, build: Callable[[], _MultiSim], k: int = 5, seed: int = 0
) -> List[Divergence]:
    """Run ``build()`` once in natural order and ``k`` times with permuted
    same-timestamp tie-breaks; report every trajectory divergence.  Fluid
    engines have no event heap to permute — they get the split-invariance
    audit of :func:`_fluid_split_audit` instead."""
    if not hasattr(build(), "_dispatch"):  # a FluidSim
        return _fluid_split_audit(name, build, k=k, seed=seed)
    base = trajectory(build())
    out: List[Divergence] = []
    for i in range(1, k + 1):
        eng = patch_tiebreak(build(), np.random.default_rng(seed + i))
        div = _compare(name, i, base, trajectory(eng))
        if div is not None:
            out.append(div)
    return out


# ---------------------------------------------------------------------------
# conservation + snapshot audits
# ---------------------------------------------------------------------------


def conservation_audit(build: Callable[[], _MultiSim]) -> List[str]:
    """Drain a fresh engine and return its runtime-audit violations
    (the builder's ``SimConfig(audit=True)`` does the checking)."""
    return build().run().violations


def swap_conservation_audit() -> List[str]:
    """Conservation through the steered path: run the shared-online
    scenario to t=120 (past the reducer brown-out), swap job 0 onto a
    re-balanced plan — exercising the pull-back/re-split ledger — and
    drain."""
    eng = _shared_online_engine()
    eng.run_until(120.0)
    steady = eng.runs[0].p
    nM, nR = steady.nM, steady.nR
    x = np.zeros((steady.nS, nM))
    x[0], x[1] = (0.5, 0.5, 0.0, 0.0), (0.5, 0.5, 0.0, 0.0)
    x[2], x[3] = (0.0, 0.0, 0.5, 0.5), (0.0, 0.0, 0.5, 0.5)
    eng.swap_plan(0, ExecutionPlan(x=x, y=np.full(nR, 1.0 / nR)))
    return eng.run().violations


def snapshot_audit(
    build: Callable[[], _MultiSim], dt: float = 10.0, horizon: float = 1e5
) -> List[str]:
    """Sample :meth:`_MultiSim.snapshot` on a fixed grid: residual buckets
    must be non-negative always, and monotone non-increasing for jobs where
    nothing re-adds work (not stage-linked, no failure injection)."""
    eng = build()
    problems: List[str] = []
    last: Dict[int, Dict[str, float]] = {}
    t = 0.0
    eng.run_until(0.0)
    while not eng.finished and t < horizon:
        snap = eng.snapshot()
        for prog in snap.jobs:
            rem = prog.remaining_mb()
            g = eng.runs[prog.job]
            for phase, mb in rem.items():
                if mb < -1e-6:
                    problems.append(
                        f"t={snap.time:.1f}: job {prog.job}: negative "
                        f"{phase} residual {mb:.6f}"
                    )
            monotone = (not getattr(g, "stage_deps", None)
                        and not g.cfg.failures
                        and not getattr(eng.sub, "failures", None))
            if monotone and prog.job in last:
                for phase, mb in rem.items():
                    if mb > last[prog.job][phase] + 1e-6:
                        problems.append(
                            f"t={snap.time:.1f}: job {prog.job}: {phase} "
                            f"residual grew {last[prog.job][phase]:.3f} -> "
                            f"{mb:.3f}"
                        )
            last[prog.job] = rem
        t += dt
        eng.run_until(t)
    return problems


# ---------------------------------------------------------------------------
# the full audit suite
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditReport:
    """Everything the ``python -m repro.analysis`` audit stage produces."""

    violations: Dict[str, List[str]]
    divergences: List[Divergence]
    race_detected: bool  # the deliberately-raced fixture must diverge

    @property
    def ok(self) -> bool:
        return (not any(self.violations.values())
                and not self.divergences and self.race_detected)

    def lines(self) -> List[str]:
        out = []
        for name, probs in self.violations.items():
            out.extend(f"{name}: {p}" for p in probs)
        out.extend(str(d) for d in self.divergences)
        if not self.race_detected:
            out.append(
                "raced fixture: determinism audit failed to detect the "
                "planted same-timestamp race"
            )
        return out


def run_all(k: int = 5, seed: int = 0) -> AuditReport:
    """Conservation + snapshot + determinism over every quick scenario,
    the steered swap path, and the planted-race self-check."""
    violations: Dict[str, List[str]] = {}
    divergences: List[Divergence] = []
    for name, build in QUICK_SCENARIOS:
        probs = conservation_audit(build)
        probs.extend(snapshot_audit(build))
        violations[name] = probs
        divergences.extend(determinism_audit(name, build, k=k, seed=seed))
    violations["shared_online_swap"] = swap_conservation_audit()
    race = determinism_audit("raced_fixture", raced_engine, k=k, seed=seed)
    return AuditReport(
        violations=violations,
        divergences=divergences,
        race_detected=bool(race),
    )
