"""Resource-centric discrete-event execution of plans on a shared substrate.

The paper validates its analytic model against a modified Hadoop running on
an emulated (``tc``-shaped) testbed.  This container offers a single CPU, so
we do the analogous thing in software: a **chunk-granular discrete-event
executor** that runs execution plans over the platform model, serializing
chunks on links and compute nodes, honoring the barrier configuration, and —
unlike the analytic model — supporting the *dynamic* mechanisms the paper
compares against (§4.6.4) and the failure modes a production deployment must
survive:

* **speculative execution** — when a node goes idle, unstarted work queued at
  a node whose expected remaining time exceeds ``spec_threshold ×`` the fleet
  mean is *cloned* to the idle node (first copy to finish wins; an
  already-started clone is wasted work, as in Hadoop);
* **work stealing** — idle nodes *take* (rather than clone) unstarted chunks
  from the most backlogged peer, re-fetching inputs from the source;
* **stragglers** — per-node slowdown factors unknown to the planner;
* **failures** — typed :class:`repro.core.platform.FailureEvent`\\ s
  (``mapper_kill`` / ``reducer_kill`` per job or fabric-wide, plus
  substrate-level ``cluster_partition`` with repair): in-flight chunks on
  dead paths are dropped, undelivered map/reduce output is un-delivered,
  and lost work is re-executed from surviving replicas (or re-fetched from
  the source) on the best surviving node;
* **replication** — push chunks are written ``replication×``, optionally
  across clusters (paper §4.6.5), consuming link capacity and speeding up
  recovery.

Events flow through **shared resources**, not through one hard-coded plan:
every push/shuffle link is a :class:`LinkResource` and every mapper/reducer
a :class:`ComputeResource`, each serving booked chunks FIFO.  ``N`` plans
run *concurrently* on one :class:`repro.core.platform.Substrate`
(:func:`simulate_schedule`) with real contention — chunks of different jobs
interleave on the same links and nodes in booking order, which
approximates fair sharing because concurrent jobs seed and emit their
chunks round-robin.  The single-plan :func:`simulate` is the ``N=1``
special case with unchanged semantics.

Links serve their queue one transfer at a time (a *pump*, like the compute
nodes) rather than pre-booking completion times, so the engine is
**observable and steerable** — the substance of the online control plane:

* every transfer sitting in a queue is uncommitted and can be re-routed,
  which is what :meth:`_MultiSim.swap_plan` does when an online policy
  replaces a job's plan mid-flight;
* a link's service rate is read *at service start* from its
  :class:`repro.core.platform.CapacityTrace`, so WAN capacities may drift
  while chunks are queued (an in-service transfer keeps the rate it
  started with);
* :meth:`_MultiSim.snapshot` captures a :class:`ProgressSnapshot` at any
  event time — per-job residual volumes bucketed by what a re-planner can
  still control (:class:`repro.core.makespan.JobProgress`), plus
  per-resource backlog;
* :meth:`_MultiSim.inject` admits new jobs after t=0, so arrivals stream
  in rather than being known upfront;
* :meth:`_MultiSim.run_until` pauses the event loop at a decision instant
  (:func:`open_schedule` hands out a paused engine;
  :func:`simulate_schedule` is the run-to-completion wrapper).

The executor is used by the Fig-4 validation benchmark (model-vs-execution
correlation), the Fig-10/11 dynamics study, the multi-job contention and
online re-planning benchmarks, and the fault-tolerance tests.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .makespan import BARRIERS_GGL, JobProgress, _check_barriers
from .plan import ExecutionPlan
from .platform import FailureEvent, Platform, Substrate

__all__ = [
    "ComputeResource",
    "FailureEvent",
    "LinkResource",
    "ProgressSnapshot",
    "ResourceStats",
    "ScheduleSimResult",
    "SimConfig",
    "SimResult",
    "open_schedule",
    "simulate",
    "simulate_schedule",
]


#: executor modes: chunk-granular discrete events ("event"), the
#: array-native drain of the same events ("event_vec") or continuous
#: flow-level simulation ("fluid", see :mod:`repro.core.fluid`).
SIM_MODES = ("event", "event_vec", "fluid")

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    chunk_mb: float = 64.0
    barriers: Tuple[str, str, str] = BARRIERS_GGL
    speculation: bool = False
    stealing: bool = False
    spec_threshold: float = 1.5
    replication: int = 1
    cross_cluster_replication: bool = False
    #: per-node compute slowdown factors applied at runtime (unknown to the
    #: planner): {("m"| "r", node_index): factor >= 1}
    stragglers: Optional[Dict[Tuple[str, int], float]] = None
    #: DEPRECATED spelling of ``failures=[FailureEvent.mapper_kill(j, t)]``
    #: — converted (with a DeprecationWarning) at construction; the engine
    #: only ever reads :attr:`failures`.
    fail_mapper: Optional[Tuple[int, float]] = None
    #: this job's fault script: typed :class:`FailureEvent`\\ s
    #: (``mapper_kill`` / ``reducer_kill`` — the *job's* worker on that
    #: node dies).  Fabric-wide faults, including ``cluster_partition``,
    #: attach to the substrate instead (:meth:`Substrate.with_failures`).
    failures: Tuple[FailureEvent, ...] = ()
    #: lognormal sigma on per-chunk service times (0 = deterministic).
    compute_noise: float = 0.0
    seed: int = 0
    #: release time: the job's sources start pushing at this absolute time.
    start_time: float = 0.0
    #: runtime sanitizer: check gate-counter sanity after every event and
    #: byte conservation at completion; violations land on
    #: :attr:`ScheduleSimResult.violations` (see :mod:`repro.analysis.audit`).
    audit: bool = False
    #: executor mode — every job of one schedule must agree on it:
    #:
    #: * ``"event"``     — chunk-granular DES (the default);
    #: * ``"event_vec"`` — the same events drained with batched
    #:   per-resource service scans (bit-identical results on scenarios
    #:   the determinism auditor certifies race-free).  Dynamics
    #:   (speculation, stealing, failures, noise, replication) are
    #:   rejected; steered engines (``run_until`` / ``snapshot`` /
    #:   ``swap_plan`` / ``inject``) drain each segment between decision
    #:   points through the same scans, falling back to the scalar event
    #:   loop only when a job's dynamics leave the vectorized vocabulary;
    #: * ``"fluid"``     — continuous flows at shared service rates (the
    #:   scale-tier fast path, see :mod:`repro.core.fluid`).
    mode: str = "event"
    #: DEPRECATED spelling of ``mode="event_vec"`` — converted (with a
    #: DeprecationWarning) at construction; the engine only ever reads
    #: :attr:`mode`.
    vectorized: bool = False

    def __post_init__(self):
        object.__setattr__(self, "barriers", _check_barriers(self.barriers))
        if self.start_time < 0:
            raise ValueError(
                f"start_time must be >= 0, got {self.start_time}"
            )
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}"
            )
        if self.vectorized:
            warnings.warn(
                "SimConfig(vectorized=True) is deprecated — spell it "
                'SimConfig(mode="event_vec")',
                DeprecationWarning, stacklevel=3,
            )
            if self.mode == "fluid":
                raise ValueError(
                    'vectorized=True conflicts with mode="fluid" — pick one '
                    f"executor mode from {SIM_MODES}"
                )
            object.__setattr__(self, "mode", "event_vec")
            object.__setattr__(self, "vectorized", False)
        if self.mode not in SIM_MODES:
            raise ValueError(
                f"mode must be one of {SIM_MODES}, got {self.mode!r}"
            )
        failures = tuple(self.failures)
        if self.fail_mapper is not None:
            warnings.warn(
                "SimConfig(fail_mapper=(j, t)) is deprecated — spell it "
                "SimConfig(failures=[FailureEvent.mapper_kill(j, t)])",
                DeprecationWarning, stacklevel=3,
            )
            j, tf = self.fail_mapper
            failures = failures + (
                FailureEvent.mapper_kill(int(j), float(tf)),
            )
            object.__setattr__(self, "fail_mapper", None)
        for ev in failures:
            if not isinstance(ev, FailureEvent):
                raise TypeError(f"failures entries must be FailureEvent, "
                                f"got {ev!r}")
            if ev.kind == "cluster_partition":
                raise ValueError(
                    "cluster_partition is a fabric fact, not a per-job "
                    "fault — attach it to the substrate: "
                    "Substrate.with_failures([FailureEvent."
                    "cluster_partition(...)])"
                )
        object.__setattr__(self, "failures", failures)


@dataclasses.dataclass
class SimResult:
    makespan: float
    push_end: float
    map_end: float
    shuffle_end: float
    reduce_end: float
    wasted_mb: float  # duplicated / re-executed work
    recovered_chunks: int
    total_map_chunks: int
    #: payload MB lost to failures (dead workers, dropped in-flight
    #: transfers) and the MB re-dispatched to make it up — conservation
    #: requires the two to match at completion (audited).
    lost_mb: float = 0.0
    reexec_mb: float = 0.0

    def phases(self) -> Dict[str, float]:
        return {
            "push": self.push_end,
            "map": max(self.map_end - self.push_end, 0.0),
            "shuffle": max(self.shuffle_end - self.map_end, 0.0),
            "reduce": max(self.reduce_end - self.shuffle_end, 0.0),
            "makespan": self.makespan,
        }

    def as_dict(self) -> Dict[str, float]:
        """Stable flat form for benchmark emission / JSON dumps: every
        scalar field by name (seconds / MB / counts)."""
        return {
            "makespan": self.makespan,
            "push_end": self.push_end,
            "map_end": self.map_end,
            "shuffle_end": self.shuffle_end,
            "reduce_end": self.reduce_end,
            "wasted_mb": self.wasted_mb,
            "recovered_chunks": float(self.recovered_chunks),
            "total_map_chunks": float(self.total_map_chunks),
            "lost_mb": self.lost_mb,
            "reexec_mb": self.reexec_mb,
        }


# ---------------------------------------------------------------------------
# shared resources
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResourceStats:
    """Accumulated service accounting for one named substrate resource."""

    busy_s: float = 0.0  # seconds spent serving chunks
    waited_s: float = 0.0  # chunk-seconds spent queued behind earlier bookings
    volume_mb: float = 0.0
    n_chunks: int = 0
    jobs: set = dataclasses.field(default_factory=set)
    #: absolute time of the first/last service — a job released at t>0 must
    #: leave ``first_busy_s >= t`` on every resource it alone touches.
    first_busy_s: float = float("inf")
    last_busy_s: float = 0.0

    def record(self, start: float, enqueued: float, dur: float,
               size: float, job: int) -> None:
        self.busy_s += dur
        self.waited_s += start - enqueued
        self.volume_mb += size
        self.n_chunks += 1
        self.jobs.add(job)
        self.first_busy_s = min(self.first_busy_s, start)
        self.last_busy_s = max(self.last_busy_s, start + dur)

    #: default load-warning thresholds (the queueing-delay warning idiom:
    #: flag a resource before it becomes the bottleneck, not after): a
    #: resource is a *hotspot* when its busy fraction of the horizon
    #: exceeds ``UTILIZATION_WARN`` or the mean time a chunk spent queued
    #: behind earlier bookings exceeds ``BACKLOG_AGE_WARN_S``.
    UTILIZATION_WARN = 0.85
    BACKLOG_AGE_WARN_S = 60.0

    def utilization(self, horizon: float) -> float:
        """Fraction of ``horizon`` this resource spent serving."""
        return self.busy_s / horizon if horizon > 0 else 0.0

    @property
    def contended(self) -> bool:
        return len(self.jobs) > 1

    @property
    def mean_wait_s(self) -> float:
        """Mean per-chunk queue delay (fluid mode: the backlog-age
        integral per completed flow) — the backlog-age signal behind
        :meth:`load_warnings`."""
        return self.waited_s / self.n_chunks if self.n_chunks else 0.0

    def load_warnings(
        self,
        horizon: float,
        utilization_above: Optional[float] = None,
        backlog_age_above_s: Optional[float] = None,
    ) -> List[str]:
        """Threshold violations for this resource over ``horizon`` —
        empty when healthy.  ``None`` thresholds fall back to the class
        defaults."""
        u_th = self.UTILIZATION_WARN if utilization_above is None \
            else utilization_above
        b_th = self.BACKLOG_AGE_WARN_S if backlog_age_above_s is None \
            else backlog_age_above_s
        warns = []
        util = self.utilization(horizon)
        if util > u_th:
            warns.append(f"utilization {util:.0%} > {u_th:.0%}")
        if self.mean_wait_s > b_th:
            warns.append(
                f"mean queue delay {self.mean_wait_s:.1f}s > {b_th:.0f}s"
            )
        return warns

    def as_dict(self) -> Dict[str, float]:
        return {
            "busy_s": self.busy_s,
            "waited_s": self.waited_s,
            "mean_wait_s": float(self.mean_wait_s),
            "volume_mb": self.volume_mb,
            "n_chunks": float(self.n_chunks),
            "n_jobs": float(len(self.jobs)),
        }


class _Transfer:
    """One queued/in-service link transfer: the chunk-sized payload plus the
    event to fire when it completes."""

    __slots__ = ("run", "size", "fn", "args", "enqueued")

    def __init__(self, run: "_JobRun", size: float, fn: str, args: tuple,
                 enqueued: float):
        self.run = run
        self.size = float(size)
        self.fn = fn
        self.args = args
        self.enqueued = enqueued


class LinkResource:
    """A point-to-point link serving queued transfers FIFO, one at a time.

    Transfers wait in :attr:`queue` until the link is free — exactly the
    serialization the old eager-booking link applied, but *revocable*: a
    queued transfer has committed nothing and can be pulled back and
    re-routed (plan swap), and each service reads the link's capacity trace
    at its own start time (drift).  Only :attr:`current` is committed.
    """

    __slots__ = ("name", "bw", "trace", "busy", "current", "queue", "stats",
                 "down", "serial")

    def __init__(self, name: str, bw: float, trace=None):
        self.name = name
        self.bw = float(bw)
        self.trace = trace
        self.busy = False
        self.current: Optional[_Transfer] = None
        self.queue: List[_Transfer] = []
        self.stats = ResourceStats()
        #: partition depth: >0 means the link is severed (overlapping
        #: partitions nest, each repair decrements) — the pump refuses to
        #: start service and queued transfers park until repair
        self.down = 0
        #: service generation: bumped on each service start so a completion
        #: event voided by a partition (service revoked mid-flight) can be
        #: recognized as stale and dropped
        self.serial = 0

    def rate_at(self, t: float) -> float:
        """MB/s in force at time ``t`` (nominal unless a trace overrides)."""
        return self.trace.at(t) if self.trace is not None else self.bw


class ComputeResource:
    """A map/reduce worker node serving queued chunks FIFO across jobs."""

    __slots__ = ("name", "rate", "trace", "busy", "current", "current_chunk",
                 "queue", "stats")

    def __init__(self, name: str, rate: float, trace=None):
        self.name = name
        self.rate = float(rate)
        self.trace = trace
        self.busy = False
        #: the job whose chunk is in service (None when idle) — barrier
        #: checks must distinguish "busy with MY chunk" from "busy at all"
        self.current: Optional["_JobRun"] = None
        self.current_chunk: Optional["_Chunk"] = None
        #: FIFO of (job_state, chunk, enqueue_time)
        self.queue: List[Tuple["_JobRun", "_Chunk", float]] = []
        self.stats = ResourceStats()

    def rate_at(self, t: float) -> float:
        return self.trace.at(t) if self.trace is not None else self.rate

    def enqueue(self, run: "_JobRun", chunk: "_Chunk", now: float) -> None:
        self.queue.append((run, chunk, now))

    def job_chunks(self, run: "_JobRun") -> List["_Chunk"]:
        return [c for g, c, _ in self.queue if g is run]

    def remove(self, run: "_JobRun", chunk: "_Chunk") -> None:
        for idx, (g, c, _) in enumerate(self.queue):
            if g is run and c is chunk:
                del self.queue[idx]
                return
        raise ValueError("chunk not queued at this resource")


class _Chunk:
    __slots__ = ("cid", "size", "src", "done", "started_copies", "owner",
                 "cloned", "landed", "replicas")

    def __init__(self, cid: int, size: float, src: int, owner: int = -1):
        self.cid = cid
        self.size = size
        self.src = src  # source index for map chunks; mapper index for reduce
        self.done = False
        self.started_copies = 0
        self.owner = owner  # mapper whose gate/progress counters hold it
        self.cloned = False
        self.landed = False  # push chunk delivered to a live mapper once
        self.replicas = None  # mappers holding a landed replica copy


class _JobRun:
    """Per-job executor state: the plan, barrier gates, progress counters and
    phase timestamps of one job sharing the substrate."""

    def __init__(self, idx: int, platform: Platform, plan: ExecutionPlan,
                 cfg: SimConfig, nM: int, nR: int):
        self.idx = idx
        self.p = platform
        self.plan = plan
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.seeded = False

        # -- pipeline stage linkage (set via _MultiSim.link_stages) --------
        #: upstream run indices whose reduce output feeds this run
        self.stage_deps: Tuple[int, ...] = ()
        #: upstream run idx -> reduce-output MB per reduce-input MB
        self.stage_scale: Dict[int, float] = {}
        #: source idx -> set of upstream run idxs whose output has not yet
        #: landed there (a source releases when its set empties)
        self.dep_pending: Dict[int, set] = {}
        #: per-source MB landed from finalized upstream reducers
        self.dep_landed = np.zeros(platform.nS)
        #: reduce-input MB this run has *completed* per reducer (what a
        #: downstream stage's source receives, times out_scale)
        self.delivered_out = np.zeros(nR)
        #: shuffle chunks destined to each reducer, created but not yet
        #: reduced — zero (with shuffle final) marks the reducer's output
        #: as landed for downstream stages
        self.reduce_outstanding = np.zeros(nR, dtype=np.int64)
        self.reducer_final = np.zeros(nR, dtype=bool)

        self.map_alive = np.ones(nM, dtype=bool)
        self.red_alive = np.ones(nR, dtype=bool)
        #: reduce-output provenance: MB reduced at reducer k that came from
        #: mapper j — what a reducer_kill must claw back to the right
        #: mapper pools (zeroed per column on claw-back)
        self.reduced_by = np.zeros((nM, nR))

        # outstanding counters for gates
        self.push_inflight = np.zeros(nM, dtype=np.int64)
        self.map_unfinished = np.zeros(nM, dtype=np.int64)
        self.shuf_inflight = np.zeros(nR, dtype=np.int64)
        self.total_push_inflight = 0
        self.total_map_unfinished = 0
        self.total_shuf_inflight = 0

        self.push_end = 0.0
        self.map_end = 0.0
        self.shuffle_end = 0.0
        self.reduce_end = 0.0
        self.wasted_mb = 0.0
        self.recovered = 0
        self.total_map_chunks = 0
        # failure loss ledger: payload MB voided by failures and the MB
        # re-dispatched (replica fetch / source re-push / shuffle re-emit /
        # link retransmit) to make it up — conservation demands equality
        self.lost_mb = 0.0
        self.reexec_mb = 0.0

        # byte-conservation ledger (original payload only — replica and
        # speculative traffic is wasted-work accounting, not job volume):
        # seeded pushes must land and map exactly once; shuffle emissions
        # must land and reduce exactly once.  Checked when cfg.audit is on.
        self.pushed_mb = 0.0
        self.landed_mb = 0.0
        self.mapped_mb = 0.0
        self.shuf_created_mb = 0.0
        self.shuf_landed_mb = 0.0
        self.reduced_mb = 0.0

        # chunks delivered to mapper j but gated (push/map barrier)
        self.map_gated: List[List[_Chunk]] = [[] for _ in range(nM)]
        # shuffle emissions gated at mapper j (map/shuffle barrier)
        self.shuf_gated: List[List[Tuple[int, _Chunk]]] = [[] for _ in range(nM)]
        # reduce chunks gated at reducer k (shuffle/reduce barrier)
        self.red_gated: List[List[_Chunk]] = [[] for _ in range(nR)]

    def noise(self) -> float:
        if self.cfg.compute_noise <= 0:
            return 1.0
        return float(np.exp(self.rng.normal(0.0, self.cfg.compute_noise)))

    def slowdown(self, tier: str, idx: int) -> float:
        if self.cfg.stragglers:
            return self.cfg.stragglers.get((tier, idx), 1.0)
        return 1.0

    def result(self) -> SimResult:
        return SimResult(
            makespan=self.reduce_end,
            push_end=self.push_end,
            map_end=self.map_end,
            shuffle_end=self.shuffle_end,
            reduce_end=self.reduce_end,
            wasted_mb=self.wasted_mb,
            recovered_chunks=self.recovered,
            total_map_chunks=self.total_map_chunks,
            lost_mb=self.lost_mb,
            reexec_mb=self.reexec_mb,
        )


@dataclasses.dataclass
class ScheduleSimResult:
    """Concurrent execution of N jobs on one substrate: per-job timings plus
    per-resource service accounting."""

    jobs: List[SimResult]
    makespan: float  # absolute completion time of the last job
    resources: Dict[str, ResourceStats]
    #: runtime-audit findings (``SimConfig(audit=True)`` jobs only) —
    #: empty on a conserving, sane execution.  Deliberately excluded from
    #: :meth:`as_dict` to keep the benchmark JSON schema stable.
    violations: List[str] = dataclasses.field(default_factory=list)

    def utilization(self) -> Dict[str, float]:
        """Busy fraction of the schedule horizon per named resource."""
        return {
            name: s.utilization(self.makespan)
            for name, s in self.resources.items()
        }

    def contended(self) -> Dict[str, ResourceStats]:
        """Resources that served chunks of more than one job."""
        return {n: s for n, s in self.resources.items() if s.contended}

    def hotspots(
        self,
        utilization_above: Optional[float] = None,
        backlog_age_above_s: Optional[float] = None,
    ) -> Dict[str, List[str]]:
        """Resources whose load crossed a warning threshold, mapped to the
        human-readable threshold violations — the schedule-level view of
        :meth:`ResourceStats.load_warnings`.  ``None`` thresholds use the
        :class:`ResourceStats` class defaults (utilization > 85%, mean
        queue delay > 60 s); empty dict = no hotspots."""
        out: Dict[str, List[str]] = {}
        for name, stats in self.resources.items():
            warns = stats.load_warnings(
                self.makespan, utilization_above, backlog_age_above_s
            )
            if warns:
                out[name] = warns
        return out

    def as_dict(self) -> Dict[str, object]:
        """Stable nested form mirroring :meth:`SimResult.as_dict` one level
        up: aggregate makespan, per-job phase timings, per-resource
        utilization and service accounting — what the schedule benchmarks
        and ``--json`` emission feed to figures."""
        return {
            "makespan": self.makespan,
            "jobs": [job.as_dict() for job in self.jobs],
            "utilization": self.utilization(),
            "resources": {n: s.as_dict() for n, s in self.resources.items()},
        }

    def summary(self) -> str:
        worst = sorted(
            self.resources.items(), key=lambda kv: -kv[1].busy_s
        )[:3]
        hot = " ".join(
            f"{n}={s.utilization(self.makespan):.0%}" for n, s in worst
        )
        return (
            f"schedule: {len(self.jobs)} jobs makespan={self.makespan:.1f}s "
            f"contended={len(self.contended())} hottest: {hot}"
        )


@dataclasses.dataclass(frozen=True)
class ProgressSnapshot:
    """The executor's observable state at one event time: every job's
    remaining work bucketed for the re-planner
    (:class:`repro.core.makespan.JobProgress`) plus the MB queued at each
    named resource."""

    time: float
    jobs: Tuple[JobProgress, ...]
    backlog: Dict[str, float]

    def active_jobs(self) -> Tuple[JobProgress, ...]:
        """Jobs with remaining work (released or not)."""
        return tuple(j for j in self.jobs if not j.done)

    def residual_view(self) -> Tuple[Tuple[int, JobProgress], ...]:
        """The multi-job residual view a schedule-aware re-planner
        consumes: ``(job_index, progress)`` for every job with remaining
        work, in job order.  These are the residuals
        :func:`repro.core.optimize.replan_schedule` co-optimizes jointly
        (the indices key :meth:`_MultiSim.swap_plan`)."""
        return tuple((j.job, j) for j in self.jobs if not j.done)

    def backlog_mb(self) -> float:
        """Total MB queued across every substrate resource — one scalar a
        policy can threshold on."""
        return float(sum(self.backlog.values()))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class _MultiSim:
    """Resource-centric event engine running N jobs on one substrate.

    Events are ``(time, seq, fn_name, args)``; chunk events are routed
    through the shared :class:`LinkResource`/:class:`ComputeResource`
    objects, so concurrent jobs contend for the same capacity entries.

    The engine doubles as the **online control plane's plant**: a driver
    may interleave :meth:`run_until` (advance to a decision instant),
    :meth:`snapshot` (observe), :meth:`swap_plan`/:meth:`inject` (steer)
    and finally :meth:`run` (drain to completion).  :meth:`run` with no
    intervening steering is byte-for-byte the offline
    :func:`simulate_schedule`.
    """

    def __init__(self, substrate: Substrate, runs: List[_JobRun]):
        self.sub = substrate
        self.runs = runs
        self.now = 0.0
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._seq = itertools.count()
        self._cid = itertools.count()
        self._started = False
        #: pipeline linkage: parent run idx -> downstream run idxs whose
        #: sources consume the parent's reduce output
        self.stage_children: Dict[int, List[int]] = {}
        #: runtime-audit findings (see :meth:`_audit_step`); bounded so a
        #: broken invariant cannot balloon memory on a long run
        self.violations: List[str] = []
        self._audit = any(g.cfg.audit for g in runs)
        #: substrate-wide dead workers (from the substrate FailureTrace) —
        #: jobs injected after the kill inherit the dead state
        self._dead_m: set = set()
        self._dead_r: set = set()
        #: cached per-job slowdown tables for steered vectorized drains;
        #: rebuilt whenever the job count changes (inject)
        self._vec_slow = None

        nS, nM, nR = substrate.nS, substrate.nM, substrate.nR
        trace = substrate.trace_for
        self.push_links = [
            [LinkResource(f"push[s{i}->m{j}]", substrate.B_sm[i, j],
                          trace(f"push[s{i}->m{j}]"))
             for j in range(nM)]
            for i in range(nS)
        ]
        self.shuf_links = [
            [LinkResource(f"shuffle[m{j}->r{k}]", substrate.B_mr[j, k],
                          trace(f"shuffle[m{j}->r{k}]"))
             for k in range(nR)]
            for j in range(nM)
        ]
        self.mappers = [
            ComputeResource(f"map[m{j}]", substrate.C_m[j], trace(f"map[m{j}]"))
            for j in range(nM)
        ]
        self.reducers = [
            ComputeResource(f"reduce[r{k}]", substrate.C_r[k],
                            trace(f"reduce[r{k}]"))
            for k in range(nR)
        ]

    # -- infrastructure ----------------------------------------------------
    def at(self, t: float, fn: str, *args):
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def _start(self):
        """Schedule the initial seeds and failures (idempotent) — jobs
        sharing a release time seed round-robin (chunk-interleaved bookings
        approximate fair-share FIFO on contended links).  Stage-linked runs
        (:meth:`link_stages`) are not seeded here: their sources release as
        upstream reduce output lands."""
        if self._started:
            return
        self._started = True
        roots = [g for g in self.runs if not g.stage_deps]
        for start in sorted({g.cfg.start_time for g in roots}):
            group = [g for g in roots if g.cfg.start_time == start]
            self.at(start, "seed_jobs", tuple(g.idx for g in group))
        for g in self.runs:
            self._schedule_job_failures(g)
        if self.sub.failures:
            for ev in self.sub.failures:
                if ev.kind == "mapper_kill":
                    self.at(ev.time, "fail_mapper_all", ev.node)
                elif ev.kind == "reducer_kill":
                    self.at(ev.time, "fail_reducer_all", ev.node)
                else:  # cluster_partition
                    self.at(ev.time, "partition", ev.cluster, ev.t_repair)

    def _schedule_job_failures(self, g: _JobRun) -> None:
        """Book job ``g``'s per-job fault script (kills only — fabric
        faults live on the substrate)."""
        for ev in g.cfg.failures:
            fn = "fail_mapper" if ev.kind == "mapper_kill" else "fail_reducer"
            self.at(ev.time, fn, g, ev.node)

    # -- pipeline stage linkage --------------------------------------------
    def link_stages(
        self, child: int, parents: Sequence[Tuple[int, float]]
    ) -> None:
        """Make run ``child`` a downstream pipeline stage of ``parents``
        (``(parent_run_idx, out_scale)`` pairs): its push chunks at source
        node ``s`` release only when every parent's reduce output destined
        for ``s`` (reducer ``s``, scaled by that parent's ``out_scale``)
        has landed.  Must be called before the engine starts."""
        if self._started:
            raise RuntimeError("link_stages must precede the first event")
        if self.sub.nS != self.sub.nR:
            raise ValueError(
                f"stage linking needs nS == nR (reducer r feeds source r), "
                f"substrate has nS={self.sub.nS} nR={self.sub.nR}"
            )
        g = self.runs[child]
        if g.stage_deps:
            raise ValueError(f"run {child} is already stage-linked")
        parent_idxs = [int(p) for p, _ in parents]
        if len(set(parent_idxs)) != len(parent_idxs):
            raise ValueError(f"duplicate parents {parent_idxs}")
        for p in parent_idxs:
            if not 0 <= p < len(self.runs) or p == child:
                raise ValueError(f"bad parent run index {p} for run {child}")
            # reject cycles: child must not already be upstream of p
            stack, seen = [p], set()
            while stack:
                u = stack.pop()
                if u == child:
                    raise ValueError(
                        f"stage link {p}->{child} would close a cycle"
                    )
                if u in seen:
                    continue
                seen.add(u)
                stack.extend(self.runs[u].stage_deps)
        g.stage_deps = tuple(parent_idxs)
        g.stage_scale = {int(p): float(s) for p, s in parents}
        g.dep_pending = {
            i: set(parent_idxs) for i in range(self.sub.nS)
        }
        for p in parent_idxs:
            self.stage_children.setdefault(p, []).append(child)

    def _maybe_finalize_stage(self, g: _JobRun) -> None:
        """Mark the reducers of ``g`` whose output can no longer grow as
        final and hand their landed volume to downstream stage sources.
        No-op unless ``g`` has stage children."""
        children = self.stage_children.get(g.idx)
        if not children or not self._shuffle_final(g):
            return
        for k in range(self.sub.nR):
            if (g.reducer_final[k] or g.shuf_inflight[k] != 0
                    or g.reduce_outstanding[k] != 0):
                continue
            g.reducer_final[k] = True
            for c in children:
                child = self.runs[c]
                waiting = child.dep_pending.get(k)
                if waiting is None or g.idx not in waiting:
                    continue
                child.dep_landed[k] += (
                    child.stage_scale[g.idx] * g.delivered_out[k]
                )
                waiting.discard(g.idx)
                if not waiting:
                    del child.dep_pending[k]
                    self._release_source(child, k)

    def _release_source(self, g: _JobRun, i: int) -> None:
        """Seed source ``i``'s push chunks of a stage-linked run: the
        *measured* upstream output that landed there, routed per the run's
        (possibly swapped-in) plan.  When this was the last pending source,
        re-check every barrier gate — phases that were held back solely by
        the pending sources may now proceed."""
        g.seeded = True
        amount = float(g.dep_landed[i])
        if amount > 1e-9:
            cfg = g.cfg
            for j in range(self.sub.nM):
                share = amount * g.plan.x[i, j]
                if share <= 1e-9:
                    continue
                n_chunks = max(int(np.ceil(share / cfg.chunk_mb)), 1)
                for _ in range(n_chunks):
                    self._seed_push_chunk(g, i, j, share / n_chunks)
        if not g.dep_pending:
            self._recheck_gates(g)

    def _recheck_gates(self, g: _JobRun) -> None:
        """Open every barrier gate whose condition holds now — called once
        a stage-linked run becomes fully fed, since the pending-source
        guards may have held gates shut past their trigger events."""
        b0, b1, b2 = g.cfg.barriers
        nM, nR = self.sub.nM, self.sub.nR
        if b0 == "L":
            for j in range(nM):
                if g.push_inflight[j] == 0:
                    self._open_map_gate(g, j)
        elif b0 == "G" and g.total_push_inflight == 0:
            for j in range(nM):
                self._open_map_gate(g, j)
        if b1 == "L":
            for j in range(nM):
                node = self.mappers[j]
                if g.map_unfinished[j] == 0 \
                        and not (node.busy and node.current is g):
                    self._open_shuffle_gate(g, j)
        elif b1 == "G" and g.total_map_unfinished == 0 \
                and g.total_push_inflight == 0:
            for j in range(nM):
                self._open_shuffle_gate(g, j)
        if b2 == "L":
            for k in range(nR):
                if g.shuf_inflight[k] == 0 and self._shuffle_final(g):
                    self._open_reduce_gate(g, k)
        elif b2 == "G" and g.total_shuf_inflight == 0 \
                and self._shuffle_final(g):
            for k in range(nR):
                self._open_reduce_gate(g, k)
        self._maybe_finalize_stage(g)

    def _dispatch(self):
        t, _, fn, args = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        getattr(self, "_ev_" + fn)(*args)
        if self._audit:
            self._audit_step(fn)

    # -- runtime audit -----------------------------------------------------
    _MAX_VIOLATIONS = 200

    def _violate(self, msg: str) -> None:
        if len(self.violations) < self._MAX_VIOLATIONS:
            self.violations.append(f"t={self.now:.6f}: {msg}")
        elif len(self.violations) == self._MAX_VIOLATIONS:
            self.violations.append("... further violations suppressed")

    def _audit_step(self, fn: str) -> None:
        """Post-event sanity: gate counters must stay non-negative and the
        scalar totals must equal their per-node sums — a drift here means a
        gate can deadlock shut or open early."""
        for g in self.runs:
            if not g.cfg.audit:
                continue
            for name, arr in (
                ("push_inflight", g.push_inflight),
                ("map_unfinished", g.map_unfinished),
                ("shuf_inflight", g.shuf_inflight),
                ("reduce_outstanding", g.reduce_outstanding),
            ):
                if np.any(arr < 0):
                    self._violate(
                        f"job {g.idx}: after {fn}: {name} negative at "
                        f"nodes {np.flatnonzero(arr < 0).tolist()}"
                    )
            for name, total, arr in (
                ("push_inflight", g.total_push_inflight, g.push_inflight),
                ("map_unfinished", g.total_map_unfinished, g.map_unfinished),
                ("shuf_inflight", g.total_shuf_inflight, g.shuf_inflight),
            ):
                if total != int(arr.sum()):
                    self._violate(
                        f"job {g.idx}: after {fn}: total_{name}={total} "
                        f"!= sum({name})={int(arr.sum())}"
                    )

    def _audit_final(self) -> None:
        """Byte conservation at completion: every seeded MB lands, maps,
        shuffles (scaled by alpha) and reduces exactly once."""

        def close(a: float, b: float) -> bool:
            # rel 1e-6 plus a small absolute floor: shuffle emission skips
            # sub-1e-9 slivers, so alpha-scaled totals are near- but not
            # bit-exact
            return abs(a - b) <= 1e-6 * max(abs(a), abs(b)) + 1e-3

        for g in self.runs:
            if not g.cfg.audit or not g.seeded:
                continue
            checks = (
                ("landed_mb", g.landed_mb, "pushed_mb", g.pushed_mb),
                ("mapped_mb", g.mapped_mb, "landed_mb", g.landed_mb),
                ("shuf_created_mb", g.shuf_created_mb,
                 "alpha*mapped_mb", g.p.alpha * g.mapped_mb),
                ("shuf_landed_mb", g.shuf_landed_mb,
                 "shuf_created_mb", g.shuf_created_mb),
                ("reduced_mb", g.reduced_mb,
                 "shuf_landed_mb", g.shuf_landed_mb),
                # bytes voided by failures must be exactly re-dispatched:
                # no silent byte creation or loss around a fault
                ("reexec_mb", g.reexec_mb, "lost_mb", g.lost_mb),
            )
            for name_a, a, name_b, b in checks:
                if not close(a, b):
                    self._violate(
                        f"job {g.idx}: conservation: {name_a}={a:.6f} != "
                        f"{name_b}={b:.6f}"
                    )

    @property
    def finished(self) -> bool:
        return self._started and not self._heap

    def run_until(self, t: float, inclusive: bool = False) -> None:
        """Advance the clock to ``t``, processing every event strictly
        before it.  Events *at* ``t`` stay pending, so a decision taken at
        ``t`` (inject, swap) acts before them — matching the offline event
        order, where release seeds carry the earliest sequence numbers.
        ``inclusive`` additionally drains the events *at* ``t`` — the right
        framing when the decision must observe what happens at that instant
        (e.g. re-planning *after* a worker failure fires)."""
        self._start()
        if self._heap and self._vec_steer_eligible():
            self._vec_drain(t, inclusive)
        else:
            while self._heap and (
                self._heap[0][0] < t
                or (inclusive and self._heap[0][0] == t)
            ):
                self._dispatch()
        self.now = max(self.now, t)

    def run(self) -> ScheduleSimResult:
        if (not self._started and self.runs
                and all(g.cfg.mode == "event_vec" for g in self.runs)):
            return self._run_vectorized()
        self._start()
        if self._heap and self._vec_steer_eligible():
            # started (steered) engine: drain everything through the
            # batched scans; the scalar loop below mops up anything a
            # drained segment re-scheduled (it never does today, but the
            # fallback keeps the contract obvious)
            self._vec_drain(None, True)
        while self._heap:
            self._dispatch()
        if self._audit:
            self._audit_final()
        return self.result()

    def result(self) -> ScheduleSimResult:
        resources: Dict[str, ResourceStats] = {}
        for row in self.push_links:
            for link in row:
                resources[link.name] = link.stats
        for row in self.shuf_links:
            for link in row:
                resources[link.name] = link.stats
        for node in self.mappers + self.reducers:
            resources[node.name] = node.stats
        return ScheduleSimResult(
            jobs=[g.result() for g in self.runs],
            makespan=max((g.reduce_end for g in self.runs), default=0.0),
            resources=resources,
            violations=list(self.violations),
        )

    def _rate(self, g: _JobRun, tier: str, idx: int) -> float:
        node = self.mappers[idx] if tier == "m" else self.reducers[idx]
        return node.rate_at(self.now) / g.slowdown(tier, idx)

    # -- link pump ---------------------------------------------------------
    def _link_send(self, link: LinkResource, g: _JobRun, size: float,
                   fn: str, args: tuple) -> None:
        link.queue.append(_Transfer(g, size, fn, args, self.now))
        self._pump_link(link)

    def _pump_link(self, link: LinkResource):
        if link.busy or link.down or not link.queue:
            return
        tr = link.queue.pop(0)
        link.busy = True
        link.current = tr
        link.serial += 1
        dur = tr.size / link.rate_at(self.now)
        link.stats.record(self.now, tr.enqueued, dur, tr.size, tr.run.idx)
        self.at(self.now + dur, "link_done", link, tr, link.serial)

    def _ev_link_done(self, link: LinkResource, tr: _Transfer, serial=None):
        if serial is not None and serial != link.serial:
            # a partition revoked this service mid-flight; the completion is
            # void and the payload was already re-queued at partition time
            return
        link.busy = False
        link.current = None
        getattr(self, "_ev_" + tr.fn)(*tr.args)
        self._pump_link(link)

    # -- push phase ----------------------------------------------------------
    def _ev_seed_jobs(self, idxs: Tuple[int, ...]):
        """Seed every push chunk of the released jobs, interleaving chunks
        across jobs so shared links serve them round-robin."""
        pending = [(self.runs[i], self._push_ops(self.runs[i])) for i in idxs]
        for i in idxs:
            self.runs[i].seeded = True
        cursors = [0] * len(pending)
        live = True
        while live:
            live = False
            for slot, (g, ops) in enumerate(pending):
                if cursors[slot] >= len(ops):
                    continue
                live = True
                i, j, size = ops[cursors[slot]]
                cursors[slot] += 1
                self._seed_push_chunk(g, i, j, size)

    def _seed_push_chunk(self, g: _JobRun, i: int, j: int, size: float):
        """Create one push chunk (plus its replicas) with its gate
        counters — the unit of both t=0 seeding and per-source stage
        release."""
        c = _Chunk(next(self._cid), size, i, owner=j)
        g.total_map_chunks += 1
        g.pushed_mb += size
        g.push_inflight[j] += 1
        g.total_push_inflight += 1
        g.map_unfinished[j] += 1
        g.total_map_unfinished += 1
        self._send_push(g, i, j, c)
        self._replicate(g, i, j, c)

    def _push_ops(self, g: _JobRun) -> List[Tuple[int, int, float]]:
        """The job's push chunks as (source, mapper, MB) in seeding order."""
        cfg, p = g.cfg, g.p
        ops: List[Tuple[int, int, float]] = []
        for i in range(p.nS):
            for j in range(p.nM):
                amount = p.D[i] * g.plan.x[i, j]
                if amount <= 1e-9:
                    continue
                n_chunks = max(int(np.ceil(amount / cfg.chunk_mb)), 1)
                ops.extend((i, j, amount / n_chunks) for _ in range(n_chunks))
        return ops

    def _replicate(self, g: _JobRun, i: int, j: int, c: _Chunk):
        """Write replication-1 extra copies of a push chunk (replica targets
        never run map work; they only consume link capacity — until the
        origin mapper dies, when a landed replica becomes the cheapest
        recovery source)."""
        sub, cfg = self.sub, g.cfg
        size = c.size
        for r in range(cfg.replication - 1):
            if cfg.cross_cluster_replication:
                candidates = [
                    m for m in range(sub.nM)
                    if sub.cluster_m[m] != sub.cluster_m[j]
                ]
            else:
                candidates = [
                    m
                    for m in range(sub.nM)
                    if sub.cluster_m[m] == sub.cluster_m[j] and m != j
                ]
            if not candidates:
                candidates = [m for m in range(sub.nM) if m != j]
            tgt = candidates[(j + r + 1) % len(candidates)]
            g.wasted_mb += size
            # the write pipeline is not durable (and the push phase not
            # complete) until every replica is on disk: replica writes gate
            # the ORIGIN mapper's input like any other push chunk.
            g.push_inflight[j] += 1
            g.total_push_inflight += 1
            self._link_send(self.push_links[i][tgt], g, size,
                            "replica_done", (g, c, j, tgt))

    def _ev_replica_done(self, g: _JobRun, c: _Chunk, j: int, tgt: int):
        g.push_end = max(g.push_end, self.now)
        g.push_inflight[j] -= 1
        g.total_push_inflight -= 1
        if g.map_alive[tgt]:
            if c.replicas is None:
                c.replicas = []
            c.replicas.append(tgt)
        b = g.cfg.barriers[0]
        if g.dep_pending:
            # a pending stage source may still route data anywhere: every
            # map gate stays shut until the run is fully fed
            return
        if b == "L" and g.push_inflight[j] == 0:
            self._open_map_gate(g, j)
        elif b == "G" and g.total_push_inflight == 0:
            for m in range(self.sub.nM):
                self._open_map_gate(g, m)

    def _send_push(self, g: _JobRun, i: int, j: int, c: _Chunk):
        self._link_send(self.push_links[i][j], g, c.size,
                        "push_arrive", (g, i, j, c))

    def _ev_push_arrive(self, g: _JobRun, i: int, j: int, c: _Chunk):
        g.push_end = max(g.push_end, self.now)
        g.push_inflight[j] -= 1
        g.total_push_inflight -= 1
        if not g.map_alive[j]:
            self._recover_chunk(g, j, c)
            return
        self._deliver_push(g, j, c)

    def _deliver_push(self, g: _JobRun, j: int, c: _Chunk):
        """Land chunk ``c`` at live mapper ``j``: ledger, then queue or
        gate per the push/map barrier.  Shared by arrival over the push
        link and zero-cost local delivery from an on-node replica."""
        if not c.landed:
            c.landed = True
            g.landed_mb += c.size
        b = g.cfg.barriers[0]
        if b == "P":
            self.mappers[j].enqueue(g, c, self.now)
            self._pump_map(j)
        else:
            g.map_gated[j].append(c)
            if g.dep_pending:
                return  # fully-fed gate checks happen at the last release
            if b == "L" and g.push_inflight[j] == 0:
                self._open_map_gate(g, j)
            elif b == "G" and g.total_push_inflight == 0:
                for m in range(self.sub.nM):
                    self._open_map_gate(g, m)

    def _open_map_gate(self, g: _JobRun, j: int):
        if g.map_gated[j]:
            for c in g.map_gated[j]:
                self.mappers[j].enqueue(g, c, self.now)
            g.map_gated[j].clear()
        self._pump_map(j)

    # -- map phase -------------------------------------------------------------
    def _pump_map(self, j: int):
        node = self.mappers[j]
        if node.busy:
            return
        if not node.queue:
            self._idle_mapper(j)
            return
        g, c, t_enq = node.queue.pop(0)
        if c.done:  # a speculative twin already finished this chunk
            self._pump_map(j)
            return
        c.started_copies += 1
        node.busy = True
        node.current = g
        node.current_chunk = c
        dur = c.size / self._rate(g, "m", j) * g.noise()
        node.stats.record(self.now, t_enq, dur, c.size, g.idx)
        self.at(self.now + dur, "map_done", g, j, c)

    def _ev_map_done(self, g: _JobRun, j: int, c: _Chunk):
        self.mappers[j].busy = False
        self.mappers[j].current = None
        self.mappers[j].current_chunk = None
        if c.done:
            g.wasted_mb += c.size  # lost the speculation race
            self._pump_map(j)
            return
        c.done = True
        g.map_end = max(g.map_end, self.now)
        g.mapped_mb += c.size
        owner = c.owner if c.owner >= 0 else j
        g.map_unfinished[owner] -= 1
        g.total_map_unfinished -= 1
        self._emit_shuffle(g, j, c)
        if owner != j and g.cfg.barriers[1] == "L" \
                and g.map_unfinished[owner] == 0 and not g.dep_pending:
            self._open_shuffle_gate(g, owner)
        self._pump_map(j)
        self._maybe_finalize_stage(g)

    def _emit_shuffle(self, g: _JobRun, j: int, c: _Chunk):
        b = g.cfg.barriers[1]
        y = g.plan.y
        if not g.red_alive.all():
            # mask dead reducers and renormalize — new emissions must not
            # target a dead node (the guard keeps no-failure runs on the
            # exact float path of the original expression)
            live = np.where(g.red_alive, y, 0.0)
            if live.sum() <= 1e-12:
                live = np.where(g.red_alive, 1.0, 0.0)
                if live.sum() == 0:
                    raise RuntimeError("all reducers dead")
            y = live / live.sum()
        for k in range(self.sub.nR):
            amount = g.p.alpha * c.size * y[k]
            if amount <= 1e-9:
                continue
            sc = _Chunk(next(self._cid), float(amount), j)
            g.shuf_created_mb += sc.size
            g.shuf_inflight[k] += 1
            g.total_shuf_inflight += 1
            g.reduce_outstanding[k] += 1
            if b == "P":
                self._send_shuffle(g, j, k, sc)
            else:
                g.shuf_gated[j].append((k, sc))
        if g.dep_pending:
            return  # pending stage sources will add map work: gates held
        if b == "L" and g.map_unfinished[j] == 0:
            self._open_shuffle_gate(g, j)
        elif b == "G" and g.total_map_unfinished == 0:
            for m in range(self.sub.nM):
                self._open_shuffle_gate(g, m)

    def _open_shuffle_gate(self, g: _JobRun, j: int):
        for k, sc in g.shuf_gated[j]:
            self._send_shuffle(g, j, k, sc)
        g.shuf_gated[j].clear()

    def _send_shuffle(self, g: _JobRun, j: int, k: int, sc: _Chunk):
        self._link_send(self.shuf_links[j][k], g, sc.size,
                        "shuffle_arrive", (g, j, k, sc))

    def _ev_shuffle_arrive(self, g: _JobRun, j: int, k: int, sc: _Chunk):
        g.shuf_inflight[k] -= 1
        g.total_shuf_inflight -= 1
        if not g.red_alive[k]:
            # the reducer died while this emission was in flight: the
            # payload bounces — void it and re-emit to surviving reducers
            g.reduce_outstanding[k] -= 1
            g.shuf_created_mb -= sc.size
            g.lost_mb += sc.size
            g.wasted_mb += sc.size
            self._reemit_shuffle(g, j, sc.size)
            return
        g.shuffle_end = max(g.shuffle_end, self.now)
        g.shuf_landed_mb += sc.size
        b = g.cfg.barriers[2]
        if b == "P":
            self.reducers[k].enqueue(g, sc, self.now)
            self._pump_reduce(k)
        else:
            g.red_gated[k].append(sc)
            if b == "L" and g.shuf_inflight[k] == 0 and self._shuffle_final(g):
                self._open_reduce_gate(g, k)
            elif b == "G" and g.total_shuf_inflight == 0 and self._shuffle_final(g):
                for r in range(self.sub.nR):
                    self._open_reduce_gate(g, r)

    def _shuffle_final(self, g: _JobRun) -> bool:
        """No more shuffle chunks can appear (all the job's map work done
        and, for a stage-linked run, every source fully fed)."""
        return (g.total_map_unfinished == 0 and g.total_push_inflight == 0
                and not g.dep_pending)

    def _open_reduce_gate(self, g: _JobRun, k: int):
        if g.red_gated[k]:
            for sc in g.red_gated[k]:
                self.reducers[k].enqueue(g, sc, self.now)
            g.red_gated[k].clear()
        self._pump_reduce(k)

    # -- reduce phase ------------------------------------------------------------
    def _pump_reduce(self, k: int):
        node = self.reducers[k]
        if node.busy or not node.queue:
            return
        g, sc, t_enq = node.queue.pop(0)
        if sc.done:
            self._pump_reduce(k)
            return
        node.busy = True
        node.current = g
        node.current_chunk = sc
        dur = sc.size / self._rate(g, "r", k) * g.noise()
        node.stats.record(self.now, t_enq, dur, sc.size, g.idx)
        self.at(self.now + dur, "reduce_done", g, k, sc)

    def _ev_reduce_done(self, g: _JobRun, k: int, sc: _Chunk):
        self.reducers[k].busy = False
        self.reducers[k].current = None
        self.reducers[k].current_chunk = None
        if not sc.done:
            sc.done = True
            g.reduce_end = max(g.reduce_end, self.now)
            g.reduced_mb += sc.size
            g.delivered_out[k] += sc.size
            g.reduce_outstanding[k] -= 1
            g.reduced_by[sc.src, k] += sc.size
        else:
            g.wasted_mb += sc.size
        self._pump_reduce(k)
        self._maybe_finalize_stage(g)

    # -- dynamics: stealing / speculation ----------------------------------------
    def _idle_mapper(self, j: int):
        """The node ran out of queued work entirely; let each job with
        dynamics enabled (and a live worker here) try to relocate one of its
        own backlogged chunks.  At most one booking per idle trigger."""
        for g in self.runs:
            if not (g.cfg.stealing or g.cfg.speculation) or not g.map_alive[j]:
                continue
            if self._idle_mapper_for(g, j):
                return

    def _idle_mapper_for(self, g: _JobRun, j: int) -> bool:
        cfg = g.cfg
        # expected remaining compute time per mapper (this job's chunks)
        rem = np.array(
            [
                sum(c.size for c in self.mappers[m].job_chunks(g) if not c.done)
                / self._rate(g, "m", m)
                for m in range(self.sub.nM)
            ]
        )
        if rem.sum() <= 0:
            return False
        # fleet-mean progress (zeros included): a node is a straggler when
        # it lags the whole fleet, not merely other still-busy nodes
        mean = rem.mean()
        victim = int(rem.argmax())
        if victim == j or rem[victim] < cfg.spec_threshold * max(mean, 1e-9):
            return False
        pending = [
            c for c in self.mappers[victim].job_chunks(g)
            if not c.done and not c.cloned
        ]
        if not pending:
            return False
        c = pending[-1]
        # progress-based sanity check (Hadoop estimates task progress before
        # speculating): only act when the thief can plausibly win the race.
        my_time = c.size / self.sub.B_sm[c.src, j] + c.size / self._rate(g, "m", j)
        if my_time >= rem[victim]:
            return False
        if cfg.stealing:
            self.mappers[victim].remove(g, c)
            # ownership (and its gate counters) moves with the chunk
            g.map_unfinished[victim] -= 1
            g.map_unfinished[j] += 1
            c.owner = j
            # open now unless the victim is mid-service on one of THIS
            # job's chunks (that chunk's map_done reopens the gate);
            # another job's in-service chunk must not hold g's gate shut
            victim_node = self.mappers[victim]
            if cfg.barriers[1] == "L" and g.map_unfinished[victim] == 0 \
                    and not g.dep_pending \
                    and not (victim_node.busy and victim_node.current is g):
                self._open_shuffle_gate(g, victim)
        else:  # speculation: clone, twin-completion resolved via c.done
            c.cloned = True
        # re-fetch the input from the source over the push link
        self._link_send(self.push_links[c.src][j], g, c.size,
                        "stolen_arrive", (g, j, c))
        return True

    def _ev_stolen_arrive(self, g: _JobRun, j: int, c: _Chunk):
        if c.done:
            return
        if not g.map_alive[j]:
            # a STOLEN chunk (ownership moved to the thief) dies with the
            # thief unless recovered; a speculative clone still lives in
            # the victim's queue and can simply be dropped
            if c.owner == j:
                self._recover_chunk(g, j, c)
            return
        self.mappers[j].enqueue(g, c, self.now)
        self._pump_map(j)

    # -- dynamics: failure recovery ----------------------------------------------
    def _ev_fail_mapper(self, g: _JobRun, j: int):
        if not g.map_alive[j]:
            return  # already dead (per-job script + substrate trace overlap)
        g.map_alive[j] = False
        node = self.mappers[j]
        lost = [c for c in node.job_chunks(g) if not c.done]
        lost += [c for c in g.map_gated[j] if not c.done]
        node.queue = [(h, c, t) for h, c, t in node.queue if h is not g]
        g.map_gated[j].clear()
        # an in-flight chunk (already popped) still completes — the node's
        # busy flag clears at its map_done, exactly as before the refactor
        for c in lost:
            self._recover_chunk(g, j, c)

    def _recover_chunk(self, g: _JobRun, dead: int, c: _Chunk):
        """Re-execute a lost chunk: promote a landed replica on a surviving
        mapper (zero-cost local delivery — the copy is already on disk
        there), else re-push from the source to the job's best surviving
        mapper."""
        g.recovered += 1
        g.lost_mb += c.size
        alive = np.flatnonzero(g.map_alive)
        if alive.size == 0:
            raise RuntimeError("all mappers dead")
        holders = [int(t) for t in (c.replicas or ()) if g.map_alive[t]]
        if holders:
            tgt = holders[int(np.argmax(self.sub.C_m[holders]))]
            if c.owner >= 0 and c.owner != tgt:
                g.map_unfinished[c.owner] -= 1
                g.map_unfinished[tgt] += 1
                c.owner = tgt
            g.reexec_mb += c.size
            self._deliver_push(g, tgt, c)
            return
        i = c.src
        tgt = int(alive[np.argmax(self.sub.B_sm[i, alive])])
        if c.owner >= 0 and c.owner != tgt:
            g.map_unfinished[c.owner] -= 1
            g.map_unfinished[tgt] += 1
            c.owner = tgt
        g.wasted_mb += c.size
        g.reexec_mb += c.size
        g.push_inflight[tgt] += 1
        g.total_push_inflight += 1
        self._link_send(self.push_links[i][tgt], g, c.size,
                        "push_arrive", (g, i, tgt, c))

    def _ev_fail_reducer(self, g: _JobRun, k: int):
        """Reducer ``k`` dies for job ``g``: every byte it held —
        queued, barrier-gated, mid-service, even already reduced — is
        void.  The claw-back nets the conservation ledger and pools the
        volume back at its origin mappers for re-emission toward the
        surviving reducers."""
        if not g.red_alive[k]:
            return  # already dead (per-job script + substrate trace overlap)
        if (self._shuffle_final(g) and g.total_shuf_inflight == 0
                and int(g.reduce_outstanding.sum()) == 0):
            # the job already committed its output — a later node death
            # cannot un-deliver it (completion is the durability point)
            return
        g.red_alive[k] = False
        node = self.reducers[k]
        pool = np.zeros(self.sub.nM)
        # landed-but-unreduced chunks queued at the node or barrier-gated
        clawed = [sc for h, sc, _ in node.queue if h is g and not sc.done]
        clawed += [sc for sc in g.red_gated[k] if not sc.done]
        node.queue = [(h, sc, t) for h, sc, t in node.queue if h is not g]
        g.red_gated[k].clear()
        for sc in clawed:
            pool[sc.src] += sc.size
            g.shuf_landed_mb -= sc.size
            g.shuf_created_mb -= sc.size
            g.reduce_outstanding[k] -= 1
            g.lost_mb += sc.size
            g.wasted_mb += sc.size
        # un-started emissions queued on the shuffle links toward k are
        # simply pulled back (nothing spent yet); a transfer mid-service
        # is committed and bounces on arrival (_ev_shuffle_arrive)
        for j in range(self.sub.nM):
            link = self.shuf_links[j][k]
            kept = []
            for tr in link.queue:
                if tr.run is g and tr.fn == "shuffle_arrive":
                    sc = tr.args[3]
                    pool[sc.src] += sc.size
                    g.shuf_inflight[k] -= 1
                    g.total_shuf_inflight -= 1
                    g.reduce_outstanding[k] -= 1
                    g.shuf_created_mb -= sc.size
                    g.lost_mb += sc.size
                else:
                    kept.append(tr)
            link.queue = kept
        # the chunk mid-service on the dead node dies with it: marking it
        # done sends its pending reduce_done into the wasted branch
        if node.current is g and node.current_chunk is not None \
                and not node.current_chunk.done:
            sc = node.current_chunk
            pool[sc.src] += sc.size
            g.shuf_landed_mb -= sc.size
            g.shuf_created_mb -= sc.size
            g.reduce_outstanding[k] -= 1
            g.lost_mb += sc.size
            sc.done = True
        # output already reduced at k is void too — un-deliver it by
        # provenance (a finalized reducer's output has been handed to
        # downstream stages and cannot be clawed back)
        if not g.reducer_final[k]:
            for j in range(self.sub.nM):
                lost_red = float(g.reduced_by[j, k])
                if lost_red <= 1e-9:
                    continue
                pool[j] += lost_red
                g.reduced_mb -= lost_red
                g.shuf_landed_mb -= lost_red
                g.shuf_created_mb -= lost_red
                g.delivered_out[k] -= lost_red
                g.wasted_mb += lost_red
                g.lost_mb += lost_red
            g.reduced_by[:, k] = 0.0
        for j in range(self.sub.nM):
            if pool[j] > 1e-9:
                self._reemit_shuffle(g, j, float(pool[j]))

    def _reemit_shuffle(self, g: _JobRun, j: int, amount: float) -> None:
        """Re-emit ``amount`` MB of mapper ``j``'s shuffle output toward
        the surviving open reducers — the plan's ``y`` renormalized over
        ``red_alive & ~reducer_final`` (uniform fallback when the plan
        routed everything to dead nodes), chunked at ``cfg.chunk_mb``."""
        y = np.asarray(g.plan.y)
        open_r = g.red_alive & ~g.reducer_final
        if not open_r.any():
            raise RuntimeError("all reducers dead")
        shares = np.where((y > 1e-9) & open_r, y, 0.0)
        if shares.sum() <= 0:
            shares = np.where(open_r, 1.0, 0.0)
        shares *= amount / shares.sum()
        b1 = g.cfg.barriers[1]
        for k in range(self.sub.nR):
            if shares[k] <= 1e-9:
                continue
            n = max(int(np.ceil(shares[k] / g.cfg.chunk_mb)), 1)
            for _ in range(n):
                sc = _Chunk(next(self._cid), shares[k] / n, j)
                g.shuf_created_mb += sc.size
                g.reexec_mb += sc.size
                g.shuf_inflight[k] += 1
                g.total_shuf_inflight += 1
                g.reduce_outstanding[k] += 1
                if b1 == "P":
                    self._send_shuffle(g, j, k, sc)
                else:
                    g.shuf_gated[j].append((k, sc))
        if b1 == "P" or g.dep_pending:
            return
        node = self.mappers[j]
        if b1 == "L" and g.map_unfinished[j] == 0 \
                and not (node.busy and node.current is g):
            self._open_shuffle_gate(g, j)
        elif b1 == "G" and g.total_map_unfinished == 0 \
                and g.total_push_inflight == 0:
            self._open_shuffle_gate(g, j)

    # -- substrate-wide failures (the FailureTrace) -------------------------------
    def _ev_fail_mapper_all(self, j: int):
        self._dead_m.add(int(j))
        for g in self.runs:
            if g.map_alive[j]:
                self._ev_fail_mapper(g, j)

    def _ev_fail_reducer_all(self, k: int):
        self._dead_r.add(int(k))
        for g in self.runs:
            if g.red_alive[k]:
                self._ev_fail_reducer(g, k)

    def _partition_links(self, cluster: int) -> List[LinkResource]:
        """Every link severed by partitioning ``cluster`` away (one
        endpoint inside, one outside)."""
        push_cut, shuf_cut = self.sub.partition_cut(cluster)
        links: List[LinkResource] = []
        for i, row in enumerate(self.push_links):
            for j, link in enumerate(row):
                if push_cut[i, j]:
                    links.append(link)
        for j, row in enumerate(self.shuf_links):
            for k, link in enumerate(row):
                if shuf_cut[j, k]:
                    links.append(link)
        return links

    def _ev_partition(self, cluster: int, t_repair):
        """Sever every link crossing the cluster boundary: the in-service
        transfer fails immediately (its payload is lost and re-queued at the
        FRONT of the link, where a plan swap can still pull it back and
        re-route it), queued transfers park — also revocable by a swap."""
        for link in self._partition_links(cluster):
            link.down += 1
            if link.current is not None:
                tr = link.current
                g = tr.run
                g.lost_mb += tr.size
                g.reexec_mb += tr.size
                g.wasted_mb += tr.size
                link.queue.insert(0, tr)
                link.busy = False
                link.current = None
                link.serial += 1
        if t_repair is not None:
            self.at(float(t_repair), "partition_repair", cluster)

    def _ev_partition_repair(self, cluster: int):
        for link in self._partition_links(cluster):
            link.down -= 1
            if not link.down:
                self._pump_link(link)

    # -- online control plane: observe ------------------------------------------
    def snapshot(self) -> ProgressSnapshot:
        """Capture every job's remaining work at the current event time,
        bucketed by what a re-planner can still control (see
        :class:`repro.core.makespan.JobProgress`), plus per-resource queued
        MB.  Speculative/replica overhead traffic is excluded — it is
        wasted-work accounting, not residual job volume.

        A single pass over every queue buckets in-flight traffic by owning
        run, so the cost is O(queued transfers + jobs) rather than
        O(queued transfers x jobs) — at the scale tier (100+ jobs, deep
        link queues) the per-job rescan used to dominate steered runs."""
        nS, nM, nR = self.sub.nS, self.sub.nM, self.sub.nR
        # per-run accumulators: resid_push, committed_push, at_mapper,
        # shuffle_pool, committed_shuffle, at_reducer
        acc: Dict[int, list] = {
            id(g): [np.zeros(g.p.nS), np.zeros((g.p.nS, nM)), np.zeros(nM),
                    np.zeros(nM), np.zeros((nM, nR)), np.zeros(nR)]
            for g in self.runs if g.seeded
        }

        def add_push(tr, current: bool):
            a = acc.get(id(tr.run))
            if a is None:
                return
            if tr.fn == "push_arrive":
                c = tr.args[3]
                if not c.done:
                    if current and tr.run.map_alive[tr.args[2]]:
                        a[1][tr.args[1], tr.args[2]] += c.size
                    else:
                        # queued, or in flight to a dead mapper (it will
                        # bounce into recovery): the planner may still
                        # re-route it
                        a[0][tr.args[1]] += c.size
            elif tr.fn == "stolen_arrive":
                # stolen chunks (ownership moved to the thief) are real
                # residual work in flight to a fixed destination;
                # speculative clones are overhead (their originals still
                # sit, counted, in the victim's queue)
                j, c = tr.args[1], tr.args[2]
                if c.owner == j and not c.done:
                    a[1][c.src, j] += c.size

        for row in self.push_links:
            for link in row:
                for tr in link.queue:
                    add_push(tr, current=False)
                if link.current is not None:
                    add_push(link.current, current=True)
        for row in self.shuf_links:
            for link in row:
                for tr in link.queue:
                    if tr.fn == "shuffle_arrive" \
                            and (a := acc.get(id(tr.run))) is not None:
                        sc = tr.args[3]
                        if not sc.done:
                            a[3][tr.args[1]] += sc.size
                cur = link.current
                if cur is not None and cur.fn == "shuffle_arrive" \
                        and (a := acc.get(id(cur.run))) is not None:
                    sc = cur.args[3]
                    if not sc.done:
                        if not cur.run.red_alive[cur.args[2]]:
                            # destined to a dead reducer: it bounces
                            # back into the pool on arrival
                            a[3][cur.args[1]] += sc.size
                        else:
                            a[4][cur.args[1], cur.args[2]] += sc.size
        for j, node in enumerate(self.mappers):
            for h, c, _ in node.queue:
                if not c.done and (a := acc.get(id(h))) is not None:
                    a[2][j] += c.size
            if node.current is not None and node.current_chunk is not None \
                    and not node.current_chunk.done \
                    and (a := acc.get(id(node.current))) is not None:
                a[2][j] += node.current_chunk.size
        for k, node in enumerate(self.reducers):
            for h, sc, _ in node.queue:
                if not sc.done and (a := acc.get(id(h))) is not None:
                    a[5][k] += sc.size
            if node.current is not None and node.current_chunk is not None \
                    and not node.current_chunk.done \
                    and (a := acc.get(id(node.current))) is not None:
                a[5][k] += node.current_chunk.size

        jobs = []
        for g in self.runs:
            if not g.seeded:
                prog = dataclasses.replace(
                    JobProgress.fresh(g.p, job=g.idx), released=False,
                    map_alive=g.map_alive.copy(),
                    red_alive=g.red_alive.copy(),
                )
                jobs.append(prog)
                continue
            resid_push, committed_push, at_mapper, pool, \
                committed_shuffle, at_reducer = acc[id(g)]
            for j in range(nM):
                at_mapper[j] += sum(c.size for c in g.map_gated[j] if not c.done)
                pool[j] += sum(sc.size for _, sc in g.shuf_gated[j] if not sc.done)
            for k in range(nR):
                at_reducer[k] += sum(sc.size for sc in g.red_gated[k] if not sc.done)
            # a stage-linked run's unreleased sources: the upstream output
            # has not landed yet, so the re-planner sees the *modeled*
            # volume (the stage platform's derived D) as re-routable —
            # steering a not-yet-started stage is exactly a push re-route
            for i in g.dep_pending:
                resid_push[i] += max(float(g.p.D[i]), float(g.dep_landed[i]))
            prog = JobProgress(
                job=g.idx, released=True, done=False,
                resid_push=resid_push, committed_push=committed_push,
                at_mapper=at_mapper, shuffle_pool=pool,
                committed_shuffle=committed_shuffle, at_reducer=at_reducer,
                alpha=float(g.p.alpha), total_push_mb=float(g.p.D.sum()),
                map_alive=g.map_alive.copy(),
                red_alive=g.red_alive.copy(),
            )
            if prog.remaining_mb()["reduce"] <= 1e-9:
                prog = dataclasses.replace(prog, done=True)
            jobs.append(prog)
        backlog: Dict[str, float] = {}
        for row in self.push_links + self.shuf_links:
            for link in row:
                backlog[link.name] = sum(tr.size for tr in link.queue)
        for node in self.mappers + self.reducers:
            backlog[node.name] = sum(
                c.size for _, c, _ in node.queue if not c.done
            )
        return ProgressSnapshot(
            time=self.now, jobs=tuple(jobs), backlog=backlog
        )

    # -- online control plane: steer ---------------------------------------------
    def inject(self, jobs: Sequence["_JobEntry"]) -> List[int]:
        """Admit new jobs mid-flight (streaming arrival).  Jobs released at
        or before the current time seed immediately — *ahead* of any event
        already pending at this instant, matching the offline order where
        release seeds carry the earliest sequence numbers; future releases
        schedule normally.  Returns the new job indices."""
        self._start()
        entries = _normalize_entries(jobs)
        idxs: List[int] = []
        for platform, plan, cfg in entries:
            if not self.sub.compatible(Substrate.of(platform)):
                raise ValueError(
                    f"platform {platform.name!r} is not a view of substrate "
                    f"{self.sub.name!r} — build job platforms with "
                    "Substrate.view()"
                )
            g = _JobRun(len(self.runs), platform, plan, cfg,
                        self.sub.nM, self.sub.nR)
            self.runs.append(g)
            self._audit = self._audit or cfg.audit
            idxs.append(g.idx)
            # raw fail times, exactly as _start() schedules them offline —
            # a past time simply fires on the next dispatch (a worker that
            # died before this job arrived is already dead)
            self._schedule_job_failures(g)
            # substrate-wide kills that already fired apply immediately
            for j in self._dead_m:
                g.map_alive[j] = False
            for k in self._dead_r:
                g.red_alive[k] = False
        for start in sorted({self.runs[i].cfg.start_time for i in idxs}):
            group = tuple(
                i for i in idxs if self.runs[i].cfg.start_time == start
            )
            if start <= self.now:
                # merge with a pending release group at this exact instant:
                # offline, equal start times seed as ONE round-robin group
                # (earlier jobs first), and the equivalence must survive an
                # arrival landing on another job's release time
                pending: List[int] = []
                rest = []
                for ev in self._heap:
                    if ev[0] == start and ev[2] == "seed_jobs":
                        pending.extend(ev[3][0])
                    else:
                        rest.append(ev)
                if pending:
                    self._heap = rest
                    heapq.heapify(self._heap)
                self._ev_seed_jobs(tuple(pending) + group)
            else:
                self.at(start, "seed_jobs", group)
        return idxs

    def swap_plan(self, idx: int, plan: ExecutionPlan) -> None:
        """Replace job ``idx``'s plan for every chunk not yet committed.

        Un-started push transfers are pulled back and redistributed across
        mappers per the new ``x`` (largest-deficit-first, so discrete chunks
        track the continuous split); un-started shuffle transfers and gated
        emissions are pooled per mapper and re-split per the new ``y``.
        In-service transfers, delivered data and finished work are
        untouched — the swap only redirects the future.  Barrier gate
        counters move with the chunks, and gates that the moves leave
        satisfiable open immediately.  Future shuffle emissions (of not yet
        mapped chunks) follow the new ``y`` automatically.
        """
        g = self.runs[idx]
        if plan.x.shape != g.plan.x.shape or plan.y.shape != g.plan.y.shape:
            raise ValueError(
                f"plan shapes {plan.x.shape}/{plan.y.shape} do not match "
                f"job {idx}'s {g.plan.x.shape}/{g.plan.y.shape}"
            )
        self._start()
        if not g.seeded:
            g.plan = plan  # released later: seeding reads the new plan
            return
        nM, nR = self.sub.nM, self.sub.nR
        b0, b1, b2 = g.cfg.barriers
        x = np.asarray(plan.x)
        y = np.asarray(plan.y)

        # --- pull back un-started push transfers, re-split per the new x
        pulled: Dict[int, List[_Chunk]] = {}
        for i, row in enumerate(self.push_links):
            for link in row:
                kept = []
                for tr in link.queue:
                    if tr.run is g and tr.fn == "push_arrive":
                        pulled.setdefault(tr.args[1], []).append(tr.args[3])
                    else:
                        kept.append(tr)
                link.queue = kept
        drained_j = set()
        for i, chunks in pulled.items():
            total = sum(c.size for c in chunks)
            # a severed link parks everything queued on it until repair —
            # routing re-split mass there would pin the job to the repair
            # time, so only reachable mappers receive it
            up = np.array([not self.push_links[i][j].down
                           for j in range(nM)])
            desired = np.where(
                (x[i] > 1e-9) & g.map_alive & up, total * x[i], 0.0
            )
            if desired.sum() <= 0:  # new row dead/unreachable: spread alive
                desired = np.where(g.map_alive & up, total / max(nM, 1), 0.0)
            if desired.sum() <= 0:  # every path severed: park per plan
                desired = np.where(g.map_alive, total / max(nM, 1), 0.0)
            # assign inside the eligible set only — an excluded mapper's
            # zero deficit must never beat an over-assigned eligible one
            eligible = np.flatnonzero(desired > 0)
            if eligible.size == 0:  # every mapper dead: recovery will raise
                eligible = np.arange(nM)
            assigned = np.zeros(nM)
            for c in chunks:
                j_new = int(eligible[
                    np.argmax(desired[eligible] - assigned[eligible])
                ])
                assigned[j_new] += c.size
                j_old = c.owner
                if j_new != j_old:
                    g.push_inflight[j_old] -= 1
                    g.push_inflight[j_new] += 1
                    g.map_unfinished[j_old] -= 1
                    g.map_unfinished[j_new] += 1
                    c.owner = j_new
                    drained_j.add(j_old)
                self._link_send(self.push_links[i][j_new], g, c.size,
                                "push_arrive", (g, i, j_new, c))

        # --- pull back un-started / gated shuffle, re-split per the new y
        pool_sent = np.zeros(nM)
        pool_gated = np.zeros(nM)
        drained_k = set()
        for j, row in enumerate(self.shuf_links):
            for k, link in enumerate(row):
                kept = []
                for tr in link.queue:
                    if tr.run is g and tr.fn == "shuffle_arrive":
                        pool_sent[tr.args[1]] += tr.args[3].size
                        g.shuf_inflight[k] -= 1
                        g.total_shuf_inflight -= 1
                        g.reduce_outstanding[k] -= 1
                        drained_k.add(k)
                    else:
                        kept.append(tr)
                link.queue = kept
        for j in range(nM):
            if g.shuf_gated[j]:
                for k, sc in g.shuf_gated[j]:
                    pool_gated[j] += sc.size
                    g.shuf_inflight[k] -= 1
                    g.total_shuf_inflight -= 1
                    g.reduce_outstanding[k] -= 1
                    drained_k.add(k)
                g.shuf_gated[j].clear()

        g.plan = plan  # future emissions (un-mapped chunks) use the new y
        # the pulled-back pool is re-created below under the new y: net it
        # out of the conservation ledger so created == landed still holds
        g.shuf_created_mb -= float(pool_sent.sum() + pool_gated.sum())

        # a finalized reducer's output has already been handed to the
        # downstream stage sources — routing new volume there would be
        # silently dropped, so the re-split only spreads over open *live*
        # reducers (all of them, for failure-free runs without stage
        # children)
        open_r = (~g.reducer_final) & g.red_alive
        for j in range(nM):
            # mask reducers behind a severed link: queued mass routed there
            # would park until repair and pin the makespan to it (the plan
            # may carry harmless dust on degraded paths — the executor must
            # not turn that dust into a repair-time wait)
            up = np.array([not self.shuf_links[j][k].down
                           for k in range(nR)])
            reach = open_r & up if (open_r & up).any() else open_r
            for amount, gated in ((pool_sent[j], False), (pool_gated[j], True)):
                if amount <= 1e-9:
                    continue
                shares = np.where((y > 1e-9) & reach, amount * y, 0.0)
                if shares.sum() <= 0:
                    # all-final is impossible while shuffle volume is still
                    # pooled (finality requires zero outstanding chunks)
                    shares = np.where(reach, amount / max(reach.sum(), 1),
                                      0.0)
                shares *= amount / max(shares.sum(), 1e-12)
                for k in range(nR):
                    if shares[k] <= 1e-9:
                        continue
                    n = max(int(np.ceil(shares[k] / g.cfg.chunk_mb)), 1)
                    for _ in range(n):
                        sc = _Chunk(next(self._cid), shares[k] / n, j)
                        g.shuf_created_mb += sc.size
                        g.shuf_inflight[k] += 1
                        g.total_shuf_inflight += 1
                        g.reduce_outstanding[k] += 1
                        if gated:
                            g.shuf_gated[j].append((k, sc))
                        else:
                            self._send_shuffle(g, j, k, sc)

        # --- gates the moves left satisfiable open now (mirrors the
        # arrival/steal paths; totals are unchanged, so 'G' gates only need
        # re-checking where a bucket drained to zero).  A stage-linked run
        # with pending sources keeps its gates shut — the final release
        # re-checks them all.
        for j in (drained_j if not g.dep_pending else ()):
            if b0 == "L" and g.push_inflight[j] == 0:
                self._open_map_gate(g, j)
            node = self.mappers[j]
            if b1 == "L" and g.map_unfinished[j] == 0 \
                    and not (node.busy and node.current is g):
                self._open_shuffle_gate(g, j)
        if b2 == "L":
            for k in drained_k:
                if g.shuf_inflight[k] == 0 and self._shuffle_final(g):
                    self._open_reduce_gate(g, k)
        elif b2 == "G" and g.total_shuf_inflight == 0 \
                and self._shuffle_final(g) and drained_k:
            for k in range(nR):
                self._open_reduce_gate(g, k)

    def set_speculation(self, idx: int, on: bool,
                        threshold: Optional[float] = None) -> None:
        """Toggle speculative execution for job ``idx`` mid-flight — the
        fault-reaction knob an online policy can flip per decision (e.g.
        duplicate straggling map work once a failure has been observed).
        ``threshold`` optionally retunes ``spec_threshold`` at the same
        time.  Takes effect at the next idle-worker trigger; clones
        already racing are unaffected."""
        g = self.runs[idx]
        kw: Dict[str, object] = {"speculation": bool(on)}
        if threshold is not None:
            kw["spec_threshold"] = float(threshold)
        g.cfg = dataclasses.replace(g.cfg, **kw)

    # -- vectorized frozen-plan fast path ----------------------------------
    #
    # ``run()`` on an engine whose jobs all set ``SimConfig(vectorized=
    # True)`` bypasses the per-chunk heap entirely: every resource serves
    # FIFO, so its service times follow the Lindley recursion ``start =
    # max(prev_end, enqueue)`` and a whole queue replays in one tight scan
    # evaluating the *same* float expressions as the scalar pump (same
    # operand order, hence bit-identical results).  The freedom to commute
    # events is exactly what the determinism audit certifies: on race-free
    # scenarios any same-timestamp event reordering yields the same
    # trajectory, and the scan only ever commutes same-timestamp events —
    # orderings that carry semantics (seed round-robin, gated-release
    # order, per-resource FIFO, ledger accumulation order) are replicated
    # exactly.  Barrier gates are not counters here but closed-form times:
    # each gate opens at the last completion/arrival that could satisfy it
    # (the scalar engine's trigger event), max-ed with a stage-linked run's
    # final source release (the scalar ``_recheck_gates`` sweep).  Stage
    # DAGs process in topological strata; a geometry where a later stage
    # would enqueue *behind* already-served work on some resource raises
    # rather than silently mis-ordering.  ``run_online``-style steering
    # takes the same scans segment-by-segment via ``_vec_drain`` below,
    # which swaps the closed-form gates for post-segment counter checks
    # and materializes still-pending work back into scalar state at each
    # decision point.

    def _vec_serve(self, res, enq, tie, size, jobv, state, slow=None,
                   cut=None, inclusive=False):
        """Exact FIFO replay of one resource's whole queue.  ``enq`` /
        ``tie`` / ``size`` / ``jobv`` (plus per-entry ``slow`` for
        compute nodes) are parallel arrays already sorted by
        ``(enq, tie)``.  Completion times come from the Lindley
        recursion ``end = max(prev_end, enq) + size/rate`` evaluated as
        numpy left folds over busy segments — ``np.add.accumulate`` is a
        strict sequential fold, so every float lands bit-identical to
        the scalar pump.  ``state`` carries ``(avail, last_enq)`` across
        calls; an entry enqueued before already-served work means the
        single-scan FIFO assumption broke (cross-stage interleaving) and
        is a hard error.

        ``cut`` bounds a *steered* segment: only services that start
        strictly before ``cut`` (at-or-before with ``inclusive``) commit
        — left folds over a prefix equal the full fold's prefix, so the
        committed floats are exactly the unbounded replay's.  Returns
        ``(ends, n_committed)``; stats/state are updated over the
        committed prefix only, and ``ends`` is only meaningful there
        (the computation may stop early once starts pass the horizon).
        """
        avail, last_enq = state.get(res, (0.0, _NEG_INF))
        n = enq.shape[0]
        if enq[0] < last_enq:
            raise RuntimeError(
                f"vectorized executor: out-of-order enqueue on {res.name} "
                "(cross-stage interleaving); rerun with "
                'SimConfig(mode="event")'
            )
        trace = res.trace
        starts = np.empty(n)
        ends = np.empty(n)
        filled = n
        if trace is None:
            if slow is not None:
                durs = size / (res.rate / slow)
            else:
                durs = size / res.bw
            a = avail
            i = 0
            while i < n:
                e0 = enq[i]
                s0 = a if a > e0 else e0
                if cut is not None and s0 > cut:
                    # starts are non-decreasing: nothing from here on can
                    # commit, so the replay may stop
                    filled = i
                    break
                # fold the busy run from s0; the first later entry that
                # enqueues at-or-after the running end starts a fresh
                # (idle-gap) segment.  Blocked so a pathological
                # all-gaps queue stays O(n).
                hi = i + 8192
                if hi > n:
                    hi = n
                seg = np.add.accumulate(
                    np.concatenate(([s0], durs[i:hi])))[1:]
                brk = np.flatnonzero(enq[i + 1:hi] >= seg[:-1])
                k = i + 1 + int(brk[0]) if brk.size else hi
                m = k - i
                starts[i] = s0
                if m > 1:
                    starts[i + 1:k] = seg[:m - 1]
                ends[i:k] = seg[:m]
                a = float(seg[m - 1])
                i = k
        else:
            # trace-modulated rate depends on each service's start time
            # -> exact sequential replay (trace scenarios are small)
            durs = np.empty(n)
            a = avail
            if slow is not None:
                for i in range(n):
                    e0 = enq[i]
                    s = a if a > e0 else e0
                    if cut is not None and s > cut:
                        filled = i
                        break
                    d = size[i] / (trace.at(s) / slow[i])
                    a = s + d
                    durs[i] = d
                    starts[i] = s
                    ends[i] = a
            else:
                for i in range(n):
                    e0 = enq[i]
                    s = a if a > e0 else e0
                    if cut is not None and s > cut:
                        filled = i
                        break
                    d = size[i] / trace.at(s)
                    a = s + d
                    durs[i] = d
                    starts[i] = s
                    ends[i] = a
            a = float(a)
        if cut is None:
            n_c = n
        else:
            side = "right" if inclusive else "left"
            n_c = int(np.searchsorted(starts[:filled], cut, side=side))
            if n_c == 0:
                return ends, 0
        st = res.stats
        st.busy_s = float(np.add.accumulate(
            np.concatenate(([st.busy_s], durs[:n_c])))[-1])
        st.waited_s = float(np.add.accumulate(
            np.concatenate(([st.waited_s], starts[:n_c] - enq[:n_c])))[-1])
        st.volume_mb = float(np.add.accumulate(
            np.concatenate(([st.volume_mb], size[:n_c])))[-1])
        st.n_chunks += n_c
        st.jobs.update(int(v) for v in np.unique(jobv[:n_c]))
        s0f = float(starts[0])
        if s0f < st.first_busy_s:
            st.first_busy_s = s0f
        ef = float(ends[n_c - 1])
        if ef > st.last_busy_s:
            st.last_busy_s = ef
        state[res] = (float(ends[n_c - 1]), float(enq[n_c - 1]))
        return ends, n_c

    def _vec_check_support(self):
        if self.sub.failures:
            raise ValueError(
                "vectorized executor: the substrate carries a "
                "FailureTrace — failure recovery needs the scalar event "
                'loop (SimConfig(mode="event"))'
            )
        for g in self.runs:
            c = g.cfg
            bad = [name for name, flag in (
                ("speculation", c.speculation),
                ("stealing", c.stealing),
                ("failures", bool(c.failures)),
                ("compute_noise", c.compute_noise > 0),
                ("replication>1", c.replication != 1),
            ) if flag]
            if bad:
                raise ValueError(
                    f"vectorized executor: job {g.idx} uses "
                    f"{'/'.join(bad)} — dynamics need the scalar event "
                    'loop (SimConfig(mode="event"))'
                )

    @staticmethod
    def _vec_by_job(jobarr, nJ):
        """Group an already time-sorted event column by job: returns
        ``(jsort, off)`` where ``jsort[off[g]:off[g+1]]`` indexes job
        ``g``'s events in time order (stable sort preserves it)."""
        jsort = np.argsort(jobarr, kind="stable")
        counts = np.bincount(jobarr, minlength=nJ)
        off = np.concatenate(([0], np.cumsum(counts)))
        return jsort, off

    @staticmethod
    def _vec_fold(base, arr):
        """Exact sequential left fold ``base + arr[0] + arr[1] + ...``
        — the order the scalar ledgers accumulate in."""
        return float(np.add.accumulate(np.concatenate(([base], arr)))[-1])

    def _run_vectorized(self) -> ScheduleSimResult:
        self._vec_check_support()
        runs = self.runs
        self._started = True
        nM, nR = self.sub.nM, self.sub.nR
        nJ = len(runs)
        NEG = _NEG_INF

        # topological strata of the stage DAG (roots = stratum 0)
        depth: Dict[int, int] = {}

        def _depth(i: int) -> int:
            d = depth.get(i)
            if d is None:
                d = 1 + max(
                    (_depth(p) for p in runs[i].stage_deps), default=-1
                )
                depth[i] = d
            return d

        for i in range(nJ):
            _depth(i)
        waves: List[List[_JobRun]] = [
            [] for _ in range(max(depth.values()) + 1)
        ]
        for i in range(nJ):
            waves[depth[i]].append(runs[i])

        root_ops = {
            g.idx: self._push_ops(g) for g in runs if not g.stage_deps
        }
        for g in runs:
            if self.stage_children.get(g.idx) and not g.stage_deps \
                    and not root_ops[g.idx]:
                raise ValueError(
                    f"vectorized executor: root job {g.idx} feeds "
                    "downstream stages but seeds no push chunks — its "
                    "reducers never finalize and the pipeline starves; "
                    'run with SimConfig(mode="event")'
                )

        # static per-job tables for the hot gathers
        alpha_j = np.array([g.p.alpha for g in runs], dtype=np.float64)
        slow_m = np.array(
            [[g.slowdown("m", j) for j in range(nM)] for g in runs])
        slow_r = np.array(
            [[g.slowdown("r", k) for k in range(nR)] for g in runs])
        ynz = [
            [(k, g.plan.y[k]) for k in range(nR) if g.plan.y[k] > 0.0]
            for g in runs
        ]
        fan = np.array([len(z) for z in ynz], dtype=np.int64)
        maxf = max(int(fan.max()), 1) if nJ else 1
        ynz_k = np.zeros((nJ, maxf), dtype=np.int64)
        ynz_y = np.zeros((nJ, maxf))
        for gi, z in enumerate(ynz):
            for s, (k, yk) in enumerate(z):
                ynz_k[gi, s] = k
                ynz_y[gi, s] = yk

        # closed-form gate trackers: last arrival / completion per
        # (job, location) and per job — each barrier gate opens at the
        # scalar engine's trigger event, which is exactly such a max
        arrj = np.full((nJ, nM), NEG)
        arr_any = np.full(nJ, NEG)
        compj = np.full((nJ, nM), NEG)
        comp_any = np.full(nJ, NEG)
        sarrk = np.full((nJ, nR), NEG)
        sarr_any = np.full(nJ, NEG)
        redk = np.full((nJ, nR), NEG)
        rel = np.full(nJ, NEG)

        state: Dict[object, Tuple[float, float]] = {}
        #: child idx -> [(t_finalize, parent idx, reducer k, landed MB)]
        child_contrib: Dict[int, List[Tuple[float, int, int, float]]] = {}
        t_max = 0.0
        gen = 0

        for wave in waves:
            # ---- push streams: root seeds + stage-source releases --------
            link_ents: Dict[Tuple[int, int], list] = {}
            roots = [g for g in wave if not g.stage_deps]
            for start in sorted({g.cfg.start_time for g in roots}):
                group = [(g, root_ops[g.idx])
                         for g in roots if g.cfg.start_time == start]
                for g, _ in group:
                    g.seeded = True
                r = 0
                live = True
                while live:  # round-robin, exactly like _ev_seed_jobs
                    live = False
                    for g, ops in group:
                        if r < len(ops):
                            live = True
                            i, j, size = ops[r]
                            g.total_map_chunks += 1
                            g.pushed_mb += size
                            link_ents.setdefault((i, j), []).append(
                                (start, gen, float(size), g.idx))
                            gen += 1
                    r += 1

            rels: List[Tuple[float, int, int]] = []
            for g in wave:
                if not g.stage_deps:
                    continue
                for t_fin, p, k, mb in sorted(
                        child_contrib.pop(g.idx, [])):
                    g.dep_landed[k] += mb
                    waiting = g.dep_pending.get(k)
                    if waiting is None or p not in waiting:
                        continue
                    waiting.discard(p)
                    if not waiting:
                        del g.dep_pending[k]
                        rels.append((t_fin, g.idx, k))
                if g.dep_pending:
                    raise RuntimeError(
                        f"vectorized executor: stage job {g.idx} never "
                        "fully releases (an upstream reducer deadlocked); "
                        'rerun with SimConfig(mode="event")'
                    )
            rels.sort()
            for rel_t, gi, k in rels:
                g = runs[gi]
                g.seeded = True
                if rel_t > rel[gi]:
                    rel[gi] = rel_t
                amount = float(g.dep_landed[k])
                if amount <= 1e-9:
                    continue
                cfg = g.cfg
                xrow = g.plan.x[k]
                for j in range(nM):
                    share = amount * xrow[j]
                    if share <= 1e-9:
                        continue
                    n_chunks = max(int(np.ceil(share / cfg.chunk_mb)), 1)
                    sz = share / n_chunks
                    fsz = float(sz)
                    for _ in range(n_chunks):
                        g.total_map_chunks += 1
                        g.pushed_mb += sz
                        link_ents.setdefault((k, j), []).append(
                            (rel_t, gen, fsz, gi))
                        gen += 1

            # ---- serve push links; arrivals in global event order --------
            cols = ([], [], [], [], [])  # end, tie, size, job, dest
            push_links = self.push_links
            for (i, j), ents in sorted(link_ents.items()):
                raw = list(zip(*ents))
                enq = np.asarray(raw[0], dtype=np.float64)
                tie = np.asarray(raw[1], dtype=np.int64)
                sz = np.asarray(raw[2], dtype=np.float64)
                jb = np.asarray(raw[3], dtype=np.int64)
                o = np.lexsort((tie, enq))
                enq, tie, sz, jb = enq[o], tie[o], sz[o], jb[o]
                ends, _ = self._vec_serve(
                    push_links[i][j], enq, tie, sz, jb, state)
                cols[0].append(ends)
                cols[1].append(tie)
                cols[2].append(sz)
                cols[3].append(jb)
                cols[4].append(np.full(ends.shape[0], j, dtype=np.int64))

            n_arr = 0
            if cols[0]:
                at, atie, asz, ajob, adst = map(np.concatenate, cols)
                o = np.lexsort((atie, at))
                at, atie, asz = at[o], atie[o], asz[o]
                ajob, adst = ajob[o], adst[o]
                n_arr = at.shape[0]
            if n_arr:
                t_max = max(t_max, float(at[-1]))
                # last write wins on duplicate indices and the arrays are
                # time-sorted, so plain fancy assignment IS the running
                # "latest arrival" ledger
                arrj[ajob, adst] = at
                arr_any[ajob] = at
                jsort, off = self._vec_by_job(ajob, nJ)
                aready = at.copy()
                for g in wave:
                    gi = g.idx
                    sel = jsort[off[gi]:off[gi + 1]]
                    if not sel.shape[0]:
                        continue
                    m = float(at[sel[-1]])
                    if m > g.push_end:
                        g.push_end = m
                    g.landed_mb = self._vec_fold(g.landed_mb, asz[sel])
                    b0 = g.cfg.barriers[0]
                    if b0 == "P":
                        continue
                    rv = arrj[gi, adst[sel]] if b0 == "L" else arr_any[gi]
                    aready[sel] = np.maximum(rv, rel[gi])

                # gated chunks flush to the node queue in *arrival*
                # order, so the tie key is the position in the
                # time-sorted arrival stream
                seqv = np.arange(n_arr, dtype=np.int64)
                morder = np.lexsort((seqv, aready, adst))
                noff = np.concatenate(
                    ([0], np.cumsum(np.bincount(adst, minlength=nM))))
                cols = ([], [], [], [], [])
                mappers = self.mappers
                for j in range(nM):
                    sel = morder[noff[j]:noff[j + 1]]
                    if not sel.shape[0]:
                        continue
                    jb = ajob[sel]
                    ends, _ = self._vec_serve(
                        mappers[j], aready[sel], seqv[sel], asz[sel], jb,
                        state, slow=slow_m[jb, j])
                    cols[0].append(ends)
                    cols[1].append(seqv[sel])
                    cols[2].append(asz[sel])
                    cols[3].append(jb)
                    cols[4].append(
                        np.full(ends.shape[0], j, dtype=np.int64))
                ct, ctie, csz, cjob, cdst = map(np.concatenate, cols)
                o = np.lexsort((ctie, ct))
                ct, ctie, csz = ct[o], ctie[o], csz[o]
                cjob, cdst = cjob[o], cdst[o]
                n_comp = ct.shape[0]

                t_max = max(t_max, float(ct[-1]))
                compj[cjob, cdst] = ct
                comp_any[cjob] = ct
                jsort, off = self._vec_by_job(cjob, nJ)
                cready = ct.copy()
                for g in wave:
                    gi = g.idx
                    sel = jsort[off[gi]:off[gi + 1]]
                    if not sel.shape[0]:
                        continue
                    m = float(ct[sel[-1]])
                    if m > g.map_end:
                        g.map_end = m
                    g.mapped_mb = self._vec_fold(g.mapped_mb, csz[sel])
                    b1 = g.cfg.barriers[1]
                    if b1 == "P":
                        continue
                    rv = compj[gi, cdst[sel]] if b1 == "L" \
                        else comp_any[gi]
                    cready[sel] = np.maximum(rv, rel[gi])
            else:
                n_comp = 0

            # ---- shuffle emissions: completion-major, reducer-minor,
            # exactly _emit_shuffle's creation order ----------------------
            n_em = 0
            if n_comp:
                counts = fan[cjob]
                tot = int(counts.sum())
                if tot:
                    off_e = np.concatenate(([0], np.cumsum(counts)))
                    repi = np.repeat(np.arange(n_comp), counts)
                    slot = np.arange(tot, dtype=np.int64) - off_e[repi]
                    ejob = cjob[repi]
                    ek = ynz_k[ejob, slot]
                    a_s = alpha_j[ejob] * csz[repi]
                    amt = a_s * ynz_y[ejob, slot]
                    keep = amt > 1e-9
                    eenq = cready[repi][keep]
                    ejob, ek, amt = ejob[keep], ek[keep], amt[keep]
                    ejv = cdst[repi][keep]
                    n_em = amt.shape[0]
            if n_em:
                etie = gen + np.arange(n_em, dtype=np.int64)
                gen += n_em
                jsort, off = self._vec_by_job(ejob, nJ)
                for g in wave:
                    sel = jsort[off[g.idx]:off[g.idx + 1]]
                    if sel.shape[0]:
                        g.shuf_created_mb = self._vec_fold(
                            g.shuf_created_mb, amt[sel])

                # ---- serve shuffle links ---------------------------------
                lkey = ejv * nR + ek
                lorder = np.lexsort((etie, eenq, lkey))
                lcounts = np.bincount(lkey, minlength=nM * nR)
                loff = np.concatenate(([0], np.cumsum(lcounts)))
                cols = ([], [], [], [], [])
                shuf_links = self.shuf_links
                for key in np.flatnonzero(lcounts):
                    j, k = divmod(int(key), nR)
                    sel = lorder[loff[key]:loff[key + 1]]
                    ends, _ = self._vec_serve(
                        shuf_links[j][k], eenq[sel], etie[sel], amt[sel],
                        ejob[sel], state)
                    cols[0].append(ends)
                    cols[1].append(etie[sel])
                    cols[2].append(amt[sel])
                    cols[3].append(ejob[sel])
                    cols[4].append(
                        np.full(ends.shape[0], k, dtype=np.int64))
                st_, stie, samt, sjob, sk = map(np.concatenate, cols)
                o = np.lexsort((stie, st_))
                st_, stie, samt = st_[o], stie[o], samt[o]
                sjob, sk = sjob[o], sk[o]
                n_sarr = st_.shape[0]

                t_max = max(t_max, float(st_[-1]))
                sarrk[sjob, sk] = st_
                sarr_any[sjob] = st_
                jsort, off = self._vec_by_job(sjob, nJ)
                sready = st_.copy()
                drop = np.zeros(n_sarr, dtype=bool)
                for g in wave:
                    gi = g.idx
                    sel = jsort[off[gi]:off[gi + 1]]
                    if not sel.shape[0]:
                        continue
                    m = float(st_[sel[-1]])
                    if m > g.shuffle_end:
                        g.shuffle_end = m
                    g.shuf_landed_mb = self._vec_fold(
                        g.shuf_landed_mb, samt[sel])
                    b2 = g.cfg.barriers[2]
                    if b2 == "P":
                        continue
                    rv = sarrk[gi, sk[sel]] if b2 == "L" \
                        else sarr_any[gi]
                    rv = np.maximum(rv, rel[gi])
                    sready[sel] = rv
                    # the gate's trigger arrival fired while map work was
                    # still outstanding and nothing re-checks it: the
                    # scalar engine leaves these chunks gated forever, so
                    # we drop them identically
                    drop[sel] = rv < comp_any[gi]

                keep = ~drop
                seqr = np.arange(n_sarr, dtype=np.int64)[keep]
                sready, samt = sready[keep], samt[keep]
                sjob, sk = sjob[keep], sk[keep]

                cols = ([], [], [], [], [])
                if sready.shape[0]:
                    korder = np.lexsort((seqr, sready, sk))
                    koff = np.concatenate(
                        ([0], np.cumsum(np.bincount(sk, minlength=nR))))
                    reducers = self.reducers
                    for k in range(nR):
                        sel = korder[koff[k]:koff[k + 1]]
                        if not sel.shape[0]:
                            continue
                        jb = sjob[sel]
                        ends, _ = self._vec_serve(
                            reducers[k], sready[sel], seqr[sel],
                            samt[sel], jb, state, slow=slow_r[jb, k])
                        cols[0].append(ends)
                        cols[1].append(seqr[sel])
                        cols[2].append(samt[sel])
                        cols[3].append(jb)
                        cols[4].append(
                            np.full(ends.shape[0], k, dtype=np.int64))
                if cols[0]:
                    rt, rtie, ramt, rjob, rk = map(np.concatenate, cols)
                    o = np.lexsort((rtie, rt))
                    rt, ramt = rt[o], ramt[o]
                    rjob, rk = rjob[o], rk[o]

                    t_max = max(t_max, float(rt[-1]))
                    redk[rjob, rk] = rt
                    jsort, off = self._vec_by_job(rjob, nJ)
                    for g in wave:
                        gi = g.idx
                        sel = jsort[off[gi]:off[gi + 1]]
                        if not sel.shape[0]:
                            continue
                        m = float(rt[sel[-1]])
                        if m > g.reduce_end:
                            g.reduce_end = m
                        g.reduced_mb = self._vec_fold(
                            g.reduced_mb, ramt[sel])
                        kv = rk[sel]
                        for k in np.unique(kv):
                            ks = sel[kv == k]
                            g.delivered_out[k] = self._vec_fold(
                                float(g.delivered_out[k]), ramt[ks])

            # ---- finalize stage parents: reducer k's output is complete
            # at max(last global map completion, last reduce at k) — the
            # first event where _maybe_finalize_stage sees it closed ------
            for g in wave:
                children = self.stage_children.get(g.idx)
                if not children:
                    continue
                gi = g.idx
                anchor = comp_any[gi]
                if anchor == NEG:
                    anchor = rel[gi]
                if anchor == NEG:
                    raise RuntimeError(
                        f"vectorized executor: stage parent {gi} produced "
                        "no anchor event; rerun with "
                        'SimConfig(mode="event")'
                    )
                anchor = float(anchor)
                for k in range(nR):
                    t_fin = anchor
                    lr = float(redk[gi, k])
                    if lr > t_fin:
                        t_fin = lr
                    g.reducer_final[k] = True
                    mb = float(g.delivered_out[k])
                    for c in children:
                        child = runs[c]
                        child_contrib.setdefault(c, []).append(
                            (t_fin, gi, k, child.stage_scale[gi] * mb))
                    t_max = max(t_max, t_fin)

        self.now = max(self.now, t_max)
        if self._audit:
            self._audit_final()
        return self.result()

    # -- vectorized steered drains -----------------------------------------
    #
    # ``run_until``/``run`` on a *started* engine drain each segment
    # between decision points through the same batched per-resource scans
    # as ``_run_vectorized`` whenever the pending events and every job's
    # dynamics stay inside the vectorized vocabulary.  Services that start
    # before the horizon commit (prefix of the same Lindley fold — same
    # floats as the unbounded replay); everything else materializes back
    # into scalar state, so ``snapshot``/``swap_plan``/``inject`` and
    # scalar fallback segments see exactly what the scalar loop would
    # have built.

    _VEC_STEER_EVENTS = frozenset(
        {"seed_jobs", "link_done", "map_done", "reduce_done"})

    def _vec_steer_eligible(self) -> bool:
        """True when a steered segment can take the batched scans —
        otherwise the caller silently falls back to the scalar loop (both
        paths are byte-identical on race-free scenarios, so segments may
        mix freely as dynamics toggle mid-run)."""
        if not self.runs or self.sub.failures or self.stage_children:
            return False
        if self._dead_m or self._dead_r:
            return False
        for g in self.runs:
            c = g.cfg
            if c.mode != "event_vec" or g.stage_deps:
                return False
            if (c.speculation or c.stealing or c.failures
                    or c.compute_noise > 0 or c.replication != 1):
                return False
        return all(ev[2] in self._VEC_STEER_EVENTS for ev in self._heap)

    def _vec_drain(self, cut, inclusive=False):
        """Drain one steered segment (events before ``cut``; everything
        when ``cut`` is None) through the vectorized per-resource scans.

        The segment replays exactly like :meth:`_run_vectorized` — same
        entry ordering, same Lindley folds, same ledger fold order — with
        three twists that make it safe between decision points:

        * pending heap events fold in: completions that *happen* join
          their tier's stream (their resource resumes from them), while
          completions at-or-past the horizon pin their resource busy for
          the whole segment;
        * barrier gates resolve by *post-segment counters* (the scalar
          trigger condition) instead of closed-form final times — a gate
          whose counter has not drained keeps its chunks gated, to be
          revisited next segment;
        * work still pending at the horizon materializes back into
          scalar state: queues, gated lists, in-service transfer/chunk
          objects and their heap completion events.
        """
        runs = self.runs
        nM, nR = self.sub.nM, self.sub.nR
        nJ = len(runs)
        NEG = _NEG_INF

        def happens(t):
            return cut is None or t < cut or (inclusive and t == cut)

        fire = [ev for ev in self._heap if happens(ev[0])]
        if not fire:
            return
        fire.sort()
        keep = [ev for ev in self._heap if not happens(ev[0])]
        heapq.heapify(keep)
        self._heap = keep

        BTIE = -(1 << 60)  # boundary completions: first among stream ties
        CTIE = -(1 << 40)  # carried queue entries: first in FIFO order
        GTIE = -(1 << 20)  # carried gated flushes: after queues, pre fresh
        gen = 0
        gctr = 0
        t_max = self.now
        state: Dict[object, Tuple[float, float]] = {}
        freed: Dict[object, float] = {}
        if self._vec_slow is None or self._vec_slow[0].shape[0] != nJ:
            self._vec_slow = (
                np.array([[g.slowdown("m", j) for j in range(nM)]
                          for g in runs]),
                np.array([[g.slowdown("r", k) for k in range(nR)]
                          for g in runs]),
            )
        slow_m, slow_r = self._vec_slow

        def _cat(lst, dtype=np.float64):
            if not lst:
                return np.empty(0, dtype=dtype)
            return np.concatenate(lst)

        def _mat_tr(enq, sz_, jb_, obj, fn, src, loc):
            if obj is not None:
                return obj
            g = runs[int(jb_)]
            if fn == "push_arrive":
                c = _Chunk(next(self._cid), float(sz_), src, owner=loc)
            else:
                c = _Chunk(next(self._cid), float(sz_), src)
            return _Transfer(g, float(sz_), fn, (g, src, loc, c),
                             float(enq))

        def _mat_chunk(sz_, jb_, obj, src_, tier, loc):
            if obj is not None:
                return obj
            if tier == "m":
                c = _Chunk(next(self._cid), float(sz_), int(src_),
                           owner=loc)
                c.landed = True
            else:
                c = _Chunk(next(self._cid), float(sz_), int(src_))
            return c

        def serve_link(link, ready, tie, sz, jb, objs, fn, src, loc, out):
            """Serve one link's segment queue; committed arrivals append
            to the tier stream ``out``, the rest materializes."""
            n = ready.shape[0]
            if n:
                o = np.lexsort((tie, ready))
                ready, tie, sz, jb = ready[o], tie[o], sz[o], jb[o]
                objs = objs[o]
            if link.busy:
                # in flight past the horizon: nothing can start here
                link.queue.extend(
                    _mat_tr(ready[i], sz[i], jb[i], objs[i], fn, src, loc)
                    for i in range(n))
                return
            nq = len(link.queue)
            if nq:
                qr = np.array([tr.enqueued for tr in link.queue])
                qt = CTIE + np.arange(nq, dtype=np.int64)
                qs = np.array([tr.size for tr in link.queue])
                qj = np.array([tr.run.idx for tr in link.queue],
                              dtype=np.int64)
                qo = np.empty(nq, dtype=object)
                qo[:] = link.queue
                ready = np.concatenate((qr, ready))
                tie = np.concatenate((qt, tie))
                sz = np.concatenate((qs, sz))
                jb = np.concatenate((qj, jb))
                objs = np.concatenate((qo, objs))
                o = np.lexsort((tie, ready))
                ready, tie, sz, jb = ready[o], tie[o], sz[o], jb[o]
                objs = objs[o]
                n += nq
            if not n:
                return
            state[link] = (freed.get(link, 0.0), NEG)
            ends, n_c = self._vec_serve(link, ready, tie, sz, jb, state,
                                        cut=cut, inclusive=inclusive)
            n_fin = n_c
            if n_c:
                link.serial += n_c
                last = float(ends[n_c - 1])
                if not happens(last):
                    n_fin = n_c - 1
                    i = n_c - 1
                    tr = _mat_tr(ready[i], sz[i], jb[i], objs[i], fn,
                                 src, loc)
                    link.busy = True
                    link.current = tr
                    self.at(last, "link_done", link, tr, link.serial)
            if n_fin:
                chunks = np.empty(n_fin, dtype=object)
                chunks[:] = [o_.args[3] if o_ is not None else None
                             for o_ in objs[:n_fin]]
                out[0].append(ends[:n_fin].copy())
                out[1].append(tie[:n_fin])
                out[2].append(sz[:n_fin])
                out[3].append(jb[:n_fin])
                out[4].append(chunks)
                out[5].append(np.full(n_fin, src, dtype=np.int64))
                out[6].append(np.full(n_fin, loc, dtype=np.int64))
            link.queue = [
                _mat_tr(ready[i], sz[i], jb[i], objs[i], fn, src, loc)
                for i in range(n_c, n)]

        def serve_node(node, ready, tie, sz, jb, objs, srcs, slow_tab,
                       tier, loc, fn, out):
            """Serve one compute node's segment queue; committed
            completions append to ``out``, the rest materializes."""
            n = ready.shape[0]
            if n:
                o = np.lexsort((tie, ready))
                ready, tie, sz, jb = ready[o], tie[o], sz[o], jb[o]
                objs, srcs = objs[o], srcs[o]
            if node.busy:
                node.queue.extend(
                    (runs[int(jb[i])],
                     _mat_chunk(sz[i], jb[i], objs[i], srcs[i], tier, loc),
                     float(ready[i]))
                    for i in range(n))
                return
            nq = len(node.queue)
            if nq:
                qr = np.array([t for (_g, _c, t) in node.queue])
                qt = CTIE + np.arange(nq, dtype=np.int64)
                qs = np.array([c.size for (_g, c, _t) in node.queue])
                qj = np.array([g_.idx for (g_, _c, _t) in node.queue],
                              dtype=np.int64)
                qo = np.empty(nq, dtype=object)
                qo[:] = [c for (_g, c, _t) in node.queue]
                qsrc = np.array([c.src for (_g, c, _t) in node.queue],
                                dtype=np.int64)
                ready = np.concatenate((qr, ready))
                tie = np.concatenate((qt, tie))
                sz = np.concatenate((qs, sz))
                jb = np.concatenate((qj, jb))
                objs = np.concatenate((qo, objs))
                srcs = np.concatenate((qsrc, srcs))
                o = np.lexsort((tie, ready))
                ready, tie, sz, jb = ready[o], tie[o], sz[o], jb[o]
                objs, srcs = objs[o], srcs[o]
                n += nq
            if not n:
                return
            state[node] = (freed.get(node, 0.0), NEG)
            ends, n_c = self._vec_serve(
                node, ready, tie, sz, jb, state, slow=slow_tab[jb, loc],
                cut=cut, inclusive=inclusive)
            n_fin = n_c
            if n_c:
                last = float(ends[n_c - 1])
                if not happens(last):
                    n_fin = n_c - 1
                    i = n_c - 1
                    c = _mat_chunk(sz[i], jb[i], objs[i], srcs[i], tier,
                                   loc)
                    c.started_copies += 1
                    node.busy = True
                    node.current = runs[int(jb[i])]
                    node.current_chunk = c
                    self.at(last, fn, runs[int(jb[i])], loc, c)
            if n_fin:
                for o_ in objs[:n_fin]:
                    if o_ is not None:
                        o_.done = True
                out[0].append(ends[:n_fin].copy())
                out[1].append(tie[:n_fin])
                out[2].append(sz[:n_fin])
                out[3].append(jb[:n_fin])
                out[4].append(srcs[:n_fin])
                out[5].append(np.full(n_fin, loc, dtype=np.int64))
            node.queue = [
                (runs[int(jb[i])],
                 _mat_chunk(sz[i], jb[i], objs[i], srcs[i], tier, loc),
                 float(ready[i]))
                for i in range(n_c, n)]

        # ---- pass 1: boundary events + seeds -----------------------------
        arr_b: list = []   # (t, tie, size, jobi, chunk, src i, dest j)
        comp_b: list = []  # (t, tie, size, jobi, src i, mapper j)
        sarr_b: list = []  # (t, tie, size, jobi, chunk, src j, reducer k)
        red_b: list = []   # (t, tie, size, jobi, src j, reducer k)
        link_fresh: Dict[Tuple[int, int], list] = {}
        sh_keys: set = set()
        freed_mj: list = []
        freed_rk: list = []
        seed_evs: list = []
        for pos, (t, _s, fn, args) in enumerate(fire):
            tie = BTIE + pos
            if fn == "seed_jobs":
                seed_evs.append((t, args[0]))
                continue
            if t > t_max:
                t_max = t
            if fn == "link_done":
                link, tr = args[0], args[1]
                freed[link] = t
                link.busy = False
                link.current = None
                g, src, loc, c = tr.args
                if tr.fn == "push_arrive":
                    arr_b.append((t, tie, tr.size, g.idx, c, src, loc))
                    link_fresh.setdefault((src, loc), [])
                else:
                    sarr_b.append((t, tie, tr.size, g.idx, c, src, loc))
                    sh_keys.add((src, loc))
            elif fn == "map_done":
                g, j, c = args
                node = self.mappers[j]
                freed[node] = t
                node.busy = False
                node.current = None
                node.current_chunk = None
                c.done = True
                comp_b.append((t, tie, c.size, g.idx, c.src, j))
                freed_mj.append(j)
            else:  # reduce_done
                g, k, sc = args
                node = self.reducers[k]
                freed[node] = t
                node.busy = False
                node.current = None
                node.current_chunk = None
                sc.done = True
                red_b.append((t, tie, sc.size, g.idx, sc.src, k))
                freed_rk.append(k)

        # seeds: round-robin interleave exactly like _ev_seed_jobs
        for t_seed, idxs in seed_evs:
            if t_seed > t_max:
                t_max = t_seed
            pending = [(runs[i], self._push_ops(runs[i])) for i in idxs]
            for i in idxs:
                runs[i].seeded = True
            sizes: Dict[int, list] = {i: [] for i in idxs}
            cursors = [0] * len(pending)
            live = True
            while live:
                live = False
                for slot, (g, ops) in enumerate(pending):
                    if cursors[slot] >= len(ops):
                        continue
                    live = True
                    i, j, size = ops[cursors[slot]]
                    cursors[slot] += 1
                    link_fresh.setdefault((i, j), []).append(
                        (t_seed, gen, float(size), g.idx))
                    gen += 1
                    sizes[g.idx].append(size)
                    g.push_inflight[j] += 1
                    g.map_unfinished[j] += 1
            for i in idxs:
                g = runs[i]
                ss = sizes[i]
                if ss:
                    g.pushed_mb = self._vec_fold(
                        g.pushed_mb, np.asarray(ss, dtype=np.float64))
                g.total_map_chunks += len(ss)
                g.total_push_inflight += len(ss)
                g.total_map_unfinished += len(ss)

        # ---- pass 2: push links → arrival stream -------------------------
        arr_p: Tuple[list, ...] = ([], [], [], [], [], [], [])
        if arr_b:
            cols = list(zip(*arr_b))
            arr_p[0].append(np.asarray(cols[0], dtype=np.float64))
            arr_p[1].append(np.asarray(cols[1], dtype=np.int64))
            arr_p[2].append(np.asarray(cols[2], dtype=np.float64))
            arr_p[3].append(np.asarray(cols[3], dtype=np.int64))
            bo = np.empty(len(arr_b), dtype=object)
            bo[:] = cols[4]
            arr_p[4].append(bo)
            arr_p[5].append(np.asarray(cols[5], dtype=np.int64))
            arr_p[6].append(np.asarray(cols[6], dtype=np.int64))
        for (i, j), fresh in sorted(link_fresh.items()):
            if fresh:
                fc = list(zip(*fresh))
                f_enq = np.asarray(fc[0], dtype=np.float64)
                f_tie = np.asarray(fc[1], dtype=np.int64)
                f_sz = np.asarray(fc[2], dtype=np.float64)
                f_jb = np.asarray(fc[3], dtype=np.int64)
                f_obj = np.empty(len(fresh), dtype=object)
            else:
                f_enq = np.empty(0)
                f_tie = np.empty(0, dtype=np.int64)
                f_sz = np.empty(0)
                f_jb = np.empty(0, dtype=np.int64)
                f_obj = np.empty(0, dtype=object)
            serve_link(self.push_links[i][j], f_enq, f_tie, f_sz, f_jb,
                       f_obj, "push_arrive", i, j, arr_p)

        # ---- pass 3: arrivals → push/map barrier gates -------------------
        EMPTYF = np.empty(0)
        EMPTYI = np.empty(0, dtype=np.int64)
        EMPTYO = np.empty(0, dtype=object)
        n_arr = sum(a.shape[0] for a in arr_p[0])
        flushm: Dict[int, list] = {}
        if n_arr:
            at = _cat(arr_p[0])
            atie = _cat(arr_p[1], np.int64)
            asz = _cat(arr_p[2])
            ajob = _cat(arr_p[3], np.int64)
            aobj = _cat(arr_p[4], object)
            asrc = _cat(arr_p[5], np.int64)
            adst = _cat(arr_p[6], np.int64)
            o = np.lexsort((atie, at))
            at, atie, asz, ajob = at[o], atie[o], asz[o], ajob[o]
            aobj, asrc, adst = aobj[o], asrc[o], adst[o]
            if float(at[-1]) > t_max:
                t_max = float(at[-1])
            for ob in aobj:
                if ob is not None:
                    ob.landed = True
            arrj = np.full((nJ, nM), NEG)
            arr_any = np.full(nJ, NEG)
            arrj[ajob, adst] = at
            arr_any[ajob] = at
            seqv = np.arange(n_arr, dtype=np.int64)
            aready = at.copy()
            agated = np.zeros(n_arr, dtype=bool)
            jsort, off = self._vec_by_job(ajob, nJ)
            for g in runs:
                gi = g.idx
                sel = jsort[off[gi]:off[gi + 1]]
                if not sel.shape[0]:
                    continue
                m = float(at[sel[-1]])
                if m > g.push_end:
                    g.push_end = m
                g.landed_mb = self._vec_fold(g.landed_mb, asz[sel])
                dsel = adst[sel]
                np.subtract.at(g.push_inflight, dsel, 1)
                g.total_push_inflight -= int(sel.shape[0])
                b0 = g.cfg.barriers[0]
                if b0 == "P":
                    continue
                if b0 == "L":
                    openm = g.push_inflight[dsel] == 0
                    aready[sel] = arrj[gi, dsel]
                    agated[sel] = ~openm
                    for j in np.unique(dsel[openm]):
                        j = int(j)
                        if g.map_gated[j]:
                            trig = float(arrj[gi, j])
                            for c in g.map_gated[j]:
                                flushm.setdefault(j, []).append(
                                    (trig, GTIE + gctr, c.size, gi, c,
                                     c.src))
                                gctr += 1
                            g.map_gated[j].clear()
                elif g.total_push_inflight == 0:  # G, fully arrived
                    trig = float(arr_any[gi])
                    aready[sel] = trig
                    for j in range(nM):
                        if g.map_gated[j]:
                            for c in g.map_gated[j]:
                                flushm.setdefault(j, []).append(
                                    (trig, GTIE + gctr, c.size, gi, c,
                                     c.src))
                                gctr += 1
                            g.map_gated[j].clear()
                else:  # G, still draining: everything parks at the gate
                    agated[sel] = True

            # gated arrivals park at the barrier in arrival order
            for idx in np.flatnonzero(agated):
                g = runs[int(ajob[idx])]
                c = aobj[idx]
                if c is None:
                    c = _Chunk(next(self._cid), float(asz[idx]),
                               int(asrc[idx]), owner=int(adst[idx]))
                    c.landed = True
                g.map_gated[int(adst[idx])].append(c)

        # ---- pass 4: mapper serves → completion stream -------------------
        comp_p: Tuple[list, ...] = ([], [], [], [], [], [])
        if comp_b:
            cols = list(zip(*comp_b))
            comp_p[0].append(np.asarray(cols[0], dtype=np.float64))
            comp_p[1].append(np.asarray(cols[1], dtype=np.int64))
            comp_p[2].append(np.asarray(cols[2], dtype=np.float64))
            comp_p[3].append(np.asarray(cols[3], dtype=np.int64))
            comp_p[4].append(np.asarray(cols[4], dtype=np.int64))
            comp_p[5].append(np.asarray(cols[5], dtype=np.int64))
        mvisit = set(flushm)
        mvisit.update(j for j in freed_mj if self.mappers[j].queue)
        if n_arr:
            mvisit.update(int(j) for j in np.unique(adst[~agated]))
        for j in sorted(mvisit):
            if n_arr:
                sel = np.flatnonzero(~agated & (adst == j))
                e_ready, e_tie, e_sz = aready[sel], seqv[sel], asz[sel]
                e_jb, e_obj, e_src = ajob[sel], aobj[sel], asrc[sel]
            else:
                e_ready, e_tie, e_sz = EMPTYF, EMPTYI, EMPTYF
                e_jb, e_obj, e_src = EMPTYI, EMPTYO, EMPTYI
            fl = flushm.get(j)
            if fl:
                fc = list(zip(*fl))
                fo = np.empty(len(fl), dtype=object)
                fo[:] = fc[4]
                e_ready = np.concatenate(
                    (np.asarray(fc[0], dtype=np.float64), e_ready))
                e_tie = np.concatenate(
                    (np.asarray(fc[1], dtype=np.int64), e_tie))
                e_sz = np.concatenate(
                    (np.asarray(fc[2], dtype=np.float64), e_sz))
                e_jb = np.concatenate(
                    (np.asarray(fc[3], dtype=np.int64), e_jb))
                e_obj = np.concatenate((fo, e_obj))
                e_src = np.concatenate(
                    (np.asarray(fc[5], dtype=np.int64), e_src))
            serve_node(self.mappers[j], e_ready, e_tie, e_sz, e_jb,
                       e_obj, e_src, slow_m, "m", j, "map_done", comp_p)

        # ---- pass 5: completions → shuffle barrier → emissions -----------
        sarr_p: Tuple[list, ...] = ([], [], [], [], [], [], [])
        if sarr_b:
            cols = list(zip(*sarr_b))
            sarr_p[0].append(np.asarray(cols[0], dtype=np.float64))
            sarr_p[1].append(np.asarray(cols[1], dtype=np.int64))
            sarr_p[2].append(np.asarray(cols[2], dtype=np.float64))
            sarr_p[3].append(np.asarray(cols[3], dtype=np.int64))
            bo = np.empty(len(sarr_b), dtype=object)
            bo[:] = cols[4]
            sarr_p[4].append(bo)
            sarr_p[5].append(np.asarray(cols[5], dtype=np.int64))
            sarr_p[6].append(np.asarray(cols[6], dtype=np.int64))
        shflush: Dict[Tuple[int, int], list] = {}
        n_comp = sum(a.shape[0] for a in comp_p[0])
        n_em = 0
        if n_comp:
            ct = _cat(comp_p[0])
            ctie = _cat(comp_p[1], np.int64)
            csz = _cat(comp_p[2])
            cjob = _cat(comp_p[3], np.int64)
            cdst = _cat(comp_p[5], np.int64)
            o = np.lexsort((ctie, ct))
            ct, csz, cjob, cdst = ct[o], csz[o], cjob[o], cdst[o]
            if float(ct[-1]) > t_max:
                t_max = float(ct[-1])
            compj = np.full((nJ, nM), NEG)
            comp_any = np.full(nJ, NEG)
            compj[cjob, cdst] = ct
            comp_any[cjob] = ct
            cready = ct.copy()
            cgated = np.zeros(n_comp, dtype=bool)
            jsort, off = self._vec_by_job(cjob, nJ)
            for g in runs:
                gi = g.idx
                sel = jsort[off[gi]:off[gi + 1]]
                if not sel.shape[0]:
                    continue
                m = float(ct[sel[-1]])
                if m > g.map_end:
                    g.map_end = m
                g.mapped_mb = self._vec_fold(g.mapped_mb, csz[sel])
                dsel = cdst[sel]
                np.subtract.at(g.map_unfinished, dsel, 1)
                g.total_map_unfinished -= int(sel.shape[0])
                b1 = g.cfg.barriers[1]
                if b1 == "P":
                    continue
                if b1 == "L":
                    openm = g.map_unfinished[dsel] == 0
                    cready[sel] = compj[gi, dsel]
                    cgated[sel] = ~openm
                    flushj = [int(j) for j in np.unique(dsel[openm])]
                elif g.total_map_unfinished == 0:  # G, all map work done
                    cready[sel] = float(comp_any[gi])
                    flushj = list(range(nM))
                else:  # G, maps still outstanding
                    cgated[sel] = True
                    continue
                for j in flushj:
                    if not g.shuf_gated[j]:
                        continue
                    trig = float(compj[gi, j]) if b1 == "L" \
                        else float(comp_any[gi])
                    for k, sc in g.shuf_gated[j]:
                        tr = _Transfer(g, sc.size, "shuffle_arrive",
                                       (g, j, k, sc), trig)
                        shflush.setdefault((j, k), []).append(
                            (trig, GTIE + gctr, sc.size, gi, tr))
                        gctr += 1
                    g.shuf_gated[j].clear()

            # emissions: completion-major, reducer-minor — exactly
            # _emit_shuffle's creation order, gated or not
            alpha_j = np.array([g.p.alpha for g in runs],
                               dtype=np.float64)
            ynz = [
                [(k, g.plan.y[k]) for k in range(nR)
                 if g.plan.y[k] > 0.0]
                for g in runs
            ]
            fan = np.array([len(z) for z in ynz], dtype=np.int64)
            maxf = max(int(fan.max()), 1)
            ynz_k = np.zeros((nJ, maxf), dtype=np.int64)
            ynz_y = np.zeros((nJ, maxf))
            for gi, z in enumerate(ynz):
                for s, (k, yk) in enumerate(z):
                    ynz_k[gi, s] = k
                    ynz_y[gi, s] = yk
            counts = fan[cjob]
            tot = int(counts.sum())
            if tot:
                off_e = np.concatenate(([0], np.cumsum(counts)))
                repi = np.repeat(np.arange(n_comp), counts)
                slot = np.arange(tot, dtype=np.int64) - off_e[repi]
                ejob = cjob[repi]
                ek = ynz_k[ejob, slot]
                a_s = alpha_j[ejob] * csz[repi]
                amt = a_s * ynz_y[ejob, slot]
                keep = amt > 1e-9
                eenq = cready[repi][keep]
                egated = cgated[repi][keep]
                ejob, ek, amt = ejob[keep], ek[keep], amt[keep]
                ejv = cdst[repi][keep]
                n_em = amt.shape[0]
        if n_em:
            etie = gen + np.arange(n_em, dtype=np.int64)
            gen += n_em
            jsort, off = self._vec_by_job(ejob, nJ)
            for g in runs:
                gi = g.idx
                sel = jsort[off[gi]:off[gi + 1]]
                if not sel.shape[0]:
                    continue
                g.shuf_created_mb = self._vec_fold(
                    g.shuf_created_mb, amt[sel])
                ksel = ek[sel]
                np.add.at(g.shuf_inflight, ksel, 1)
                g.total_shuf_inflight += int(sel.shape[0])
                np.add.at(g.reduce_outstanding, ksel, 1)
            # emissions born behind a shut gate park on it (creation
            # order), to be flushed by a later segment's trigger
            for idx in np.flatnonzero(egated):
                g = runs[int(ejob[idx])]
                sc = _Chunk(next(self._cid), float(amt[idx]),
                            int(ejv[idx]))
                g.shuf_gated[int(ejv[idx])].append((int(ek[idx]), sc))

        # ---- pass 6: shuffle-link serves → shuffle-arrival stream --------
        skeys = set(shflush)
        skeys.update((j, k) for (j, k) in sh_keys
                     if self.shuf_links[j][k].queue)
        eopen = None
        if n_em:
            eopen = np.flatnonzero(~egated)
            lkey = ejv[eopen] * nR + ek[eopen]
            skeys.update(
                (int(kk) // nR, int(kk) % nR) for kk in np.unique(lkey))
        for (j, k) in sorted(skeys):
            if eopen is not None:
                sel = eopen[lkey == j * nR + k]
                e_ready, e_tie, e_sz = eenq[sel], etie[sel], amt[sel]
                e_jb = ejob[sel]
                e_obj = np.full(sel.shape[0], None, dtype=object)
            else:
                e_ready, e_tie, e_sz = EMPTYF, EMPTYI, EMPTYF
                e_jb, e_obj = EMPTYI, EMPTYO
            fl = shflush.get((j, k))
            if fl:
                fc = list(zip(*fl))
                fo = np.empty(len(fl), dtype=object)
                fo[:] = fc[4]
                e_ready = np.concatenate(
                    (np.asarray(fc[0], dtype=np.float64), e_ready))
                e_tie = np.concatenate(
                    (np.asarray(fc[1], dtype=np.int64), e_tie))
                e_sz = np.concatenate(
                    (np.asarray(fc[2], dtype=np.float64), e_sz))
                e_jb = np.concatenate(
                    (np.asarray(fc[3], dtype=np.int64), e_jb))
                e_obj = np.concatenate((fo, e_obj))
            serve_link(self.shuf_links[j][k], e_ready, e_tie, e_sz,
                       e_jb, e_obj, "shuffle_arrive", j, k, sarr_p)

        # ---- pass 7: shuffle arrivals → reduce barrier gates -------------
        n_sarr = sum(a.shape[0] for a in sarr_p[0])
        flushr: Dict[int, list] = {}
        if n_sarr:
            st_ = _cat(sarr_p[0])
            stie = _cat(sarr_p[1], np.int64)
            samt = _cat(sarr_p[2])
            sjob = _cat(sarr_p[3], np.int64)
            sobj = _cat(sarr_p[4], object)
            ssrc = _cat(sarr_p[5], np.int64)
            skv = _cat(sarr_p[6], np.int64)
            o = np.lexsort((stie, st_))
            st_, stie, samt, sjob = st_[o], stie[o], samt[o], sjob[o]
            sobj, ssrc, skv = sobj[o], ssrc[o], skv[o]
            if float(st_[-1]) > t_max:
                t_max = float(st_[-1])
            sarrk = np.full((nJ, nR), NEG)
            sarr_any = np.full(nJ, NEG)
            sarrk[sjob, skv] = st_
            sarr_any[sjob] = st_
            seqr = np.arange(n_sarr, dtype=np.int64)
            sready = st_.copy()
            sgated = np.zeros(n_sarr, dtype=bool)
            jsort, off = self._vec_by_job(sjob, nJ)
            for g in runs:
                gi = g.idx
                sel = jsort[off[gi]:off[gi + 1]]
                if not sel.shape[0]:
                    continue
                m = float(st_[sel[-1]])
                if m > g.shuffle_end:
                    g.shuffle_end = m
                g.shuf_landed_mb = self._vec_fold(
                    g.shuf_landed_mb, samt[sel])
                ksel = skv[sel]
                np.subtract.at(g.shuf_inflight, ksel, 1)
                g.total_shuf_inflight -= int(sel.shape[0])
                b2 = g.cfg.barriers[2]
                if b2 == "P":
                    continue
                # _shuffle_final at the trigger: all map work drained in
                # this segment's past — the trigger must not precede the
                # last map completion (or push arrival), else the scalar
                # check failed at its final chance and the gate stays
                # shut until new work re-triggers it
                final = (g.total_map_unfinished == 0
                         and g.total_push_inflight == 0
                         and not g.dep_pending)
                if b2 == "L":
                    openk = (final
                             & (g.shuf_inflight[ksel] == 0)
                             & (sarrk[gi, ksel] >= g.map_end)
                             & (sarrk[gi, ksel] >= g.push_end))
                    sready[sel] = sarrk[gi, ksel]
                    sgated[sel] = ~openk
                    flushk = [int(k) for k in np.unique(ksel[openk])]
                    trigk = {k: float(sarrk[gi, k]) for k in flushk}
                elif (final and g.total_shuf_inflight == 0
                        and float(sarr_any[gi]) >= g.map_end
                        and float(sarr_any[gi]) >= g.push_end):  # G
                    trig = float(sarr_any[gi])
                    sready[sel] = trig
                    flushk = list(range(nR))
                    trigk = {k: trig for k in flushk}
                else:  # G, not final yet
                    sgated[sel] = True
                    continue
                for k in flushk:
                    if not g.red_gated[k]:
                        continue
                    trig = trigk[k]
                    for sc in g.red_gated[k]:
                        flushr.setdefault(k, []).append(
                            (trig, GTIE + gctr, sc.size, gi, sc, sc.src))
                        gctr += 1
                    g.red_gated[k].clear()

            # gated shuffle arrivals park at the barrier in stream order
            for idx in np.flatnonzero(sgated):
                g = runs[int(sjob[idx])]
                sc = sobj[idx]
                if sc is None:
                    sc = _Chunk(next(self._cid), float(samt[idx]),
                                int(ssrc[idx]))
                g.red_gated[int(skv[idx])].append(sc)

        # ---- pass 8: reducer serves → reduce completion stream -----------
        red_p: Tuple[list, ...] = ([], [], [], [], [], [])
        if red_b:
            cols = list(zip(*red_b))
            red_p[0].append(np.asarray(cols[0], dtype=np.float64))
            red_p[1].append(np.asarray(cols[1], dtype=np.int64))
            red_p[2].append(np.asarray(cols[2], dtype=np.float64))
            red_p[3].append(np.asarray(cols[3], dtype=np.int64))
            red_p[4].append(np.asarray(cols[4], dtype=np.int64))
            red_p[5].append(np.asarray(cols[5], dtype=np.int64))
        rvisit = set(flushr)
        rvisit.update(k for k in freed_rk if self.reducers[k].queue)
        if n_sarr:
            rvisit.update(int(k) for k in np.unique(skv[~sgated]))
        for k in sorted(rvisit):
            if n_sarr:
                sel = np.flatnonzero(~sgated & (skv == k))
                e_ready, e_tie, e_sz = sready[sel], seqr[sel], samt[sel]
                e_jb, e_obj, e_src = sjob[sel], sobj[sel], ssrc[sel]
            else:
                e_ready, e_tie, e_sz = EMPTYF, EMPTYI, EMPTYF
                e_jb, e_obj, e_src = EMPTYI, EMPTYO, EMPTYI
            fl = flushr.get(k)
            if fl:
                fc = list(zip(*fl))
                fo = np.empty(len(fl), dtype=object)
                fo[:] = fc[4]
                e_ready = np.concatenate(
                    (np.asarray(fc[0], dtype=np.float64), e_ready))
                e_tie = np.concatenate(
                    (np.asarray(fc[1], dtype=np.int64), e_tie))
                e_sz = np.concatenate(
                    (np.asarray(fc[2], dtype=np.float64), e_sz))
                e_jb = np.concatenate(
                    (np.asarray(fc[3], dtype=np.int64), e_jb))
                e_obj = np.concatenate((fo, e_obj))
                e_src = np.concatenate(
                    (np.asarray(fc[5], dtype=np.int64), e_src))
            serve_node(self.reducers[k], e_ready, e_tie, e_sz, e_jb,
                       e_obj, e_src, slow_r, "r", k, "reduce_done",
                       red_p)

        # ---- pass 9: reduce ledger ---------------------------------------
        n_red = sum(a.shape[0] for a in red_p[0])
        if n_red:
            rt = _cat(red_p[0])
            rtie = _cat(red_p[1], np.int64)
            ramt = _cat(red_p[2])
            rjob = _cat(red_p[3], np.int64)
            rsrc = _cat(red_p[4], np.int64)
            rkv = _cat(red_p[5], np.int64)
            o = np.lexsort((rtie, rt))
            rt, ramt, rjob = rt[o], ramt[o], rjob[o]
            rsrc, rkv = rsrc[o], rkv[o]
            if float(rt[-1]) > t_max:
                t_max = float(rt[-1])
            jsort, off = self._vec_by_job(rjob, nJ)
            for g in runs:
                gi = g.idx
                sel = jsort[off[gi]:off[gi + 1]]
                if not sel.shape[0]:
                    continue
                m = float(rt[sel[-1]])
                if m > g.reduce_end:
                    g.reduce_end = m
                g.reduced_mb = self._vec_fold(g.reduced_mb, ramt[sel])
                kv = rkv[sel]
                np.subtract.at(g.reduce_outstanding, kv, 1)
                for k in np.unique(kv):
                    ks = sel[kv == k]
                    g.delivered_out[k] = self._vec_fold(
                        float(g.delivered_out[k]), ramt[ks])
                bykey = rsrc[sel] * nR + kv
                for key in np.unique(bykey):
                    ks = sel[bykey == key]
                    src_, k_ = divmod(int(key), nR)
                    g.reduced_by[src_, k_] = self._vec_fold(
                        float(g.reduced_by[src_, k_]), ramt[ks])

        self.now = max(self.now, t_max)
        if self._audit:
            self._audit_step("vec_drain")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
_JobEntry = Union[
    Tuple[Platform, ExecutionPlan],
    Tuple[Platform, ExecutionPlan, Optional[SimConfig]],
]


def _normalize_entries(jobs: Sequence[_JobEntry]):
    entries = []
    for entry in jobs:
        platform, plan, cfg = entry if len(entry) == 3 else (*entry, None)
        entries.append((platform, plan, cfg or SimConfig()))
    return entries


def open_schedule(
    jobs: Sequence[_JobEntry],
    substrate: Optional[Substrate] = None,
    stage_links: Optional[Dict[int, Sequence[Tuple[int, float]]]] = None,
) -> _MultiSim:
    """Build (but do not run) the multi-job engine — the entry point of the
    online control plane.  The returned engine supports ``run_until(t)`` /
    ``snapshot()`` / ``swap_plan(idx, plan)`` / ``inject(jobs)`` / ``run()``;
    draining it without steering is exactly :func:`simulate_schedule`.

    ``jobs`` is a sequence of ``(platform, plan)`` or ``(platform, plan,
    cfg)`` entries whose platforms must all be views of the same substrate
    (checked via :meth:`Substrate.compatible`); ``substrate`` overrides the
    inferred one.  ``stage_links`` turns entries into pipeline stages:
    ``{child_idx: [(parent_idx, out_scale), ...]}`` — the child's source
    ``s`` releases only when every parent's reduce output destined for
    node ``s`` lands (see :meth:`_MultiSim.link_stages`).
    """
    if not jobs:
        raise ValueError("open_schedule needs at least one job")
    entries = _normalize_entries(jobs)
    sub = substrate if substrate is not None else Substrate.of(entries[0][0])
    for platform, _, _ in entries:
        if not sub.compatible(Substrate.of(platform)):
            raise ValueError(
                f"platform {platform.name!r} is not a view of substrate "
                f"{sub.name!r} — build job platforms with Substrate.view()"
            )
    modes = {cfg.mode for _, _, cfg in entries}
    if "fluid" in modes:
        if modes != {"fluid"}:
            raise ValueError(
                "every job of one schedule must agree on SimConfig.mode — "
                f"got {sorted(modes)}"
            )
        if stage_links:
            raise ValueError(
                "fluid mode does not support pipeline stage links — use "
                'SimConfig(mode="event")'
            )
        from .fluid import FluidSim
        return FluidSim(sub, entries)
    runs = [
        _JobRun(idx, platform, plan, cfg, sub.nM, sub.nR)
        for idx, (platform, plan, cfg) in enumerate(entries)
    ]
    eng = _MultiSim(sub, runs)
    for child, parents in (stage_links or {}).items():
        eng.link_stages(int(child), list(parents))
    return eng


def simulate_schedule(
    jobs: Sequence[_JobEntry],
    substrate: Optional[Substrate] = None,
    stage_links: Optional[Dict[int, Sequence[Tuple[int, float]]]] = None,
) -> ScheduleSimResult:
    """Execute N jobs concurrently on one shared substrate.

    Each job keeps its own barriers, chunking, dynamics and release time
    (``SimConfig.start_time``) — only the link/compute resources are
    shared.  This is :func:`open_schedule` drained to completion with no
    online steering (the frozen-plan baseline of the control plane).
    ``stage_links`` runs a pipeline: see :func:`open_schedule`.
    """
    if not jobs:
        raise ValueError("simulate_schedule needs at least one job")
    return open_schedule(jobs, substrate, stage_links).run()


def simulate(
    platform: Platform, plan: ExecutionPlan, cfg: Optional[SimConfig] = None
) -> SimResult:
    """Execute ``plan`` on ``platform`` under ``cfg`` and return timings —
    the N=1 case of :func:`simulate_schedule` (one job, sole tenant of its
    substrate)."""
    return simulate_schedule([(platform, plan, cfg or SimConfig())]).jobs[0]
