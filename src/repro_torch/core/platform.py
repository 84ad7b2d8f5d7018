"""Platform model for distributed MapReduce execution (paper §2.1).

The distributed platform is a tripartite graph ``S ∪ M ∪ R`` (data sources,
mappers, reducers).  Node ``i ∈ M ∪ R`` has a compute capacity ``C_i`` in
bytes/second of *incoming* data processed; edge ``(i, j)`` has bandwidth
``B_ij``; data ``D_i`` originates at source ``i``; the application is modeled
by a single expansion factor ``alpha`` = (map output bytes) / (map input
bytes).

All quantities in this module use **MB** and **seconds** (so rates are MB/s),
which keeps the numbers well-scaled for the gradient-based optimizer.

Generators are provided for

* the two-cluster worked example of paper §1.3,
* the PlanetLab-derived environments of §4.1 (1 / 2 / 4 / 8 data centers,
  Table 1 bandwidth ranges, 9–90 MB/s compute rates), and
* a TPU-pod environment (ICI-connected pods over a slower DCN), which is the
  geo-distributed platform the rest of this framework plans for.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..analysis.validate import require_finite, require_positive

__all__ = [
    "CapacityTrace",
    "FailureEvent",
    "FailureTrace",
    "Platform",
    "Substrate",
    "two_cluster_example",
    "planetlab_platform",
    "tpu_pod_platform",
    "PLANETLAB_SITES",
    "TABLE1_BANDWIDTH_KBPS",
]


@dataclasses.dataclass(frozen=True)
class CapacityTrace:
    """A drifting resource capacity as a right-open step function.

    ``values[i]`` (MB/s) applies on ``[times[i], times[i+1])``; the last
    value holds forever.  ``times`` must start at 0 and strictly increase,
    so a trace always answers :meth:`at` for any ``t >= 0``.  Traces attach
    to a :class:`Substrate` by resource name (see
    :meth:`Substrate.with_traces`) and model WAN capacity drift the planner
    did not know at plan time: the executor serves each chunk at the
    capacity in force when its service *starts*, and :meth:`Substrate.at`
    gives an online planner the capacities in force at any instant.
    """

    times: Tuple[float, ...]
    values: Tuple[float, ...]

    def __post_init__(self):
        times = tuple(float(t) for t in self.times)
        values = tuple(float(v) for v in self.values)
        object.__setattr__(self, "times", times)
        object.__setattr__(self, "values", values)
        if len(times) != len(values) or not times:
            raise ValueError("times and values must be equal-length, non-empty")
        if times[0] != 0.0:
            raise ValueError("a CapacityTrace must start at t=0")
        if any(b <= a for a, b in zip(times, times[1:])):
            raise ValueError("times must strictly increase")
        if any(v <= 0 for v in values):
            raise ValueError("capacities must be strictly positive")

    @classmethod
    def step(cls, before: float, after: float, t: float) -> "CapacityTrace":
        """A single capacity step: ``before`` MB/s on [0, t), ``after``
        from ``t`` on — the one-event drift of a degrading backbone link."""
        return cls(times=(0.0, float(t)), values=(before, after))

    def at(self, t: float) -> float:
        """Capacity (MB/s) in force at absolute time ``t``."""
        idx = bisect.bisect_right(self.times, float(t)) - 1
        return self.values[max(idx, 0)]


#: the typed discrete failure modes the executor injects (ROADMAP §2):
#: workers die, whole clusters partition away and heal.
FAILURE_KINDS = ("mapper_kill", "reducer_kill", "cluster_partition")

#: capacity factor applied to dead/partitioned resources in planning views
#: (:meth:`Substrate.at`): not exactly zero — the softmax planner needs an
#: epsilon escape mass, matching ``optimize._degraded_platform``.
FAILURE_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One typed discrete failure.

    Kinds (``FAILURE_KINDS``):

    * ``mapper_kill``  — the worker on mapper ``node`` dies at ``time``;
      un-delivered partial input is lost and re-executed from a surviving
      replica (when one holds the bytes) or re-pushed from the source.
    * ``reducer_kill`` — reducer ``node`` dies at ``time``; delivered but
      un-consumed shuffle input *and* already-reduced output are lost and
      re-emitted from the mappers' durable map output.
    * ``cluster_partition`` — cluster ``cluster`` partitions away on
      ``[time, t_repair)``: every link crossing the partition boundary is
      down, in-flight transfers on those links are dropped (retransmitted
      after repair), queued ones wait or get re-routed by a replan.
      ``t_repair=None`` means the partition never heals.

    Kills attach per job (``SimConfig(failures=...)`` — that job's worker
    dies) or substrate-wide (:meth:`Substrate.with_failures` — the node
    dies for every job); partitions are fabric facts and only attach to
    the substrate.
    """

    kind: str
    time: float
    node: Optional[int] = None
    cluster: Optional[int] = None
    t_repair: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FAILURE_KINDS:
            raise ValueError(
                f"kind must be one of {FAILURE_KINDS}, got {self.kind!r}"
            )
        object.__setattr__(self, "time", float(self.time))
        if not np.isfinite(self.time) or self.time < 0:
            raise ValueError(f"time must be finite and >= 0, got {self.time}")
        if self.kind == "cluster_partition":
            if self.node is not None:
                raise ValueError("cluster_partition takes cluster=, not node=")
            if self.cluster is None:
                raise ValueError("cluster_partition needs cluster=")
            object.__setattr__(self, "cluster", int(self.cluster))
            if self.t_repair is not None:
                object.__setattr__(self, "t_repair", float(self.t_repair))
                if self.t_repair <= self.time:
                    raise ValueError(
                        f"t_repair={self.t_repair} must exceed time={self.time}"
                    )
        else:
            if self.node is None:
                raise ValueError(f"{self.kind} needs node=")
            if self.cluster is not None or self.t_repair is not None:
                raise ValueError(
                    f"{self.kind} takes node= and time= only (kills are "
                    "permanent; repair applies to partitions)"
                )
            object.__setattr__(self, "node", int(self.node))
            if self.node < 0:
                raise ValueError(f"node must be >= 0, got {self.node}")

    # -- ergonomic constructors -------------------------------------------
    @classmethod
    def mapper_kill(cls, mapper: int, time: float) -> "FailureEvent":
        return cls(kind="mapper_kill", time=time, node=mapper)

    @classmethod
    def reducer_kill(cls, reducer: int, time: float) -> "FailureEvent":
        return cls(kind="reducer_kill", time=time, node=reducer)

    @classmethod
    def cluster_partition(
        cls, cluster: int, time: float, t_repair: Optional[float] = None
    ) -> "FailureEvent":
        return cls(kind="cluster_partition", time=time, cluster=cluster,
                   t_repair=t_repair)


@dataclasses.dataclass(frozen=True)
class FailureTrace:
    """A substrate-level fault script: typed :class:`FailureEvent`\\ s in
    time order, attached via :meth:`Substrate.with_failures` exactly like a
    :class:`CapacityTrace` attaches per resource.  The executor fires each
    event against *every* job sharing the substrate; :meth:`times` gives an
    online policy the decision instants to watch, and :meth:`Substrate.at`
    folds the failure state in force at ``t`` into the capacity arrays a
    re-planner sees (dead resources at ``FAILURE_EPS`` until repair)."""

    events: Tuple[FailureEvent, ...]

    def __post_init__(self):
        events = tuple(self.events)
        for ev in events:
            if not isinstance(ev, FailureEvent):
                raise TypeError(f"not a FailureEvent: {ev!r}")
        object.__setattr__(
            self, "events",
            tuple(sorted(events, key=lambda e: (e.time, e.kind,
                                                -1 if e.node is None else e.node,
                                                -1 if e.cluster is None
                                                else e.cluster))),
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def times(self) -> Tuple[float, ...]:
        """Every decision instant (ascending, t > 0): each failure's fire
        time plus each partition's repair time — what a reactive online
        policy watches, the fault analogue of
        :meth:`Substrate.drift_times`."""
        ts = {ev.time for ev in self.events if ev.time > 0}
        ts |= {ev.t_repair for ev in self.events
               if ev.t_repair is not None and ev.t_repair > 0}
        return tuple(sorted(ts))


#: resource-name grammar shared with :meth:`Substrate.resources` — traces
#: key into the same namespace the executor's per-resource stats use.
_TRACE_KEY_RE = re.compile(
    r"^(?:push\[s(\d+)->m(\d+)\]|shuffle\[m(\d+)->r(\d+)\]"
    r"|map\[m(\d+)\]|reduce\[r(\d+)\])$"
)


@dataclasses.dataclass(frozen=True)
class Substrate:
    """The shared physical resources of a distributed platform.

    A substrate is everything about the tripartite graph that is *not*
    job-specific: named link/compute resources with capacities, plus the
    cluster topology.  Concurrent jobs contend for the same substrate
    entries; a :class:`Platform` is one job's slice of it
    (:meth:`Substrate.view` attaches the job's ``D`` and ``alpha`` *without
    copying* the capacity arrays, so two jobs literally reference the same
    ``B_sm``/``B_mr``/``C_m``/``C_r`` rows).

    Attributes:
      B_sm:  (nS, nM) push-link bandwidth, MB/s.
      B_mr:  (nM, nR) shuffle-link bandwidth, MB/s.
      C_m:   (nM,) mapper compute rate, MB/s of input data.
      C_r:   (nR,) reducer compute rate, MB/s of input data.
      cluster_s/m/r: integer cluster (site) id per node.
      traces: optional {resource name -> :class:`CapacityTrace`} overriding
        the (nominal, t=0) capacity arrays over time.  The executor reads
        the trace at each chunk's service start; an online planner reads
        :meth:`at` for the capacities in force at a decision instant.
      failures: optional substrate-level :class:`FailureTrace` — discrete
        fault events (kills, partitions) affecting every job sharing the
        substrate, threaded through the executor like the traces.
    """

    B_sm: np.ndarray
    B_mr: np.ndarray
    C_m: np.ndarray
    C_r: np.ndarray
    cluster_s: np.ndarray
    cluster_m: np.ndarray
    cluster_r: np.ndarray
    name: str = "substrate"
    traces: Optional[Dict[str, CapacityTrace]] = None
    failures: Optional[FailureTrace] = None

    def __post_init__(self):
        for field in ("B_sm", "B_mr", "C_m", "C_r"):
            # require_positive also rejects NaN/inf, which `<= 0` lets pass
            object.__setattr__(
                self, field, require_positive(field, getattr(self, field))
            )
        nS, nM = self.B_sm.shape
        nM2, nR = self.B_mr.shape
        if nM != nM2:
            raise ValueError(f"B_sm/B_mr mapper dims disagree: {nM} vs {nM2}")
        if self.C_m.shape != (nM,):
            raise ValueError(f"C_m shape {self.C_m.shape} != ({nM},)")
        if self.C_r.shape != (nR,):
            raise ValueError(f"C_r shape {self.C_r.shape} != ({nR},)")
        if self.traces:
            known = self.resources()
            for key, trace in self.traces.items():
                if not isinstance(trace, CapacityTrace):
                    raise TypeError(f"trace for {key!r} is not a CapacityTrace")
                if _TRACE_KEY_RE.match(key) is None or key not in known:
                    raise ValueError(
                        f"unknown trace key {key!r} — use a resource name "
                        "from Substrate.resources()"
                    )
        if self.failures:
            if not isinstance(self.failures, FailureTrace):
                raise TypeError("failures must be a FailureTrace")
            clusters = (set(np.unique(self.cluster_s).tolist())
                        | set(np.unique(self.cluster_m).tolist())
                        | set(np.unique(self.cluster_r).tolist()))
            for ev in self.failures:
                if ev.kind == "mapper_kill" and ev.node >= self.nM:
                    raise ValueError(
                        f"mapper_kill node {ev.node} out of range (nM={self.nM})"
                    )
                if ev.kind == "reducer_kill" and ev.node >= self.nR:
                    raise ValueError(
                        f"reducer_kill node {ev.node} out of range (nR={self.nR})"
                    )
                if ev.kind == "cluster_partition" and ev.cluster not in clusters:
                    raise ValueError(
                        f"cluster_partition cluster {ev.cluster} is not a "
                        f"cluster id of this substrate ({sorted(clusters)})"
                    )

    # -- sizes ------------------------------------------------------------
    @property
    def nS(self) -> int:
        return self.B_sm.shape[0]

    @property
    def nM(self) -> int:
        return self.B_sm.shape[1]

    @property
    def nR(self) -> int:
        return self.B_mr.shape[1]

    # -- construction ------------------------------------------------------
    @classmethod
    def of(cls, platform: "Platform") -> "Substrate":
        """The substrate behind ``platform`` — its declared one when it was
        built as a view, otherwise a substrate sharing the platform's own
        capacity arrays (so views of it contend with the original job)."""
        if platform.substrate is not None:
            return platform.substrate
        return cls(
            B_sm=platform.B_sm,
            B_mr=platform.B_mr,
            C_m=platform.C_m,
            C_r=platform.C_r,
            cluster_s=platform.cluster_s,
            cluster_m=platform.cluster_m,
            cluster_r=platform.cluster_r,
            name=platform.name,
        )

    def view(
        self,
        D: np.ndarray,
        alpha: float = 1.0,
        name: Optional[str] = None,
    ) -> "Platform":
        """One job's slice of this substrate: a :class:`Platform` carrying
        the job's data layout ``D`` and expansion factor ``alpha`` while
        *sharing* (not copying) the capacity arrays."""
        return Platform(
            D=np.asarray(D, dtype=np.float64),
            B_sm=self.B_sm,
            B_mr=self.B_mr,
            C_m=self.C_m,
            C_r=self.C_r,
            alpha=float(alpha),
            cluster_s=self.cluster_s,
            cluster_m=self.cluster_m,
            cluster_r=self.cluster_r,
            name=name or f"{self.name}/job",
            substrate=self,
        )

    def compatible(self, other: "Substrate") -> bool:
        """Two substrates describe the same physical resources when they are
        the same object or hold identical capacity arrays (jobs built from
        equal generator calls may legitimately share)."""
        if self is other:
            return True
        return (
            self.B_sm.shape == other.B_sm.shape
            and self.B_mr.shape == other.B_mr.shape
            and np.array_equal(self.B_sm, other.B_sm)
            and np.array_equal(self.B_mr, other.B_mr)
            and np.array_equal(self.C_m, other.C_m)
            and np.array_equal(self.C_r, other.C_r)
        )

    # -- named resources ---------------------------------------------------
    def resources(self) -> Dict[str, float]:
        """Every named resource and its capacity (MB/s): push/shuffle links
        and map/reduce compute nodes.  These names key the per-resource
        utilization stats of the multi-job executor."""
        out: Dict[str, float] = {}
        for i in range(self.nS):
            for j in range(self.nM):
                out[f"push[s{i}->m{j}]"] = float(self.B_sm[i, j])
        for j in range(self.nM):
            for k in range(self.nR):
                out[f"shuffle[m{j}->r{k}]"] = float(self.B_mr[j, k])
        for j in range(self.nM):
            out[f"map[m{j}]"] = float(self.C_m[j])
        for k in range(self.nR):
            out[f"reduce[r{k}]"] = float(self.C_r[k])
        return out

    def residual(
        self,
        push_frac: Optional[np.ndarray] = None,
        shuffle_frac: Optional[np.ndarray] = None,
        map_frac: Optional[np.ndarray] = None,
        reduce_frac: Optional[np.ndarray] = None,
        floor: float = 0.05,
    ) -> "Substrate":
        """A *planning* view of this substrate with the given fraction of
        each resource's capacity already committed to earlier jobs (greedy
        sequential scheduling).  Residual capacities are floored at
        ``floor`` of the original so later jobs always see a usable (if
        slow) platform.  The result is a distinct substrate — it prices
        hypothetical residual capacity and must not be used as the identity
        of the physical resources."""

        def scale(cap, frac):
            if frac is None:
                return cap.copy()  # never alias the physical substrate
            frac = np.clip(np.asarray(frac, dtype=np.float64), 0.0, 1.0 - floor)
            return cap * (1.0 - frac)

        return dataclasses.replace(
            self,
            B_sm=scale(self.B_sm, push_frac),
            B_mr=scale(self.B_mr, shuffle_frac),
            C_m=scale(self.C_m, map_frac),
            C_r=scale(self.C_r, reduce_frac),
            traces=None,  # a hypothetical planning view, not the live fabric
            failures=None,
            name=f"{self.name}/residual",
        )

    # -- capacity drift ----------------------------------------------------
    def with_traces(self, traces: Dict[str, CapacityTrace]) -> "Substrate":
        """This substrate with drifting capacities: ``traces`` maps resource
        names (the :meth:`resources` namespace) to step-function
        :class:`CapacityTrace`\\ s.  The base arrays stay the *nominal*
        (t=0) view every offline planner sees; the executor and
        :meth:`at` read the traces."""
        return dataclasses.replace(self, traces=dict(traces))

    def trace_for(self, name: str) -> Optional[CapacityTrace]:
        """The capacity trace attached to resource ``name``, if any."""
        return self.traces.get(name) if self.traces else None

    def drift_times(self) -> Tuple[float, ...]:
        """Every future instant (t > 0, ascending) at which some traced
        capacity steps — the event times a reactive online policy watches."""
        if not self.traces:
            return ()
        return tuple(sorted({
            t for trace in self.traces.values() for t in trace.times if t > 0
        }))

    # -- failures ----------------------------------------------------------
    def with_failures(self, events) -> "Substrate":
        """This substrate with a fault script: ``events`` is a
        :class:`FailureTrace` or an iterable of :class:`FailureEvent`\\ s.
        The executor fires each event against every job sharing the
        substrate; :meth:`at` folds the active failure state into the
        planning view (the fault analogue of :meth:`with_traces`)."""
        trace = events if isinstance(events, FailureTrace) \
            else FailureTrace(tuple(events))
        return dataclasses.replace(self, failures=trace)

    def failure_times(self) -> Tuple[float, ...]:
        """Every substrate-level failure/repair instant (t > 0, ascending)
        — decision times for a reactive online policy, like
        :meth:`drift_times`."""
        return self.failures.times() if self.failures else ()

    def partition_cut(self, cluster: int) -> Tuple[np.ndarray, np.ndarray]:
        """Boolean masks of the links a partition of ``cluster`` severs:
        ``(push_cut (nS, nM), shuffle_cut (nM, nR))`` — exactly the links
        with one endpoint inside the cluster and one outside."""
        s_in = self.cluster_s == cluster
        m_in = self.cluster_m == cluster
        r_in = self.cluster_r == cluster
        return (s_in[:, None] != m_in[None, :],
                m_in[:, None] != r_in[None, :])

    def at(self, t: float) -> "Substrate":
        """The capacities in force at absolute time ``t``: a plain (trace
        and failure free) substrate whose arrays fold every trace *and*
        every active failure in — the *current view* an online planner
        replans against.  Dead workers and partitioned links sit at
        ``FAILURE_EPS`` of nominal (until a partition's repair), so
        :func:`repro.core.optimize.replan_schedule` steers residual work
        around them without losing the softmax's escape mass."""
        if not self.traces and not self.failures:
            return self
        B_sm, B_mr = self.B_sm.copy(), self.B_mr.copy()
        C_m, C_r = self.C_m.copy(), self.C_r.copy()
        for key, trace in (self.traces or {}).items():
            m = _TRACE_KEY_RE.match(key)
            ps, pm, sm, sr, mm, rr = m.groups()
            if ps is not None:
                B_sm[int(ps), int(pm)] = trace.at(t)
            elif sm is not None:
                B_mr[int(sm), int(sr)] = trace.at(t)
            elif mm is not None:
                C_m[int(mm)] = trace.at(t)
            else:
                C_r[int(rr)] = trace.at(t)
        for ev in (self.failures or ()):
            if ev.time > t:
                continue
            if ev.kind == "mapper_kill":
                C_m[ev.node] *= FAILURE_EPS
                B_sm[:, ev.node] *= FAILURE_EPS
            elif ev.kind == "reducer_kill":
                C_r[ev.node] *= FAILURE_EPS
                B_mr[:, ev.node] *= FAILURE_EPS
            elif ev.t_repair is None or t < ev.t_repair:
                push_cut, shuf_cut = self.partition_cut(ev.cluster)
                B_sm = np.where(push_cut, B_sm * FAILURE_EPS, B_sm)
                B_mr = np.where(shuf_cut, B_mr * FAILURE_EPS, B_mr)
        return dataclasses.replace(
            self, B_sm=B_sm, B_mr=B_mr, C_m=C_m, C_r=C_r,
            traces=None, failures=None, name=f"{self.name}@{t:g}s",
        )

    def describe(self) -> str:
        drift = f" drifting@{len(self.traces)}" if self.traces else ""
        fail = f" failures@{len(self.failures)}" if self.failures else ""
        return (
            f"Substrate({self.name}: nS={self.nS} nM={self.nM} nR={self.nR}, "
            f"{len(self.resources())} resources{drift}{fail})"
        )


@dataclasses.dataclass(frozen=True)
class Platform:
    """A tripartite MapReduce platform (paper Figure 3): one job's slice of
    a (possibly shared) :class:`Substrate`.

    Attributes:
      D:     (nS,) data originating at each source, MB.
      B_sm:  (nS, nM) push-link bandwidth, MB/s.
      B_mr:  (nM, nR) shuffle-link bandwidth, MB/s.
      C_m:   (nM,) mapper compute rate, MB/s of input data.
      C_r:   (nR,) reducer compute rate, MB/s of input data.
      alpha: map output/input expansion factor.
      cluster_s/m/r: integer cluster (site) id per node — used by "local"
        heuristic plans and by the replication model; not used by the
        optimizer itself.
      substrate: the shared substrate this platform is a view of (set by
        :meth:`Substrate.view`); ``None`` for a standalone single-job
        platform, in which case :meth:`Substrate.of` lifts one on demand.
    """

    D: np.ndarray
    B_sm: np.ndarray
    B_mr: np.ndarray
    C_m: np.ndarray
    C_r: np.ndarray
    alpha: float
    cluster_s: np.ndarray
    cluster_m: np.ndarray
    cluster_r: np.ndarray
    name: str = "platform"
    substrate: Optional[Substrate] = None

    def __post_init__(self):
        object.__setattr__(self, "D", require_finite("D", self.D))
        for field in ("B_sm", "B_mr", "C_m", "C_r"):
            object.__setattr__(
                self, field, require_positive(field, getattr(self, field))
            )
        nS, nM = self.B_sm.shape
        nM2, nR = self.B_mr.shape
        if nM != nM2:
            raise ValueError(f"B_sm/B_mr mapper dims disagree: {nM} vs {nM2}")
        if self.D.shape != (nS,):
            raise ValueError(f"D shape {self.D.shape} != ({nS},)")
        if self.C_m.shape != (nM,):
            raise ValueError(f"C_m shape {self.C_m.shape} != ({nM},)")
        if self.C_r.shape != (nR,):
            raise ValueError(f"C_r shape {self.C_r.shape} != ({nR},)")
        if np.any(self.D < 0):
            raise ValueError("negative data size")
        if self.alpha <= 0:
            raise ValueError("alpha must be > 0")

    # -- sizes ------------------------------------------------------------
    @property
    def nS(self) -> int:
        return self.D.shape[0]

    @property
    def nM(self) -> int:
        return self.B_sm.shape[1]

    @property
    def nR(self) -> int:
        return self.B_mr.shape[1]

    def with_alpha(self, alpha: float) -> "Platform":
        return dataclasses.replace(self, alpha=float(alpha))

    def as_arrays(self):
        """Arrays in the order makespan() expects."""
        return (self.D, self.B_sm, self.B_mr, self.C_m, self.C_r, self.alpha)

    def total_data(self) -> float:
        return float(self.D.sum())

    def describe(self) -> str:
        return (
            f"Platform({self.name}: nS={self.nS} nM={self.nM} nR={self.nR} "
            f"D_total={self.total_data():.0f}MB alpha={self.alpha})"
        )


# ---------------------------------------------------------------------------
# §1.3 worked example
# ---------------------------------------------------------------------------

def two_cluster_example(
    alpha: float = 1.0,
    local_bw: float = 100.0,
    nonlocal_bw: float = 100.0,
    compute: float = 100.0,
    d1: float = 150_000.0,
    d2: float = 50_000.0,
) -> Platform:
    """The two-cluster example of paper §1.3.

    Two clusters, each with one source, one mapper, one reducer.  D1=150 GB,
    D2=50 GB (expressed in MB).  Local (intra-cluster) links run at
    ``local_bw`` MB/s, non-local at ``nonlocal_bw`` MB/s; every compute node
    processes ``compute`` MB/s.
    """
    local = np.array([[local_bw, nonlocal_bw], [nonlocal_bw, local_bw]])
    return Platform(
        D=np.array([d1, d2]),
        B_sm=local.copy(),
        B_mr=local.copy(),
        C_m=np.array([compute, compute]),
        C_r=np.array([compute, compute]),
        alpha=alpha,
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name=f"two_cluster(alpha={alpha},nl={nonlocal_bw})",
    )


# ---------------------------------------------------------------------------
# PlanetLab environments (paper §3.2/§4.1, Table 1)
# ---------------------------------------------------------------------------

#: The eight PlanetLab sites used in the paper (§4.1), with their continent.
PLANETLAB_SITES: Tuple[Tuple[str, str], ...] = (
    ("ucsb.edu", "US"),
    ("tamu.edu", "US"),
    ("hpl.hp.com", "US"),
    ("uiuc.edu", "US"),
    ("tkn.tu-berlin.de", "EU"),
    ("essex.ac.uk", "EU"),
    ("pnl.nitech.ac.jp", "Asia"),
    ("wide.ad.jp", "Asia"),
)

#: Table 1 — measured slowest/fastest inter-cluster bandwidth in KB/s.
TABLE1_BANDWIDTH_KBPS = {
    ("US", "US"): (216.0, 9405.0),
    ("US", "EU"): (110.0, 2267.0),
    ("US", "Asia"): (61.0, 3305.0),
    ("EU", "US"): (794.0, 2734.0),
    ("EU", "EU"): (4475.0, 11053.0),
    ("EU", "Asia"): (1502.0, 1593.0),
    ("Asia", "US"): (401.0, 3610.0),
    ("Asia", "EU"): (290.0, 1071.0),
    ("Asia", "Asia"): (23762.0, 23875.0),
}

#: Gigabit-Ethernet LAN bandwidth for intra-site links (the paper's emulated
#: testbed interconnect), MB/s.
LAN_BW_MBPS = 117.0

#: Unscaled compute-rate range measured on PlanetLab nodes (§3.2), MB/s.
COMPUTE_RATE_RANGE = (9.0, 90.0)


def _site_list(n_datacenters: int) -> Tuple[Tuple[str, str], ...]:
    if n_datacenters == 1:
        # Local data center: eight replica nodes at tamu.edu.
        return tuple([("tamu.edu", "US")] * 8)
    if n_datacenters == 2:
        # Intra-continental: tamu.edu + ucsb.edu, 4 replicas each.
        return tuple([("tamu.edu", "US")] * 4 + [("ucsb.edu", "US")] * 4)
    if n_datacenters == 4:
        # Global 4: ucsb, tamu, tu-berlin, nitech; 2 replicas each.
        sites = [
            ("ucsb.edu", "US"),
            ("tamu.edu", "US"),
            ("tkn.tu-berlin.de", "EU"),
            ("pnl.nitech.ac.jp", "Asia"),
        ]
        return tuple(s for s in sites for _ in range(2))
    if n_datacenters == 8:
        return PLANETLAB_SITES
    raise ValueError("n_datacenters must be one of {1, 2, 4, 8}")


def planetlab_platform(
    n_datacenters: int = 8,
    alpha: float = 1.0,
    data_per_source_mb: float = 256.0,
    seed: int = 0,
    compute_heterogeneity: bool = True,
) -> Platform:
    """Generate a PlanetLab-like environment per paper §4.1.

    Eight nodes total regardless of ``n_datacenters`` (replicas fill in when
    there are fewer real sites).  Each node hosts one source, one mapper and
    one reducer.  Inter-site bandwidth is sampled log-uniformly within the
    Table 1 (slowest, fastest) range for the continent pair; intra-site links
    run at LAN speed.  Compute rates are sampled in the measured 9–90 MB/s
    range (or fixed at the midpoint when ``compute_heterogeneity=False``).
    """
    rng = np.random.default_rng(seed)
    sites = _site_list(n_datacenters)
    n = len(sites)
    site_ids = np.array(
        [sorted({s for s, _ in sites}).index(s) for s, _ in sites], dtype=np.int64
    )

    # one measurement per unique site pair / per unique site: replica nodes
    # share their original's characteristics (paper §4.1: "we added replica
    # nodes ... with the measured node/link characteristics of the
    # corresponding real nodes") — a single-DC environment is therefore
    # genuinely homogeneous.
    pair_bw: dict = {}

    def site_pair_bw(si, ci, sj, cj) -> float:
        key = (si, sj)
        if key not in pair_bw:
            lo, hi = TABLE1_BANDWIDTH_KBPS[(ci, cj)]
            pair_bw[key] = float(
                np.exp(rng.uniform(np.log(lo), np.log(hi)))
            ) / 1024.0  # KB/s -> MB/s
        return pair_bw[key]

    bw = np.zeros((n, n))
    for i, (si, ci) in enumerate(sites):
        for j, (sj, cj) in enumerate(sites):
            if si == sj:
                bw[i, j] = LAN_BW_MBPS
            else:
                bw[i, j] = site_pair_bw(si, ci, sj, cj)

    lo, hi = COMPUTE_RATE_RANGE
    site_rate: dict = {}

    def rate_for(site):
        if site not in site_rate:
            site_rate[site] = (
                float(np.exp(rng.uniform(np.log(lo), np.log(hi)))),
                float(np.exp(rng.uniform(np.log(lo), np.log(hi)))),
            )
        return site_rate[site]

    if compute_heterogeneity:
        C_m = np.array([rate_for(s)[0] for s, _ in sites])
        C_r = np.array([rate_for(s)[1] for s, _ in sites])
    else:
        mid = float(np.mean(COMPUTE_RATE_RANGE))
        C_m = np.full(n, mid)
        C_r = np.full(n, mid)

    return Platform(
        D=np.full(n, data_per_source_mb),
        B_sm=bw.copy(),
        B_mr=bw.copy(),
        C_m=C_m,
        C_r=C_r,
        alpha=alpha,
        cluster_s=site_ids,
        cluster_m=site_ids,
        cluster_r=site_ids,
        name=f"planetlab_{n_datacenters}dc",
    )


# ---------------------------------------------------------------------------
# TPU pod environments — the paper's platform model applied to a TPU fleet
# ---------------------------------------------------------------------------

def tpu_pod_platform(
    n_pods: int = 2,
    hosts_per_pod: int = 4,
    alpha: float = 1.0,
    data_per_source_mb: float = 65536.0,
    ici_bw_mbps: float = 50_000.0,
    dcn_bw_mbps: float = 6_400.0,
    ingest_bw_mbps: float = 3_200.0,
    compute_rate_mbps: float = 25_000.0,
    compute_jitter: float = 0.0,
    seed: int = 0,
) -> Platform:
    """A TPU fleet as the paper's highly-distributed platform.

    Sources are data-ingest hosts (one per host), mappers/reducers are pod
    slices.  Intra-pod links use ICI bandwidth, inter-pod links use DCN, and
    source→mapper links are bounded by host ingest NICs (min with the
    network path).  ``compute_jitter`` > 0 models heterogeneous effective
    throughput (multi-tenancy / thermal throttling), sampled log-normally.
    """
    rng = np.random.default_rng(seed)
    n = n_pods * hosts_per_pod
    pod = np.repeat(np.arange(n_pods), hosts_per_pod)

    same_pod = pod[:, None] == pod[None, :]
    net = np.where(same_pod, ici_bw_mbps, dcn_bw_mbps).astype(np.float64)
    B_sm = np.minimum(net, ingest_bw_mbps)
    B_mr = net.copy()

    def rates():
        if compute_jitter > 0:
            return compute_rate_mbps * np.exp(
                rng.normal(0.0, compute_jitter, size=n)
            )
        return np.full(n, compute_rate_mbps)

    return Platform(
        D=np.full(n, data_per_source_mb),
        B_sm=B_sm,
        B_mr=B_mr,
        C_m=rates(),
        C_r=rates(),
        alpha=alpha,
        cluster_s=pod.copy(),
        cluster_m=pod.copy(),
        cluster_r=pod.copy(),
        name=f"tpu_{n_pods}pods",
    )
