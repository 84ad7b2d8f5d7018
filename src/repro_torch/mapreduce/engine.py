"""Plan-driven MapReduce engine.

Executes a MapReduce application under an explicit execution plan
(:class:`repro.core.plan.ExecutionPlan`), enforcing the paper's three Hadoop
modifications (§3.1):

* **coupled placement/execution** (LocalOnly): a mapper processes exactly
  the records pushed to it, a reducer exactly its key buckets;
* **plan-controlled push**: source ``i`` sends fraction ``x_ij`` of its
  records to mapper ``j`` (contiguous deterministic split);
* **plan-controlled shuffle**: intermediate keys are hashed into many small
  buckets and buckets are assigned to reducers proportionally to ``y_k``
  (:func:`repro.mapreduce.partition.bucket_owners`).

The engine runs the *actual computation* (real maps/reduces over real
records, with the Pallas ``segment_sum`` kernel in the reduce hot loop) and
records the *actual bytes* moved per link per phase.  Wall-clock makespan on
a modeled platform is obtained by pricing those measured byte/compute
volumes through the **shared cost model**
(:class:`repro.core.makespan.CostModel` — the exact same equations the
planner optimizes, with measured quantities replacing the analytic
``D_i·x_ij`` terms, so model and measurement cannot diverge).  This is how
the Fig-9 benchmark drives real applications over the emulated PlanetLab
network, exactly in the spirit of the paper's ``tc``-emulated testbed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.makespan import CostModel
from ..core.plan import ExecutionPlan
from ..core.platform import Platform
from .partition import bucket_owners, hash_keys

__all__ = ["MRApp", "GeoMapReduce", "PhaseStats"]

Records = Tuple[np.ndarray, np.ndarray]  # (keys int64 (N,), values (N,) or (N,D))


def _empty_records_like(records: Sequence[Records]) -> Records:
    """Zero-length ``(keys, values)`` whose dtype and trailing value shape
    match the app's actual records (preferring a non-empty pair), so empty
    partitions concatenate cleanly with float / vector-valued loads."""
    proto: Optional[Records] = None
    for k, v in records:
        proto = (k, v)
        if k.shape[0]:
            break
    if proto is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k, v = proto
    return np.asarray(k)[:0], np.asarray(v)[:0]


@dataclasses.dataclass(frozen=True)
class MRApp:
    """A MapReduce application.

    map_fn: (keys, values) -> (out_keys, out_values) — vectorized.
    reduce_fn: (sorted_keys, values_in_key_order) -> (keys, values) —
      applied per reducer on its full, key-sorted partition.
    record_bytes / intermediate_record_bytes: accounting sizes.
    """

    name: str
    map_fn: Callable[[np.ndarray, np.ndarray], Records]
    reduce_fn: Callable[[np.ndarray, np.ndarray], Records]
    record_bytes: int = 8
    intermediate_record_bytes: int = 8


@dataclasses.dataclass
class PhaseStats:
    push_bytes: np.ndarray  # (nS, nM)
    map_in_bytes: np.ndarray  # (nM,)
    shuffle_bytes: np.ndarray  # (nM, nR)
    reduce_in_bytes: np.ndarray  # (nR,)
    alpha_measured: float

    def volumes_mb(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Measured per-phase volumes in the MB units the cost model prices."""
        MB = 1e6
        return (
            self.push_bytes / MB,
            self.map_in_bytes / MB,
            self.shuffle_bytes / MB,
            self.reduce_in_bytes / MB,
        )

    def makespan(
        self, platform: Platform, barriers: Tuple[str, str, str] = ("G", "G", "L")
    ) -> Dict[str, float]:
        """Price the measured byte volumes through the shared
        :class:`repro.core.makespan.CostModel` (which also validates the
        barrier triple)."""
        return CostModel(platform, barriers).breakdown_volumes(*self.volumes_mb())


class GeoMapReduce:
    def __init__(
        self,
        platform: Platform,
        plan: ExecutionPlan,
        app: MRApp,
        n_buckets: int = 512,
        use_kernel_reduce: bool = True,
    ):
        assert plan.nS == platform.nS and plan.nM == platform.nM
        self.platform, self.plan, self.app = platform, plan, app
        self.n_buckets = n_buckets
        self.owners = bucket_owners(plan.y, n_buckets)
        self.use_kernel_reduce = use_kernel_reduce

    # -- phases ------------------------------------------------------------
    def _push(self, per_source: Sequence[Records]):
        """Split each source's records into contiguous chunks per x_ij."""
        nS, nM = self.plan.nS, self.plan.nM
        incoming: List[List[Records]] = [[] for _ in range(nM)]
        push_bytes = np.zeros((nS, nM))
        for i, (keys, values) in enumerate(per_source):
            n = keys.shape[0]
            # largest-remainder split of n records by x row
            raw = self.plan.x[i] * n
            counts = np.floor(raw).astype(np.int64)
            for idx in np.argsort(-(raw - counts))[: n - counts.sum()]:
                counts[idx] += 1
            off = 0
            for j in range(nM):
                c = int(counts[j])
                if c:
                    incoming[j].append((keys[off : off + c], values[off : off + c]))
                    push_bytes[i, j] = c * self.app.record_bytes
                off += c
        merged = []
        for j in range(nM):
            if incoming[j]:
                ks = np.concatenate([k for k, _ in incoming[j]])
                vs = np.concatenate([v for _, v in incoming[j]])
            else:
                ks, vs = _empty_records_like(per_source)
            merged.append((ks, vs))
        return merged, push_bytes

    def _map(self, per_mapper: Sequence[Records]):
        out = []
        in_bytes = np.zeros(len(per_mapper))
        for j, (keys, values) in enumerate(per_mapper):
            in_bytes[j] = keys.shape[0] * self.app.record_bytes
            mk, mv = self.app.map_fn(keys, values)
            out.append((np.asarray(mk, np.int64), np.asarray(mv)))
        return out, in_bytes

    def _shuffle(self, mapped: Sequence[Records]):
        nM, nR = self.plan.nM, self.plan.nR
        shuffle_bytes = np.zeros((nM, nR))
        to_reducer: List[List[Records]] = [[] for _ in range(nR)]
        for j, (mk, mv) in enumerate(mapped):
            if mk.shape[0] == 0:
                continue
            buckets = hash_keys(mk, self.n_buckets)
            dest = self.owners[buckets]
            order = np.argsort(dest, kind="stable")
            dk, dv, dd = mk[order], mv[order], dest[order]
            bounds = np.searchsorted(dd, np.arange(nR + 1))
            for k in range(nR):
                lo, hi = bounds[k], bounds[k + 1]
                if hi > lo:
                    to_reducer[k].append((dk[lo:hi], dv[lo:hi]))
                    shuffle_bytes[j, k] = (
                        (hi - lo) * self.app.intermediate_record_bytes
                    )
        merged = []
        for k in range(nR):
            if to_reducer[k]:
                ks = np.concatenate([a for a, _ in to_reducer[k]])
                vs = np.concatenate([b for _, b in to_reducer[k]])
            else:
                ks, vs = _empty_records_like(mapped)
            merged.append((ks, vs))
        return merged, shuffle_bytes

    def _reduce(self, per_reducer: Sequence[Records]):
        outs = []
        in_bytes = np.zeros(len(per_reducer))
        for k, (keys, values) in enumerate(per_reducer):
            in_bytes[k] = keys.shape[0] * self.app.intermediate_record_bytes
            if keys.shape[0] == 0:
                outs.append((keys, values))
                continue
            order = np.argsort(keys, kind="stable")
            outs.append(self.app.reduce_fn(keys[order], values[order]))
        return outs, in_bytes

    # -- run ----------------------------------------------------------------
    def run(self, per_source: Sequence[Records]):
        """Execute; returns (per-reducer outputs, PhaseStats)."""
        per_mapper, push_bytes = self._push(per_source)
        mapped, map_in = self._map(per_mapper)
        per_reducer, shuffle_bytes = self._shuffle(mapped)
        outs, reduce_in = self._reduce(per_reducer)
        total_in = max(map_in.sum(), 1e-9)
        stats = PhaseStats(
            push_bytes=push_bytes,
            map_in_bytes=map_in,
            shuffle_bytes=shuffle_bytes,
            reduce_in_bytes=reduce_in,
            alpha_measured=float(reduce_in.sum() / total_in),
        )
        return outs, stats
