"""Flow-level (fluid) executor: the scale-tier fast path.

The chunk-granular DES in :mod:`repro.core.simulate` prices every chunk
service as an event — faithful, but at 10^2–10^3 nodes with ~10^2
concurrent jobs the event count itself becomes the wall.  This module
trades chunk granularity for *flows*: each job's remaining volume moves
as a continuous fluid served at shared rates (every resource splits its
capacity equally across the jobs with backlog on it — the fluid limit of
the DES's round-robin FIFO), and the engine only steps at *rate-change
events*: a flow empties, a barrier gate opens, a job releases.  Makespan
error against the per-chunk DES is bounded by chunk granularity (the
cross-validation suite holds it ≤ 2% on the 27 barrier triples).

The model keeps the same three-layer pipeline and per-job barrier
semantics one level up from chunks:

* **push** — per-(source, mapper) flows drain at the link's fair share;
  arrivals accumulate at the mapper (gated by the push/map barrier:
  ``P`` serves as it lands, ``L`` opens per mapper when that mapper's
  inbound flows empty, ``G`` when all of the job's push empties).
* **map** — mapper capacity is fair-shared per job (divided by any
  straggler slowdown); output (``alpha`` × mapped volume) is emitted
  into per-(mapper, reducer) shuffle flows split by ``y`` — immediately
  (``P``) or when the map/shuffle gate opens (``L``/``G``).
* **shuffle / reduce** — same discipline one layer down.

:class:`FluidSim` exposes the *same* control surface as the event
engine — ``run_until`` / ``snapshot`` / ``swap_plan`` / ``inject`` /
``run`` returning the same :class:`ScheduleSimResult` shape — so
``run_online`` / ``replan_schedule`` drive it unchanged.  Because flows
are continuous, plan swaps are exact re-splits (no chunk re-assignment
residue).  :class:`~repro.core.platform.CapacityTrace` drift is
supported natively: a rate step is just another piecewise-linear event,
so the engine folds ``Substrate.drift_times()`` into its event horizon
and re-reads capacities at each step.  Event-mode dynamics that are
inherently chunk-granular (speculation, stealing, worker failure,
compute noise, replication) and pipeline stage links are rejected at
construction with a pointer back to ``mode="event"``.

Only resources a job's plan touches are materialized (no per-pair
objects), so construction is O(flows), not O(nodes²) — the property
that makes the 1000-node tier tractable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from typing import Dict, List, Optional, Sequence, Tuple

from .makespan import JobProgress, _live_plan_arrays
from .plan import ExecutionPlan
from .platform import Platform, Substrate
from .simulate import (
    ProgressSnapshot,
    ResourceStats,
    ScheduleSimResult,
    SimConfig,
    SimResult,
)

__all__ = ["FluidSim", "fluid_score_residual"]

#: volume below which a flow/buffer counts as drained (MB)
_EPS = 1e-6
#: hard cap on rate-change events — a correct run needs O(flows)
_MAX_EVENTS = 2_000_000


class _FluidJob:
    """Per-job fluid state: static plan tables plus phase timestamps.
    Flow volumes live in the engine's flat arrays (see
    :meth:`FluidSim._rebuild`)."""

    def __init__(self, idx: int, platform: Platform, plan: ExecutionPlan,
                 cfg: SimConfig, nM: int, nR: int):
        self.idx = idx
        self.p = platform
        self.plan = plan
        self.cfg = cfg
        self.seeded = False
        self.done = False
        # static per-job flow specs, rebuilt into the flat arrays:
        # push [(src, dst, remaining_mb)], shuffle [(j, k, y_share, rem)]
        self.push_spec: List[List[float]] = []
        self.shuf_spec: List[List[float]] = []
        self.push_end = 0.0
        self.map_end = 0.0
        self.shuffle_end = 0.0
        self.reduce_end = 0.0
        self._push_done = False
        self._map_done = False
        self._shuffle_done = False

    def result(self) -> SimResult:
        return SimResult(
            makespan=self.reduce_end,
            push_end=self.push_end,
            map_end=self.map_end,
            shuffle_end=self.shuffle_end,
            reduce_end=self.reduce_end,
            wasted_mb=0.0,
            recovered_chunks=0,
            total_map_chunks=0,
        )


class _TierStats:
    """Flat per-resource accounting for one tier (push links, mappers,
    shuffle links, reducers) — materialized into named
    :class:`ResourceStats` only for resources that served volume."""

    def __init__(self, n: int, cap: np.ndarray):
        self.cap = np.asarray(cap, dtype=np.float64).reshape(-1)
        self.busy = np.zeros(n)
        self.wait = np.zeros(n)
        self.vol = np.zeros(n)
        self.n_done = np.zeros(n, dtype=np.int64)
        self.first = np.full(n, np.inf)
        self.last = np.zeros(n)
        self.jobs: Dict[int, set] = {}

    def advance(self, served_rate: np.ndarray, backlog: np.ndarray,
                now: float, dt: float) -> None:
        """Integrate one constant-rate interval: ``busy`` is the served
        fraction of capacity, ``wait`` the backlog drain-age integral
        (``∫ backlog/capacity dt`` — the fluid analogue of the DES's
        queued chunk-seconds)."""
        on = served_rate > 0.0
        if not on.any():
            return
        self.busy[on] += served_rate[on] / self.cap[on] * dt
        self.vol[on] += served_rate[on] * dt
        self.wait[on] += backlog[on] / self.cap[on] * dt
        np.minimum(self.first, np.where(on, now, np.inf), out=self.first)
        self.last[on] = now + dt

    def touch(self, rid: int, job: int) -> None:
        self.jobs.setdefault(rid, set()).add(job)

    def emit(self, out: Dict[str, ResourceStats], name) -> None:
        for rid in np.flatnonzero((self.vol > 0) | (self.busy > 0)):
            rid = int(rid)
            out[name(rid)] = ResourceStats(
                busy_s=float(self.busy[rid]),
                waited_s=float(self.wait[rid]),
                volume_mb=float(self.vol[rid]),
                n_chunks=int(self.n_done[rid]),
                jobs=set(self.jobs.get(rid, ())),
                first_busy_s=float(self.first[rid]),
                last_busy_s=float(self.last[rid]),
            )


class FluidSim:
    """Flow-level multi-job engine over one substrate — drop-in for
    :class:`repro.core.simulate._MultiSim` on frozen or online-steered
    schedules (``SimConfig(mode="fluid")``)."""

    def __init__(self, substrate: Substrate,
                 entries: Sequence[Tuple[Platform, ExecutionPlan,
                                         SimConfig]]):
        self.sub = substrate
        self.now = 0.0
        self._started = False
        self.violations: List[str] = []
        self.runs: List[_FluidJob] = []
        nS, nM, nR = substrate.nS, substrate.nM, substrate.nR
        self.nS, self.nM, self.nR = nS, nM, nR
        if getattr(substrate, "failures", None):
            raise ValueError(
                "fluid mode does not support a substrate FailureTrace — "
                "failure recovery is chunk-event-granular; use SimConfig("
                'mode="event")'
            )
        # CapacityTrace drift folds into the event horizon: rates are
        # piecewise-constant between drift steps, so every step is just
        # one more rate-change event (_refresh_caps re-reads the folded
        # capacities, _next_dt never integrates across a step)
        self._drift = tuple(substrate.drift_times())
        self._drift_i = 0
        sub0 = substrate.at(0.0)
        self._B_sm = np.asarray(sub0.B_sm, dtype=np.float64)
        self._B_mr = np.asarray(sub0.B_mr, dtype=np.float64)
        self._C_m = np.asarray(sub0.C_m, dtype=np.float64)
        self._C_r = np.asarray(sub0.C_r, dtype=np.float64)
        self._st_push = _TierStats(nS * nM, self._B_sm)
        self._st_map = _TierStats(nM, self._C_m)
        self._st_shuf = _TierStats(nM * nR, self._B_mr)
        self._st_red = _TierStats(nR, self._C_r)

        # flat flow arrays (rebuilt on structural change)
        self._pf_job = np.zeros(0, dtype=np.int64)
        self._pf_src = np.zeros(0, dtype=np.int64)
        self._pf_dst = np.zeros(0, dtype=np.int64)
        self._pf_rem = np.zeros(0)
        self._sf_job = np.zeros(0, dtype=np.int64)
        self._sf_j = np.zeros(0, dtype=np.int64)
        self._sf_k = np.zeros(0, dtype=np.int64)
        self._sf_y = np.zeros(0)
        self._sf_rem = np.zeros(0)

        # per-job buffers / gates (rows grow on inject)
        self._at_map = np.zeros((0, nM))
        self._gated_map = np.zeros((0, nM))
        self._pool = np.zeros((0, nM))
        self._at_red = np.zeros((0, nR))
        self._gated_red = np.zeros((0, nR))
        self._open_map = np.zeros((0, nM), dtype=bool)
        self._open_em = np.zeros((0, nM), dtype=bool)
        self._open_red = np.zeros((0, nR), dtype=bool)
        self._released = np.zeros(0, dtype=bool)
        # push-service priority = seeding order (FIFO release order)
        self._prio = np.zeros(0, dtype=np.int64)
        self._seed_seq = 0
        self._alpha = np.zeros(0)
        self._slow_m = np.zeros((0, nM))
        self._slow_r = np.zeros((0, nR))
        self._audit = False
        for platform, plan, cfg in entries:
            self._admit(platform, plan, cfg)

    # -- construction ------------------------------------------------------
    def _admit(self, platform: Platform, plan: ExecutionPlan,
               cfg: SimConfig) -> int:
        if cfg.mode != "fluid":
            raise ValueError(
                "every job of a fluid schedule must set SimConfig("
                f'mode="fluid"), got mode={cfg.mode!r}'
            )
        bad = [name for name, flag in (
            ("speculation", cfg.speculation),
            ("stealing", cfg.stealing),
            ("failures", bool(cfg.failures)),
            ("compute_noise", cfg.compute_noise > 0),
            ("replication>1", cfg.replication != 1),
        ) if flag]
        if bad:
            raise ValueError(
                f"fluid mode: {'/'.join(bad)} is chunk-granular — use "
                'SimConfig(mode="event")'
            )
        g = _FluidJob(len(self.runs), platform, plan, cfg,
                      self.nM, self.nR)
        self.runs.append(g)
        self._audit = self._audit or cfg.audit
        nM, nR = self.nM, self.nR
        self._at_map = np.vstack([self._at_map, np.zeros((1, nM))])
        self._gated_map = np.vstack([self._gated_map, np.zeros((1, nM))])
        self._pool = np.vstack([self._pool, np.zeros((1, nM))])
        self._at_red = np.vstack([self._at_red, np.zeros((1, nR))])
        self._gated_red = np.vstack([self._gated_red, np.zeros((1, nR))])
        self._open_map = np.vstack(
            [self._open_map, np.zeros((1, nM), dtype=bool)])
        self._open_em = np.vstack(
            [self._open_em, np.zeros((1, nM), dtype=bool)])
        self._open_red = np.vstack(
            [self._open_red, np.zeros((1, nR), dtype=bool)])
        self._released = np.append(self._released, False)
        self._prio = np.append(self._prio, np.iinfo(np.int64).max)
        self._alpha = np.append(self._alpha, float(platform.alpha))
        self._slow_m = np.vstack([self._slow_m, [[
            cfg.stragglers.get(("m", j), 1.0) if cfg.stragglers else 1.0
            for j in range(nM)]]])
        self._slow_r = np.vstack([self._slow_r, [[
            cfg.stragglers.get(("r", k), 1.0) if cfg.stragglers else 1.0
            for k in range(nR)]]])
        return g.idx

    def _seed(self, g: _FluidJob) -> None:
        """Materialize the job's flows from its (current) plan."""
        self._writeback()  # preserve in-flight volumes across the rebuild
        gi = g.idx
        D = np.asarray(g.p.D, dtype=np.float64)
        x = np.asarray(g.plan.x, dtype=np.float64)
        y = np.asarray(g.plan.y, dtype=np.float64)
        g.push_spec = []
        for i in np.flatnonzero(D > _EPS):
            for j in np.flatnonzero(x[i] > 1e-9):
                vol = float(D[i] * x[i, j])
                if vol > _EPS:
                    g.push_spec.append([int(i), int(j), vol])
                    self._st_push.touch(int(i) * self.nM + int(j), gi)
                    self._st_map.touch(int(j), gi)
        dests = sorted({int(j) for _, j, _ in g.push_spec})
        ky = np.flatnonzero(y > 1e-9)
        ysum = float(y[ky].sum()) or 1.0
        g.shuf_spec = []
        for j in dests:
            for k in ky:
                g.shuf_spec.append([int(j), int(k), float(y[k] / ysum),
                                    0.0])
                self._st_shuf.touch(int(j) * self.nR + int(k), gi)
                self._st_red.touch(int(k), gi)
        g.seeded = True
        self._released[gi] = True
        self._prio[gi] = self._seed_seq
        self._seed_seq += 1
        b0, b1, b2 = g.cfg.barriers
        self._open_map[gi] = b0 == "P"
        self._open_em[gi] = b1 == "P"
        self._open_red[gi] = b2 == "P"
        if not g.push_spec:  # degenerate zero-volume job
            g.push_end = g.map_end = g.shuffle_end = g.reduce_end = self.now
            g._push_done = g._map_done = g._shuffle_done = True
            g.done = True
        self._rebuild()

    def _rebuild(self) -> None:
        """Flatten every seeded job's flow specs into the global arrays
        (called on seed / inject / swap — rare, O(flows))."""
        pj, ps, pd, pr = [], [], [], []
        sj, sjj, sk, sy, sr = [], [], [], [], []
        for g in self.runs:
            if not g.seeded or g.done:
                continue
            for i, j, rem in g.push_spec:
                pj.append(g.idx)
                ps.append(i)
                pd.append(j)
                pr.append(rem)
            for j, k, yk, rem in g.shuf_spec:
                sj.append(g.idx)
                sjj.append(j)
                sk.append(k)
                sy.append(yk)
                sr.append(rem)
        self._pf_job = np.asarray(pj, dtype=np.int64)
        self._pf_src = np.asarray(ps, dtype=np.int64)
        self._pf_dst = np.asarray(pd, dtype=np.int64)
        self._pf_rem = np.asarray(pr, dtype=np.float64)
        self._sf_job = np.asarray(sj, dtype=np.int64)
        self._sf_j = np.asarray(sjj, dtype=np.int64)
        self._sf_k = np.asarray(sk, dtype=np.int64)
        self._sf_y = np.asarray(sy, dtype=np.float64)
        self._sf_rem = np.asarray(sr, dtype=np.float64)

    def _writeback(self) -> None:
        """Mirror the flat remaining volumes back into the per-job specs
        (before a structural rebuild)."""
        cursor_p: Dict[int, int] = {}
        for n, gi in enumerate(self._pf_job):
            g = self.runs[gi]
            c = cursor_p.get(gi, 0)
            g.push_spec[c][2] = float(self._pf_rem[n])
            cursor_p[gi] = c + 1
        cursor_s: Dict[int, int] = {}
        for n, gi in enumerate(self._sf_job):
            g = self.runs[gi]
            c = cursor_s.get(gi, 0)
            g.shuf_spec[c][3] = float(self._sf_rem[n])
            cursor_s[gi] = c + 1

    # -- the fluid step ----------------------------------------------------
    def _rates(self):
        """Piecewise-constant service rates for the current state, in
        pipeline order (downstream inflow = upstream service)."""
        nJ, nM, nR = len(self.runs), self.nM, self.nR
        rel = self._released

        # push links: the DES seeds a job's entire push backlog at its
        # release instant, so a shared link drains jobs in strict FIFO
        # release order — model that as priority service (the earliest-
        # seeded job with backlog owns the link), not processor sharing
        pact = self._pf_rem > _EPS
        prate = np.zeros(self._pf_rem.shape[0])
        lid = self._pf_src * nM + self._pf_dst
        if pact.any():
            fprio = self._prio[self._pf_job]
            best = np.full(self.nS * nM, np.iinfo(np.int64).max)
            np.minimum.at(best, lid[pact], fprio[pact])
            serve = pact & (fprio == best[lid])
            prate[serve] = self._B_sm.reshape(-1)[lid[serve]]
        ar = np.zeros((nJ, nM))
        if pact.any():
            np.add.at(ar, (self._pf_job[pact], self._pf_dst[pact]),
                      prate[pact])

        inflow_m = np.where(self._open_map, ar, 0.0)
        elig = ((self._at_map > _EPS) | (inflow_m > 0.0)) & rel[:, None]
        m_rate = np.zeros((nJ, nM))
        if elig.any():
            cnt = elig.sum(axis=0)
            share = np.where(cnt > 0, self._C_m / np.maximum(cnt, 1), 0.0)
            m_rate = np.where(elig, share[None, :] / self._slow_m, 0.0)
            # an empty buffer serves no faster than it fills
            m_rate = np.where(self._at_map > _EPS, m_rate,
                              np.minimum(m_rate, inflow_m))

        emit = self._alpha[:, None] * m_rate
        e_open = np.where(self._open_em, emit, 0.0)
        pool_rate = emit - e_open
        inflow_sf = e_open[self._sf_job, self._sf_j] * self._sf_y

        sact = (self._sf_rem > _EPS) | (inflow_sf > 0.0)
        srate = np.zeros(self._sf_rem.shape[0])
        lid2 = self._sf_j * nR + self._sf_k
        if sact.any():
            cnt = np.bincount(lid2[sact], minlength=nM * nR)
            srate[sact] = self._B_mr.reshape(-1)[lid2[sact]] \
                / cnt[lid2[sact]]
            srate = np.where(self._sf_rem > _EPS, srate,
                             np.minimum(srate, inflow_sf))

        sr = np.zeros((nJ, nR))
        if sact.any():
            np.add.at(sr, (self._sf_job[sact], self._sf_k[sact]),
                      srate[sact])
        inflow_r = np.where(self._open_red, sr, 0.0)
        elig_r = ((self._at_red > _EPS) | (inflow_r > 0.0)) & rel[:, None]
        r_rate = np.zeros((nJ, nR))
        if elig_r.any():
            cnt = elig_r.sum(axis=0)
            share = np.where(cnt > 0, self._C_r / np.maximum(cnt, 1), 0.0)
            r_rate = np.where(elig_r, share[None, :] / self._slow_r, 0.0)
            r_rate = np.where(self._at_red > _EPS, r_rate,
                              np.minimum(r_rate, inflow_r))
        return prate, ar, inflow_m, m_rate, pool_rate, inflow_sf, srate, \
            sr, inflow_r, r_rate

    def _next_dt(self, prate, inflow_m, m_rate, inflow_sf, srate,
                 inflow_r, r_rate, t_cap: Optional[float]) -> float:
        """Time to the next rate-change event: some flow or buffer hits
        empty, a job releases, or the caller's horizon lands."""
        dt = np.inf
        on = prate > 0.0
        if on.any():
            dt = min(dt, float((self._pf_rem[on] / prate[on]).min()))
        net = m_rate - inflow_m
        zc = (net > 0.0) & (self._at_map > _EPS)
        if zc.any():
            dt = min(dt, float((self._at_map[zc] / net[zc]).min()))
        net = srate - inflow_sf
        zc = (net > 0.0) & (self._sf_rem > _EPS)
        if zc.any():
            dt = min(dt, float((self._sf_rem[zc] / net[zc]).min()))
        net = r_rate - inflow_r
        zc = (net > 0.0) & (self._at_red > _EPS)
        if zc.any():
            dt = min(dt, float((self._at_red[zc] / net[zc]).min()))
        pending = [g.cfg.start_time for g in self.runs
                   if not g.seeded and g.cfg.start_time > self.now]
        if pending:
            dt = min(dt, min(pending) - self.now)
        if self._drift_i < len(self._drift):
            # never integrate across a capacity drift step — rates are
            # only piecewise-constant between them
            dt = min(dt, self._drift[self._drift_i] - self.now)
        if t_cap is not None:
            dt = min(dt, t_cap - self.now)
        return max(dt, 0.0)

    def _advance(self, dt: float, prate, ar, inflow_m, m_rate, pool_rate,
                 inflow_sf, srate, sr, inflow_r, r_rate) -> None:
        nM, nR = self.nM, self.nR
        now = self.now
        if dt > 0.0:
            self._pf_rem -= prate * dt
            self._at_map += (inflow_m - m_rate) * dt
            self._gated_map += (ar - inflow_m) * dt
            self._pool += pool_rate * dt
            self._sf_rem += (inflow_sf - srate) * dt
            self._at_red += (inflow_r - r_rate) * dt
            self._gated_red += (sr - inflow_r) * dt
            for buf in (self._pf_rem, self._at_map, self._gated_map,
                        self._pool, self._sf_rem, self._at_red,
                        self._gated_red):
                np.clip(buf, 0.0, None, out=buf)

            # backlogs are linear within a constant-rate interval, so the
            # midpoint value makes the ``∫ backlog dt`` age integral exact
            # — and therefore invariant to how a steered run_until splits
            # the interval (a right-endpoint sample is not additive)
            lid = self._pf_src * nM + self._pf_dst
            served = np.zeros(self.nS * nM)
            np.add.at(served, lid, prate)
            backlog = np.zeros(self.nS * nM)
            np.add.at(backlog, lid, self._pf_rem + prate * (0.5 * dt))
            self._st_push.advance(served, backlog, now, dt)
            done_p = (self._pf_rem <= _EPS) & (prate > 0.0)
            if done_p.any():
                np.add.at(self._st_push.n_done, lid[done_p], 1)

            self._st_map.advance(
                m_rate.sum(axis=0),
                (self._at_map - (inflow_m - m_rate) * (0.5 * dt))
                .sum(axis=0),
                now, dt)
            lid2 = self._sf_j * nR + self._sf_k
            served = np.zeros(nM * nR)
            np.add.at(served, lid2, srate)
            backlog = np.zeros(nM * nR)
            np.add.at(backlog, lid2,
                      self._sf_rem - (inflow_sf - srate) * (0.5 * dt))
            self._st_shuf.advance(served, backlog, now, dt)
            done_s = (self._sf_rem <= _EPS) & (srate > 0.0)
            if done_s.any():
                np.add.at(self._st_shuf.n_done, lid2[done_s], 1)
            self._st_red.advance(
                r_rate.sum(axis=0),
                (self._at_red - (inflow_r - r_rate) * (0.5 * dt))
                .sum(axis=0),
                now, dt)
        self.now = now + dt

    def _settle(self) -> None:
        """Open every gate whose condition now holds and stamp phase
        completions — evaluated after each advance, in pipeline order so
        one settling cascades downstream within the same instant."""
        nJ, nM, nR = len(self.runs), self.nM, self.nR
        pending_push = np.zeros((nJ, nM), dtype=np.int64)
        act = self._pf_rem > _EPS
        if act.any():
            np.add.at(pending_push, (self._pf_job[act], self._pf_dst[act]),
                      1)
        now = self.now
        for g in self.runs:
            if not g.seeded or g.done:
                continue
            gi = g.idx
            b0, b1, b2 = g.cfg.barriers
            pp = pending_push[gi]
            push_done = not pp.any()
            if push_done and not g._push_done:
                g._push_done = True
                g.push_end = now
            # push/map gate
            if b0 == "L":
                newly = ~self._open_map[gi] & (pp == 0)
            elif b0 == "G":
                newly = np.full(nM, push_done) & ~self._open_map[gi]
            else:
                newly = np.zeros(nM, dtype=bool)
            if newly.any():
                self._open_map[gi, newly] = True
                self._at_map[gi, newly] += self._gated_map[gi, newly]
                self._gated_map[gi, newly] = 0.0
            # map completion per mapper: nothing buffered, gated or
            # still arriving
            map_done_j = (pp == 0) & (self._at_map[gi] <= _EPS) \
                & (self._gated_map[gi] <= _EPS)
            all_map = push_done and bool(map_done_j.all())
            if all_map and not g._map_done:
                g._map_done = True
                g.map_end = now
            # map/shuffle gate: release the held emission pool into the
            # job's shuffle flows (split by y)
            if b1 == "L":
                newly = ~self._open_em[gi] & map_done_j
            elif b1 == "G":
                newly = np.full(nM, all_map) & ~self._open_em[gi]
            else:
                newly = np.zeros(nM, dtype=bool)
            if newly.any():
                self._open_em[gi, newly] = True
                mine = self._sf_job == gi
                for j in np.flatnonzero(newly):
                    held = self._pool[gi, j]
                    if held > _EPS:
                        fsel = mine & (self._sf_j == j)
                        self._sf_rem[fsel] += held * self._sf_y[fsel]
                    self._pool[gi, j] = 0.0
            # shuffle completion per reducer: emission finished and the
            # inbound flows drained
            emission_done = all_map and not (self._pool[gi] > _EPS).any() \
                and bool(self._open_em[gi].all())
            mine = self._sf_job == gi
            pend_k = np.zeros(nR, dtype=np.int64)
            msel = mine & (self._sf_rem > _EPS)
            if msel.any():
                np.add.at(pend_k, self._sf_k[msel], 1)
            shuf_done_k = (pend_k == 0) & np.full(nR, emission_done)
            if emission_done and bool(shuf_done_k.all()) \
                    and not g._shuffle_done:
                g._shuffle_done = True
                g.shuffle_end = now
            # shuffle/reduce gate
            if b2 == "L":
                newly = ~self._open_red[gi] & shuf_done_k
            elif b2 == "G":
                newly = np.full(nR, g._shuffle_done) & ~self._open_red[gi]
            else:
                newly = np.zeros(nR, dtype=bool)
            if newly.any():
                self._open_red[gi, newly] = True
                self._at_red[gi, newly] += self._gated_red[gi, newly]
                self._gated_red[gi, newly] = 0.0
            if g._shuffle_done and (self._at_red[gi] <= _EPS).all() \
                    and (self._gated_red[gi] <= _EPS).all():
                g.reduce_end = now
                g.done = True
                self._released[gi] = True

    def _release_due(self) -> bool:
        due = [g for g in self.runs
               if not g.seeded and g.cfg.start_time <= self.now + 1e-12]
        for g in due:
            self._seed(g)
        return bool(due)

    def _refresh_caps(self) -> None:
        """Fold every capacity-trace step at or before ``now`` into the
        service-rate arrays (and the per-tier stats denominators, so
        utilization keeps integrating against the *current* capacity)."""
        if self._drift_i >= len(self._drift) \
                or self._drift[self._drift_i] > self.now + 1e-9:
            return
        while self._drift_i < len(self._drift) \
                and self._drift[self._drift_i] <= self.now + 1e-9:
            self._drift_i += 1
        sub_t = self.sub.at(self.now)
        self._B_sm = np.asarray(sub_t.B_sm, dtype=np.float64)
        self._B_mr = np.asarray(sub_t.B_mr, dtype=np.float64)
        self._C_m = np.asarray(sub_t.C_m, dtype=np.float64)
        self._C_r = np.asarray(sub_t.C_r, dtype=np.float64)
        self._st_push.cap = self._B_sm.reshape(-1)
        self._st_shuf.cap = self._B_mr.reshape(-1)
        self._st_map.cap = self._C_m.reshape(-1)
        self._st_red.cap = self._C_r.reshape(-1)

    def _step(self, t_cap: Optional[float]) -> bool:
        """One rate-change event.  Returns False when nothing remains to
        do (before ``t_cap``)."""
        self._release_due()
        self._refresh_caps()
        rates = self._rates()
        dt = self._next_dt(rates[0], rates[2], rates[3], rates[5],
                           rates[6], rates[8], rates[9], t_cap)
        if not np.isfinite(dt):
            return False
        if t_cap is not None and self.now + dt > t_cap:
            dt = max(t_cap - self.now, 0.0)
        self._advance(dt, *rates)
        self._settle()
        if self._release_due():
            return True
        if t_cap is not None and self.now >= t_cap:
            return False
        return True

    def _drain(self, t_cap: Optional[float]) -> None:
        self._started = True
        for _ in range(_MAX_EVENTS):
            if all(g.done for g in self.runs if g.seeded) \
                    and not any(
                        not g.seeded and (t_cap is None
                                          or g.cfg.start_time <= t_cap)
                        for g in self.runs):
                if t_cap is not None:
                    self.now = max(self.now, t_cap)
                return
            if not self._step(t_cap):
                return
        raise RuntimeError(
            f"fluid executor exceeded {_MAX_EVENTS} rate events — "
            "a flow is not draining (file a bug with the scenario)"
        )

    # -- control surface (mirrors _MultiSim) -------------------------------
    @property
    def finished(self) -> bool:
        return self._started and all(g.done or not g.seeded
                                     for g in self.runs) \
            and all(g.seeded for g in self.runs)

    def run_until(self, t: float, inclusive: bool = False) -> None:
        self._drain(t)
        self.now = max(self.now, t)

    def run(self) -> ScheduleSimResult:
        self._drain(None)
        if self._audit:
            self._audit_final()
        return self.result()

    def result(self) -> ScheduleSimResult:
        resources: Dict[str, ResourceStats] = {}
        nM, nR = self.nM, self.nR
        self._st_push.emit(
            resources, lambda r: f"push[s{r // nM}->m{r % nM}]")
        self._st_shuf.emit(
            resources, lambda r: f"shuffle[m{r // nR}->r{r % nR}]")
        self._st_map.emit(resources, lambda r: f"map[m{r}]")
        self._st_red.emit(resources, lambda r: f"reduce[r{r}]")
        return ScheduleSimResult(
            jobs=[g.result() for g in self.runs],
            makespan=max((g.reduce_end for g in self.runs), default=0.0),
            resources=resources,
            violations=list(self.violations),
        )

    def _audit_final(self) -> None:
        """Post-run conservation check (``SimConfig(audit=True)``): a
        finished job must have drained every flow and buffer — left-over
        volume means a gate never opened or a rate never reached it."""
        self._writeback()
        for g in self.runs:
            if not g.cfg.audit or not g.seeded or not g.done:
                continue
            gi = g.idx
            total = float(np.asarray(g.p.D).sum())
            tol = max(1e-6 * max(total, 1.0), 1e-2)
            left = {
                "push flows": sum(s[2] for s in g.push_spec),
                "shuffle flows": sum(s[3] for s in g.shuf_spec),
                "mapper buffers": float(
                    self._at_map[gi].sum() + self._gated_map[gi].sum()
                    + self._pool[gi].sum()),
                "reducer buffers": float(
                    self._at_red[gi].sum() + self._gated_red[gi].sum()),
            }
            for where, rem in left.items():
                if rem > tol:
                    self.violations.append(
                        f"job {gi}: fluid conservation: {rem:.6f} MB "
                        f"left in {where} on a finished job"
                    )

    def link_stages(self, child: int,
                    parents: Sequence[Tuple[int, float]]) -> None:
        raise ValueError(
            "fluid mode does not support pipeline stage links — use "
            'SimConfig(mode="event")'
        )

    def snapshot(self) -> ProgressSnapshot:
        """Remaining work bucketed for the re-planner.  Fluid volumes
        are continuously divisible, so *everything* still in flight is
        re-routable: remaining push reports as residual (not committed)
        and in-transit shuffle pools with its mapper."""
        self._release_due()
        nS, nM, nR = self.nS, self.nM, self.nR
        jobs = []
        for g in self.runs:
            if not g.seeded:
                prog = JobProgress.fresh(g.p, job=g.idx)
                prog = dataclasses.replace(prog, released=False)
                jobs.append(prog)
                continue
            gi = g.idx
            resid_push = np.zeros(nS)
            sel = self._pf_job == gi
            if sel.any():
                np.add.at(resid_push, self._pf_src[sel],
                          self._pf_rem[sel])
            at_mapper = self._at_map[gi] + self._gated_map[gi]
            pool = self._pool[gi].copy()
            ssel = self._sf_job == gi
            if ssel.any():
                np.add.at(pool, self._sf_j[ssel], self._sf_rem[ssel])
            at_reducer = self._at_red[gi] + self._gated_red[gi]
            prog = JobProgress(
                job=gi, released=True, done=g.done,
                resid_push=resid_push,
                committed_push=np.zeros((nS, nM)),
                at_mapper=at_mapper.copy(), shuffle_pool=pool,
                committed_shuffle=np.zeros((nM, nR)),
                at_reducer=at_reducer.copy(),
                alpha=float(g.p.alpha),
                total_push_mb=float(np.asarray(g.p.D).sum()),
                map_alive=np.ones(nM, dtype=bool),
            )
            if not g.done and prog.remaining_mb()["reduce"] <= 1e-9:
                prog = dataclasses.replace(prog, done=True)
            jobs.append(prog)
        backlog: Dict[str, float] = {}
        act = self._pf_rem > _EPS
        for n in np.flatnonzero(act):
            name = f"push[s{self._pf_src[n]}->m{self._pf_dst[n]}]"
            backlog[name] = backlog.get(name, 0.0) + float(self._pf_rem[n])
        act = self._sf_rem > _EPS
        for n in np.flatnonzero(act):
            name = f"shuffle[m{self._sf_j[n]}->r{self._sf_k[n]}]"
            backlog[name] = backlog.get(name, 0.0) + float(self._sf_rem[n])
        for j in range(nM):
            v = float(self._at_map[:, j].sum())
            if v > _EPS:
                backlog[f"map[m{j}]"] = v
        for k in range(nR):
            v = float(self._at_red[:, k].sum())
            if v > _EPS:
                backlog[f"reduce[r{k}]"] = v
        return ProgressSnapshot(time=self.now, jobs=tuple(jobs),
                                backlog=backlog)

    def inject(self, jobs) -> List[int]:
        from .simulate import _normalize_entries
        self._started = True
        idxs = []
        for platform, plan, cfg in _normalize_entries(jobs):
            if not self.sub.compatible(Substrate.of(platform)):
                raise ValueError(
                    f"platform {platform.name!r} is not a view of "
                    f"substrate {self.sub.name!r} — build job platforms "
                    "with Substrate.view()"
                )
            idxs.append(self._admit(platform, plan, cfg))
        self._release_due()
        return idxs

    def swap_plan(self, idx: int, plan: ExecutionPlan) -> None:
        """Re-split job ``idx``'s remaining fluid per the new plan: each
        source's remaining push volume follows the new ``x`` row, the
        per-mapper shuffle volume (in transit + held pool) the new
        ``y``.  Landed buffers are location-bound and stay."""
        g = self.runs[idx]
        if plan.x.shape != g.plan.x.shape or plan.y.shape != g.plan.y.shape:
            raise ValueError(
                f"plan shapes {plan.x.shape}/{plan.y.shape} do not match "
                f"job {idx}'s {g.plan.x.shape}/{g.plan.y.shape}"
            )
        self._started = True
        if not g.seeded:
            g.plan = plan
            return
        self._writeback()
        gi = g.idx
        x = np.asarray(plan.x, dtype=np.float64)
        y = np.asarray(plan.y, dtype=np.float64)
        resid = np.zeros(self.nS)
        for i, _, rem in g.push_spec:
            resid[i] += rem
        new_push: List[List[float]] = []
        for i in np.flatnonzero(resid > _EPS):
            row = x[i] if x[i].sum() > 1e-9 else np.full(self.nM,
                                                         1.0 / self.nM)
            for j in np.flatnonzero(row > 1e-9):
                vol = float(resid[i] * row[j] / row.sum())
                if vol > _EPS:
                    new_push.append([int(i), int(j), vol])
                    self._st_push.touch(int(i) * self.nM + int(j), gi)
                    self._st_map.touch(int(j), gi)
        pool_j = np.zeros(self.nM)
        for j, _, _, rem in g.shuf_spec:
            pool_j[j] += rem
        dests = sorted(
            {int(j) for _, j, _ in new_push}
            | {int(j) for j in np.flatnonzero(
                pool_j + self._at_map[gi] + self._gated_map[gi]
                + self._pool[gi] > _EPS)}
        )
        ky = np.flatnonzero(y > 1e-9)
        ysum = float(y[ky].sum())
        new_shuf: List[List[float]] = []
        for j in dests:
            for k in ky:
                new_shuf.append([int(j), int(k), float(y[k] / ysum),
                                 float(pool_j[j] * y[k] / ysum)])
                self._st_shuf.touch(int(j) * self.nR + int(k), gi)
                self._st_red.touch(int(k), gi)
        g.push_spec = new_push
        g.shuf_spec = new_shuf
        g.plan = plan
        # a swap can only *relax* what a gate waits on; recompute at the
        # next settle (gates never re-close: opened state persists)
        self._rebuild()
        self._settle()

    # -- residual pricing --------------------------------------------------
    def _seed_residual(self, g: _FluidJob, prog: JobProgress) -> None:
        """Seed job ``g`` from a :class:`JobProgress` residual instead of
        its full ``D``: the re-routable buckets follow the job's (current)
        plan exactly like :func:`repro.core.makespan.residual_volumes`
        routes them, committed transfers enter on the lanes they are
        already on, and delivered buffers preload the tier buffers —
        gated when the barrier in force would still hold them, so
        ``_settle`` releases them the instant the gate condition holds."""
        gi = g.idx
        nM, nR = self.nM, self.nR
        if prog.done or prog.remaining_mb()["reduce"] <= 1e-9:
            g.seeded = True
            g.done = True
            g._push_done = g._map_done = g._shuffle_done = True
            g.push_end = g.map_end = g.shuffle_end = self.now
            g.reduce_end = self.now
            self._released[gi] = True
            self._rebuild()
            return
        x, y = _live_plan_arrays(prog, g.plan)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        resid = np.asarray(prog.resid_push, dtype=np.float64)
        comm_p = np.asarray(prog.committed_push, dtype=np.float64)
        push: Dict[Tuple[int, int], float] = {}
        for i in np.flatnonzero(resid > _EPS):
            row = x[i] if float(x[i].sum()) > 1e-9 \
                else np.full(nM, 1.0 / nM)
            for j in np.flatnonzero(row > 1e-9):
                vol = float(resid[i] * row[j] / row.sum())
                if vol > _EPS:
                    key = (int(i), int(j))
                    push[key] = push.get(key, 0.0) + vol
        for i, j in zip(*np.nonzero(comm_p > _EPS)):
            key = (int(i), int(j))
            push[key] = push.get(key, 0.0) + float(comm_p[i, j])
        g.push_spec = [[i, j, vol] for (i, j), vol in sorted(push.items())]
        for i, j, _ in g.push_spec:
            self._st_push.touch(i * nM + j, gi)
            self._st_map.touch(j, gi)
        at_m = np.asarray(prog.at_mapper, dtype=np.float64)
        pool = np.asarray(prog.shuffle_pool, dtype=np.float64)
        comm_s = np.asarray(prog.committed_shuffle, dtype=np.float64)
        at_r = np.asarray(prog.at_reducer, dtype=np.float64)
        dests = sorted(
            {j for _, j, _ in g.push_spec}
            | set(np.flatnonzero(at_m > _EPS).tolist())
            | set(np.flatnonzero(pool > _EPS).tolist())
        )
        ky = np.flatnonzero(y > 1e-9)
        ysum = float(y[ky].sum()) or 1.0
        flows: Dict[Tuple[int, int], List[float]] = {}
        for j in dests:
            for k in ky:
                flows[(int(j), int(k))] = [float(y[k] / ysum), 0.0]
        for j, k in zip(*np.nonzero(comm_s > _EPS)):
            f = flows.setdefault((int(j), int(k)), [0.0, 0.0])
            f[1] += float(comm_s[j, k])
        b0, b1, b2 = g.cfg.barriers
        if b1 == "P":
            # no emission gate: pooled map output is queued sends, not
            # held volume — route it into the flows by the (live) y now
            for j in np.flatnonzero(pool > _EPS):
                for k in ky:
                    flows[(int(j), int(k))][1] += \
                        float(pool[j] * y[k] / ysum)
        else:
            self._pool[gi] = pool
        g.shuf_spec = [[j, k, share, rem]
                       for (j, k), (share, rem) in sorted(flows.items())]
        for j, k, _, _ in g.shuf_spec:
            self._st_shuf.touch(j * nR + k, gi)
            self._st_red.touch(k, gi)
        if b0 == "P":
            self._at_map[gi] = at_m
        else:
            self._gated_map[gi] = at_m
        if b2 == "P":
            self._at_red[gi] = at_r
        else:
            self._gated_red[gi] = at_r
        g.seeded = True
        self._released[gi] = True
        self._prio[gi] = self._seed_seq
        self._seed_seq += 1
        self._open_map[gi] = b0 == "P"
        self._open_em[gi] = b1 == "P"
        self._open_red[gi] = b2 == "P"
        self._rebuild()


def fluid_score_residual(
    substrate: Substrate,
    entries: Sequence[Tuple[Platform, ExecutionPlan, SimConfig,
                            JobProgress]],
    now: float = 0.0,
) -> List[float]:
    """Fluid-rollout residual pricing: per-job modeled remaining seconds
    of ``entries`` (``(platform, plan, cfg, progress)`` per live job)
    under a shared-capacity **fluid** execution from ``now`` — the
    ``OnlineConfig(candidate_pricing="fluid")`` counterpart of
    :func:`repro.core.optimize.score_residual_shared`.

    The rollout seeds one :class:`FluidSim` from the residual buckets
    (re-routable volume split by each job's plan, committed transfers on
    their lanes, landed buffers behind the barriers still holding them)
    and drains it to completion in float64, folding any remaining
    :class:`~repro.core.platform.CapacityTrace` drift of ``substrate``
    into the horizon — so unlike the closed-form model it prices a
    candidate against the capacities it will *actually* see.  Both the
    incumbent and the candidate stack are priced by the same rollout, so
    a gate that adopts only on a strict fluid improvement keeps the
    never-priced-worse guarantee.

    Chunk-granular dynamics (speculation, stealing, failures, compute
    noise, replication) are stripped from the pricing configs — the
    rollout is a flow relaxation; per-job dead reducers are still routed
    around via the live-``y`` mask, like the closed-form path."""
    sim = FluidSim(substrate, [])
    sim.now = float(now)
    sim._started = True
    # consume drift steps already behind the observation instant and
    # fold the capacities in force at `now`
    while sim._drift_i < len(sim._drift) \
            and sim._drift[sim._drift_i] <= sim.now + 1e-9:
        sim._drift_i += 1
    sub_t = substrate.at(sim.now)
    sim._B_sm = np.asarray(sub_t.B_sm, dtype=np.float64)
    sim._B_mr = np.asarray(sub_t.B_mr, dtype=np.float64)
    sim._C_m = np.asarray(sub_t.C_m, dtype=np.float64)
    sim._C_r = np.asarray(sub_t.C_r, dtype=np.float64)
    sim._st_push.cap = sim._B_sm.reshape(-1)
    sim._st_shuf.cap = sim._B_mr.reshape(-1)
    sim._st_map.cap = sim._C_m.reshape(-1)
    sim._st_red.cap = sim._C_r.reshape(-1)
    for platform, plan, cfg, prog in entries:
        pricing_cfg = dataclasses.replace(
            cfg, mode="fluid", speculation=False, stealing=False,
            failures=(), compute_noise=0.0, replication=1, audit=False,
            start_time=float(now),
        )
        gi = sim._admit(platform, plan, pricing_cfg)
        sim._seed_residual(sim.runs[gi], prog)
    # open every gate whose condition already holds before the first
    # rate computation (e.g. push long done behind an L/G barrier)
    sim._settle()
    sim._drain(None)
    return [max(g.reduce_end - float(now), 0.0) for g in sim.runs]
