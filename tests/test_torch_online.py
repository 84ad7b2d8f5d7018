"""The port's online control against the reference's: residual pricing and
its float64 helpers on an observed snapshot (a dead mapper, a dead
reducer), the two residual solvers' 25-step trajectories from the same
logits, ``replan`` / ``replan_batch`` / ``replan_schedule`` (full,
incremental, past the 16-job stack cap), the online policy registry, and
``GeoSchedule.run_online`` under every built-in policy with the solver
charge pinned, on the benchmark's 2-node ``online_pair`` and
``online_shared`` fabrics and a 3-job view of the 8-node PlanetLab
platform, all on the CPU."""
import dataclasses
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro_torch.api as TA  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro.core import optimize as RO  # noqa: E402
from repro_torch.core import optimize as TO  # noqa: E402
from repro_torch.core.plan import validate_plan  # noqa: E402

# the packages re-export a function named `makespan` over the submodule
RM = importlib.import_module("repro.core.makespan")
TM = importlib.import_module("repro_torch.core.makespan")

CPU = "cpu"
OPT = dict(n_restarts=4, steps=100)
GGL = ("G", "G", "L")
PKGS = {"ref": RC, "port": TC}


# ---------------------------------------------------------------------------
# an observed residual: three jobs on the PlanetLab substrate, mid-run
# ---------------------------------------------------------------------------

def _plans(C, n_jobs=3, n=8, seed=11):
    rng = np.random.default_rng(seed)
    return [C.ExecutionPlan(x=rng.dirichlet(np.ones(n), size=n),
                            y=rng.dirichlet(np.ones(n)))
            for _ in range(n_jobs)]


def _views(C):
    sub = C.Substrate.of(C.planetlab_platform(4, alpha=1.0, seed=0))
    views = []
    for g, alpha in enumerate((1.0, 0.5, 2.0)):
        D = np.full(sub.nS, 250.0)
        D[2 * g] = 1500.0
        views.append(sub.view(D, alpha, name=f"job{g}"))
    return sub, views


def observe(C, t_frac=0.15):
    """(substrate, views, incumbents, snapshot) of the three jobs at 15%
    of their failure-free makespan, every job live: job 0's mapper 1 and
    job 1's reducer 2 killed before it (job 1 mid-shuffle), job 2 released
    late."""
    sub, views = _views(C)
    plans = _plans(C)
    frozen = C.simulate_schedule(
        [(v, p, C.SimConfig(barriers=GGL)) for v, p in zip(views, plans)],
        substrate=sub).makespan
    cfgs = [
        C.SimConfig(barriers=GGL, failures=[
            C.FailureEvent.mapper_kill(1, 0.05 * frozen)]),
        C.SimConfig(barriers=GGL, failures=[
            C.FailureEvent.reducer_kill(2, 0.1 * frozen)]),
        C.SimConfig(barriers=GGL, start_time=0.02 * frozen),
    ]
    eng = C.open_schedule([(v, p, c) for v, p, c in zip(views, plans, cfgs)],
                          substrate=sub)
    eng.run_until(t_frac * frozen)
    return sub, views, plans, eng.snapshot()


@pytest.fixture(scope="module")
def observed():
    return {name: observe(C) for name, C in PKGS.items()}


def test_snapshot_has_dead_workers(observed):
    """The copied executors observe the same residual, dead workers
    included."""
    (_, _, _, rsnap), (_, _, _, tsnap) = observed["ref"], observed["port"]
    assert rsnap.time == tsnap.time
    assert not tsnap.jobs[0].map_alive.all()
    assert not tsnap.jobs[1].red_alive.all()
    for r, t in zip(rsnap.jobs, tsnap.jobs):
        assert not t.done
        for field in TC.JobProgress.RESIDUAL_FIELDS:
            np.testing.assert_array_equal(getattr(t, field), getattr(r, field))


def test_residual_volumes_vmap_matches_reference(observed):
    """``residual_volumes`` on torch vmapped over jobs, against jax.vmap of
    the reference: float32 at atol 1e-6 of each volume's largest entry."""
    _, _, plans, snap = observed["port"]
    stack = [np.asarray(a, np.float32) for a in TC.JobProgress.stack(snap.jobs)]
    alpha = np.array([jp.alpha for jp in snap.jobs], np.float32)
    xs = np.stack([p.x for p in plans]).astype(np.float32)
    ys = np.stack([p.y for p in plans]).astype(np.float32)
    want = jax.vmap(lambda r, a, x, y: RM.residual_volumes(*r, a, x, y))(
        tuple(jnp.asarray(a) for a in stack), jnp.asarray(alpha),
        jnp.asarray(xs), jnp.asarray(ys))
    got = vmap(lambda r, a, x, y: TM.residual_volumes(*r, a, x, y))(
        tuple(torch.from_numpy(a) for a in stack), torch.from_numpy(alpha),
        torch.from_numpy(xs), torch.from_numpy(ys))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_shared_residual_pricing_bit_identical(observed):
    """The float64 half every online decision prices through."""
    rsub, rviews, rplans, rsnap = observed["ref"]
    tsub, tviews, tplans, tsnap = observed["port"]
    rcm, tcm = RM.CostModel(rviews[0], GGL), TM.CostModel(tviews[0], GGL)
    want = rcm.price_residual_shared(rsnap.jobs, rplans)
    got = tcm.price_residual_shared(tsnap.jobs, tplans)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (tcm.residual_schedule_makespan(tsnap.jobs, tplans)
            == rcm.residual_schedule_makespan(rsnap.jobs, rplans))
    vols = [RM.analytic_volumes(v.D, p.x, p.y, v.alpha, xp=np)
            for v, p in zip(rviews, rplans)]
    for g, w in zip(TM.shared_effective_volumes(vols),
                    RM.shared_effective_volumes(vols)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(tcm.price_shared(vols), rcm.price_shared(vols)):
        assert g["makespan"] == w["makespan"]
    assert (TO.score_residual_shared(tsub, tsnap.jobs, tplans, GGL)
            == RO.score_residual_shared(rsub, rsnap.jobs, rplans, GGL))


def test_float64_helpers_bit_identical(observed):
    rsub, rviews, rplans, rsnap = observed["ref"]
    tsub, tviews, tplans, tsnap = observed["port"]
    rng = np.random.default_rng(12)
    for g, (rjp, tjp) in enumerate(zip(rsnap.jobs, tsnap.jobs)):
        x, y = rng.dirichlet(np.ones(8), size=8), rng.dirichlet(np.ones(8))
        for cost in (0.0, 0.3):
            assert TO.swap_charge(
                tviews[g], tjp, tplans[g], TC.ExecutionPlan(x=x, y=y), cost
            ) == RO.swap_charge(rviews[g], rjp, rplans[g],
                                RC.ExecutionPlan(x=x, y=y), cost)
        rdeg = RO._degraded_platform(rviews[g], rjp)
        tdeg = TO._degraded_platform(tviews[g], tjp)
        for f in ("B_sm", "B_mr", "C_m", "C_r", "D"):
            np.testing.assert_array_equal(getattr(tdeg, f), getattr(rdeg, f))
        for a, b in zip(TO._degraded_caps(tsub, tjp),
                        RO._degraded_caps(rsub, rjp)):
            np.testing.assert_array_equal(a, b)
        for incremental in (False, True):
            for n in (1, 4, 8):
                got = TO._replan_logits(tdeg, tplans[g], n, 7 + g, incremental)
                want = RO._replan_logits(rdeg, rplans[g], n, 7 + g,
                                         incremental)
                for a, b in zip(got, want):
                    assert a.dtype == np.float32
                    np.testing.assert_array_equal(a, np.asarray(b))
    for n in (1, 4, 8, 24):
        for steps in (10, 150, 200, 500):
            assert (TO._incremental_budget(n, steps)
                    == RO._incremental_budget(n, steps))
            for jobs in (1, 2, 3, 5, 16, 17, 40):
                assert (TO._shared_incremental_budget(n, steps, jobs)
                        == RO._shared_incremental_budget(n, steps, jobs))


def test_solve_time_ema_matches_reference():
    samples = [(0.5, True), (0.2, False), (0.31, False), (float("nan"), False),
               (0.0, False), (1.7, False), (0.04, True), (0.05, False)]
    for fixed in (None, 0.25):
        got, want = TO.SolveTimeEMA(fixed=fixed), RO.SolveTimeEMA(fixed=fixed)
        assert got.charge_s() == want.charge_s()
        for secs, compiled in samples:
            got.observe(secs, compiled)
            want.observe(secs, compiled)
            assert got.charge_s() == want.charge_s()
            assert (got.ema, got.samples, got.excluded) == (
                want.ema, want.samples, want.excluded)
        assert repr(got) == repr(want)
    with pytest.raises(ValueError, match="beta"):
        TO.SolveTimeEMA(beta=0.0)


def test_online_registry_matches_reference():
    assert TC.available_online_policies() == RC.available_online_policies()
    for name in RC.available_online_policies():
        assert (dataclasses.asdict(TC.get_online_config(name))
                == dataclasses.asdict(RC.get_online_config(name))), name
    with pytest.raises(ValueError, match="online policy must be one of"):
        TC.get_online_policy("nope")
    with pytest.raises(ValueError, match="requires shared=True"):
        TC.OnlineConfig(candidate_pricing="fluid")
    with pytest.raises(ValueError, match="hysteresis"):
        TC.OnlineConfig(hysteresis=-1.0)


# ---------------------------------------------------------------------------
# the residual solvers from the same logits
# ---------------------------------------------------------------------------

def _residual_inputs(snap, views, R=4, seed=0):
    """float32 inputs of both residual solvers over the snapshot's jobs."""
    jobs = list(snap.jobs)
    rng = np.random.default_rng(seed)
    J, (nS, nM), nR = len(jobs), views[0].B_sm.shape, views[0].nR
    resid = [np.asarray(a, np.float32) for a in TC.JobProgress.stack(jobs)]
    caps = [np.asarray(np.stack([c[k] for c in (
        TO._degraded_caps(TC.Substrate.of(views[0]), jp) for jp in jobs)]),
        np.float32) for k in range(4)]
    alpha = np.array([jp.alpha for jp in jobs], np.float32)
    lx = rng.normal(0.0, 1.5, size=(R, J, nS, nM)).astype(np.float32)
    ly = rng.normal(0.0, 1.5, size=(R, J, nR)).astype(np.float32)
    spans = TO.score_residual_shared(TC.Substrate.of(views[0]), jobs,
                                     _plans(TC), GGL)
    return resid, caps, alpha, lx, ly, np.asarray(spans, np.float32)


@pytest.mark.parametrize("incremental", [False, True])
def test_solve_residual_batch_many_follows_reference(observed, incremental):
    """B = 3 requests × 4 restarts × 25 steps: x, y at atol 1e-4, the exact
    residual spans at rtol 1e-4."""
    _, views, _, snap = observed["port"]
    resid, caps, alpha, lx, ly, spans = _residual_inputs(snap, views)
    lx, ly = lx.swapaxes(0, 1).copy(), ly.swapaxes(0, 1).copy()
    anneal = RO._INCREMENTAL_ANNEAL if incremental else {}
    assert TO._INCREMENTAL_ANNEAL == RO._INCREMENTAL_ANNEAL
    want = RO._solve_residual_batch_many(
        tuple(jnp.asarray(a) for a in resid), tuple(jnp.asarray(a) for a in caps),
        jnp.asarray(alpha), jnp.asarray(lx), jnp.asarray(ly),
        jnp.asarray(spans), barriers=GGL, steps=25, **anneal)
    got = TO._solve_residual_batch_many(
        tuple(torch.from_numpy(a) for a in resid),
        tuple(torch.from_numpy(a) for a in caps), torch.from_numpy(alpha),
        torch.from_numpy(lx), torch.from_numpy(ly), torch.from_numpy(spans),
        barriers=GGL, steps=25, **anneal)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


@pytest.mark.parametrize("with_bg", [False, True])
def test_solve_residual_shared_batch_follows_reference(observed, with_bg):
    """The joint residual objective over the three jobs (and with a fixed
    background demand): 4 restarts × 25 steps, x, y at atol 1e-4, the
    exact aggregate at rtol 1e-4."""
    _, views, _, snap = observed["port"]
    resid, caps, alpha, lx, ly, spans = _residual_inputs(snap, views, seed=1)
    rng = np.random.default_rng(2)
    shapes = [(8, 8), (8,), (8, 8), (8,)]
    bg = [(rng.uniform(0, 50, size=s) if with_bg else np.zeros(s))
          .astype(np.float32) for s in shapes]
    statics = dict(kappa=float(10.0 ** 0.5), barriers=GGL, steps=25)
    args = (resid, caps, alpha, bg)
    want = RO._solve_residual_shared_batch(
        *(tuple(jnp.asarray(a) for a in group) for group in args[:2]),
        jnp.asarray(alpha), tuple(jnp.asarray(a) for a in bg),
        jnp.asarray(lx), jnp.asarray(ly), jnp.float32(spans.max()),
        **statics)
    got = TO._solve_residual_shared_batch(
        *(tuple(torch.from_numpy(a) for a in group) for group in args[:2]),
        torch.from_numpy(alpha), tuple(torch.from_numpy(a) for a in bg),
        torch.from_numpy(lx), torch.from_numpy(ly),
        torch.tensor(spans.max()), **statics)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


# ---------------------------------------------------------------------------
# re-planning entry points
# ---------------------------------------------------------------------------

def _same_choice(got_plan, got_inc, want_plan, want_inc):
    """The port keeps the incumbent object exactly where the reference
    keeps its own."""
    assert (got_plan is got_inc) == (want_plan is want_inc)
    validate_plan(got_plan.x, got_plan.y)


@pytest.mark.parametrize("incremental", [False, True])
def test_replan_batch_matches_reference(observed, incremental):
    rsub, rviews, rplans, rsnap = observed["ref"]
    tsub, tviews, tplans, tsnap = observed["port"]
    kw = dict(barriers=GGL, seeds=[3, 4, 5], incremental=incremental, **OPT)
    rat, tat = rsub.at(rsnap.time), tsub.at(tsnap.time)
    want = RO.replan_batch(
        [rat.view(v.D, v.alpha) for v in rviews], rplans, rsnap.jobs, **kw)
    got = TO.replan_batch(
        [tat.view(v.D, v.alpha) for v in tviews], tplans, tsnap.jobs,
        device=CPU, **kw)
    for g, w, ginc, winc in zip(got, want, tplans, rplans):
        _same_choice(g.plan, ginc, w.plan, winc)
        assert g.makespan == pytest.approx(w.makespan, rel=1e-3)
        assert g.mode == w.mode == "replan"
    # a service request is the same batched call
    svc = TC.SolverService(barriers=GGL, device=CPU, **OPT)
    again = svc.replan_many([tat.view(v.D, v.alpha) for v in tviews], tplans,
                            tsnap.jobs, seeds=[3, 4, 5],
                            incremental=incremental)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.plan.x, b.plan.x)
        assert a.makespan == b.makespan


def test_replan_fresh_job_matches_reference():
    """``replan`` of a job that has not started: ordinary planning that the
    incumbent competes in.  This case differs from the reference past
    1e-3: the anneal does not settle in its last 25 of 100 steps (the
    restarts' exact objectives move between 88 and 92 s from step 75 on,
    in both packages), so where it stops is float32-sensitive; the port's
    88.118 s and the reference's 89.755 s are both points of that band.
    Held here: the incumbent competes on both sides, and the port is no
    worse than the reference by more than 1e-3."""
    rp = RC.planetlab_platform(4, alpha=1.0, seed=2)
    tp = TC.planetlab_platform(4, alpha=1.0, seed=2)
    rinc, tinc = RC.uniform_plan(rp), TC.uniform_plan(tp)
    want = RO.replan(rp, rinc, barriers=GGL, seed=1, **OPT)
    got = TO.replan(tp, tinc, barriers=GGL, seed=1, device=CPU, **OPT)
    _same_choice(got.plan, tinc, want.plan, rinc)
    assert got.makespan <= want.makespan * (1 + 1e-3)
    assert got.makespan < TC.makespan(tp, tinc, GGL)


@pytest.mark.parametrize("incremental", [False, True])
def test_replan_schedule_matches_reference(observed, incremental):
    rsub, _, rplans, rsnap = observed["ref"]
    tsub, _, tplans, tsnap = observed["port"]
    kw = dict(barriers=GGL, seed=9, incremental=incremental, **OPT)
    want = RO.replan_schedule(rsub.at(rsnap.time), rplans, rsnap, **kw)
    got = TO.replan_schedule(tsub.at(tsnap.time), tplans, tsnap, device=CPU,
                             **kw)
    assert got.before == want.before  # the float64 incumbent pricing
    for g, ginc, w, winc in zip(got.plans, tplans, want.plans, rplans):
        _same_choice(g, ginc, w, winc)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-3)
    for g, w in zip(got.after, want.after):
        assert g == pytest.approx(w, rel=1e-3)
    assert got.makespan <= max(got.before)


def crowd(C, n_jobs=20):
    """``n_jobs`` small jobs on the ``online_pair`` fabric, snapshot
    mid-run: past the incremental stack cap of 16."""
    sub = C.Substrate(
        B_sm=np.full((2, 2), 200.0),
        B_mr=np.array([[500.0, 100.0], [500.0, 100.0]]),
        C_m=np.array([100.0, 100.0]), C_r=np.array([2000.0, 2000.0]),
        cluster_s=np.array([0, 1]), cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]), name="online_pair")
    rng = np.random.default_rng(4)
    entries = []
    for g in range(n_jobs):
        view = sub.view(rng.uniform(50.0, 400.0, size=2), 1.0, name=f"j{g}")
        plan = C.ExecutionPlan(x=rng.dirichlet(np.ones(2), size=2),
                               y=rng.dirichlet(np.ones(2)))
        entries.append((view, plan, C.SimConfig(barriers=GGL,
                                                start_time=2.0 * g)))
    eng = C.open_schedule(entries, substrate=sub)
    eng.run_until(5.0)
    return sub, [e[1] for e in entries], eng.snapshot()


def test_replan_schedule_past_the_stack_cap_matches_reference():
    """20 live jobs, incremental: 16 annealed, 4 as background demand."""
    rsub, rplans, rsnap = crowd(RC)
    tsub, tplans, tsnap = crowd(TC)
    live = [jp for jp in tsnap.jobs if not jp.done]
    assert len(live) > TO._INCREMENTAL_STACK_CAP == RO._INCREMENTAL_STACK_CAP
    kw = dict(barriers=GGL, seed=2, incremental=True, **OPT)
    want = RO.replan_schedule(rsub, rplans, rsnap, **kw)
    got = TO.replan_schedule(tsub, tplans, tsnap, device=CPU, **kw)
    assert got.before == want.before
    for g, ginc, w, winc in zip(got.plans, tplans, want.plans, rplans):
        _same_choice(g, ginc, w, winc)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-3)


# ---------------------------------------------------------------------------
# run_online under every built-in policy
# ---------------------------------------------------------------------------

def online_pair(C):
    """The benchmark's ``online_pair``: both links into r0 degrade 250x at
    t=105 s."""
    return C.Substrate(
        B_sm=np.full((2, 2), 200.0),
        B_mr=np.array([[500.0, 100.0], [500.0, 100.0]]),
        C_m=np.array([100.0, 100.0]), C_r=np.array([2000.0, 2000.0]),
        cluster_s=np.array([0, 1]), cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]), name="online_pair",
    ).with_traces({
        "shuffle[m0->r0]": C.CapacityTrace.step(500.0, 2.0, 105.0),
        "shuffle[m1->r0]": C.CapacityTrace.step(500.0, 2.0, 105.0),
    })


def online_shared(C):
    """The benchmark's ``online_shared``: the late job is stuck on r1, r0
    degrades at t=110 s, and two nuisance steps on dead push links."""
    return C.Substrate(
        B_sm=np.array([[200.0, 200.0, 1.0, 1.0], [200.0, 200.0, 1.0, 1.0],
                       [1.0, 1.0, 200.0, 200.0], [1.0, 1.0, 200.0, 200.0]]),
        B_mr=np.array([[200.0, 200.0], [200.0, 200.0], [1.0, 200.0],
                       [1.0, 200.0]]),
        C_m=np.array([100.0, 100.0, 100.0, 100.0]),
        C_r=np.array([300.0, 60.0]),
        cluster_s=np.array([0, 0, 1, 1]), cluster_m=np.array([0, 0, 1, 1]),
        cluster_r=np.array([0, 1]), name="online_shared",
    ).with_traces({
        "reduce[r0]": C.CapacityTrace.step(300.0, 40.0, 110.0),
        "push[s0->m2]": C.CapacityTrace.step(1.0, 0.9, 150.0),
        "push[s1->m2]": C.CapacityTrace.step(1.0, 0.9, 180.0),
    })


def online_scenario(A, C, fabric, **kw):
    """(schedule, arrivals, cfg): the steady job planned alone, the late
    one arriving at t=50 s; on ``online_pair`` the steady job also loses
    mapper 1 at t=120 s."""
    if fabric == "online_pair":
        sub = online_pair(C)
        steady_D, late_D = np.array([8000.0, 8000.0]), np.array([4000.0, 4000.0])
        failures = [C.FailureEvent.mapper_kill(1, 120.0)]
    else:
        sub = online_shared(C)
        steady_D = np.array([8000.0, 8000.0, 0.0, 0.0])
        late_D = np.array([0.0, 0.0, 6000.0, 6000.0])
        failures = []
    steady = A.GeoJob(sub.view(steady_D, 1.0, name="steady"), **kw)
    late = A.GeoJob(sub.view(late_D, 1.0, name="late"), **kw)
    sched = A.GeoSchedule([steady], **kw).plan(
        "independent", barriers=GGL, **OPT)
    cfg = C.SimConfig(barriers=GGL, failures=failures)
    return sched, [A.Arrival(late, 50.0)], cfg


ONLINE_CASES = [("online_pair", p) for p in RC.available_online_policies()] + [
    ("online_shared", p) for p in ("reactive", "reactive_shared")]


def _pinned(C, policy, cost=0.1):
    return dataclasses.replace(C.get_online_config(policy), solver_cost_s=cost)


@pytest.fixture(scope="module")
def online_reports():
    out = {}
    for fabric, policy in ONLINE_CASES:
        extra = {"replan_dt": 40.0} if policy.startswith("horizon") else {}
        for name, A, C, kw in (("ref", RA, RC, {}),
                               ("port", TA, TC, {"device": CPU})):
            sched, arrivals, cfg = online_scenario(A, C, fabric, **kw)
            out[fabric, policy, name] = sched.run_online(
                policy=policy, arrivals=arrivals, cfg=cfg,
                online=_pinned(C, policy), **OPT, **extra)
    return out


def _timeline(report):
    return [(d.time, d.event, d.job, d.action) for d in report.decisions]


@pytest.mark.parametrize("fabric,policy", ONLINE_CASES,
                         ids=[f"{f}-{p}" for f, p in ONLINE_CASES])
def test_run_online_matches_reference(online_reports, fabric, policy):
    """The same (time, event, job, action) timeline, and the steered and
    frozen makespans within 1e-3 relative (the steady job's offline plan
    is each package's own solve)."""
    want = online_reports[fabric, policy, "ref"]
    got = online_reports[fabric, policy, "port"]
    assert _timeline(got) == _timeline(want)
    assert got.makespan_online == pytest.approx(want.makespan_online, rel=1e-3)
    assert got.makespan_static == pytest.approx(want.makespan_static,
                                                rel=1e-3)
    for d in got.decisions:
        if (d.action == "swap" and not TC.get_online_config(policy).shared
                and d.time < 120.0):
            # before the mapper dies; after it, ``before`` is priced on
            # the live view and ``after`` on the degraded one (the
            # reference's record, reproduced)
            assert d.modeled_after < d.modeled_before
    for plan in got.plans:
        validate_plan(plan.x, plan.y)
    json.dumps(got.as_dict())


def test_static_and_infinite_hysteresis_equal_the_frozen_schedule():
    """``static`` is the frozen schedule; ``reactive`` with hysteresis inf
    equals it byte for byte in as_dict() and never calls a solver."""
    sched, arrivals, cfg = online_scenario(TA, TC, "online_pair", device=CPU)
    static = sched.run_online(policy="static", arrivals=arrivals, cfg=cfg)
    late = arrivals[0]
    frozen = TC.simulate_schedule(
        [(sched.jobs[0].platform, sched.planned.plans[0], cfg),
         (late.job.platform, late.job.planned.plan,
          dataclasses.replace(cfg, start_time=late.time))],
        substrate=sched.substrate)
    assert static.sim.as_dict() == frozen.as_dict()
    assert static.static_sim.as_dict() == frozen.as_dict()
    before = TC.solver_cache_stats()["calls"]
    inert = sched.run_online(
        policy="reactive", arrivals=arrivals, cfg=cfg,
        online=TC.OnlineConfig(shared=True, hysteresis=float("inf")))
    assert TC.solver_cache_stats()["calls"] == before
    doc, ref = inert.as_dict(), static.as_dict()
    assert (doc.pop("policy"), ref.pop("policy")) == ("reactive", "static")
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert inert.plans[0] is sched.planned.plans[0]
    assert inert.plans[1] is late.job.planned.plan
    with pytest.raises(ValueError, match="pass replan_dt"):
        sched.run_online(policy="horizon", arrivals=arrivals, cfg=cfg)
