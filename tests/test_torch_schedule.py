"""The port's multi-job schedules against the reference's: the schedule
registry, the batched contention inflation, the joint solver's 25-step
trajectories from the same logits, every policy's shared-capacity
makespans, and ``GeoSchedule``'s plan / with_plans / simulate / execute on
the benchmark's ``contended_pair`` fabric and a 3-job view of the
4-data-centre (8-node) PlanetLab platform, all on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro_torch.api as TA  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro.core import optimize as RO  # noqa: E402
from repro.mapreduce import apps as r_apps  # noqa: E402
from repro_torch.core import optimize as TO  # noqa: E402
from repro_torch.core.plan import validate_plan  # noqa: E402
from repro_torch.mapreduce import apps as t_apps  # noqa: E402

CPU = "cpu"
OPT = dict(n_restarts=6, steps=150)
FABRICS = ("contended_pair", "planetlab4")
#: (policy, objective) pairs: every built-in policy, joint under both
POLICIES = [("independent", "makespan"), ("sequential", "makespan"),
            ("joint", "makespan"), ("joint", "min_max_slowdown")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def contended_substrate(pkg):
    """The benchmark's ``contended_pair`` (benchmarks/paper_figures.py):
    only one job reaches mapper m1 fast, so myopic planning collides."""
    return pkg.Substrate(
        B_sm=np.array([[10_000.0, 1.0], [10_000.0, 10_000.0]]),
        B_mr=np.full((2, 2), 10_000.0),
        C_m=np.array([50.0, 50.0]),
        C_r=np.array([10_000.0, 10_000.0]),
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name="contended_pair",
    )


def job_views(pkg, fabric):
    """The fabric's per-job platform views, built by ``pkg``."""
    if fabric == "contended_pair":
        sub = contended_substrate(pkg)
        return [sub.view(np.array([40_000.0, 0.0]), 1.0, name="pinned"),
                sub.view(np.array([0.0, 40_000.0]), 1.0, name="flexible")]
    sub = pkg.Substrate.of(pkg.planetlab_platform(4, alpha=1.0, seed=0))
    views = []
    for g, alpha in enumerate((1.0, 0.5, 2.0)):
        D = np.full(sub.nS, 250.0)
        D[2 * g] = 1500.0
        views.append(sub.view(D, alpha, name=f"job{g}"))
    return views


def test_schedule_registry_matches_reference():
    assert TC.available_policies() == RC.available_policies()
    assert TC.SCHEDULE_OBJECTIVES == RC.SCHEDULE_OBJECTIVES
    with pytest.raises(ValueError, match="policy must be one of"):
        TC.get_schedule_planner("no_such_policy")
    with pytest.raises(ValueError, match="objective must be one of"):
        TC.optimize_schedule(job_views(TC, "contended_pair"),
                             objective="nope", device=CPU)
    with pytest.raises(ValueError, match="does not take an objective"):
        TC.optimize_schedule(job_views(TC, "contended_pair"),
                             policy="independent",
                             objective="min_max_slowdown", device=CPU)


def _random_vols(seed, J=3, nS=4, nM=4, nR=3):
    """Job-stacked float32 volumes with exact zeros (unused resources)."""
    rng = np.random.default_rng(seed)
    shapes = [(J, nS, nM), (J, nM), (J, nM, nR), (J, nR)]
    vols = []
    for shape in shapes:
        v = rng.uniform(0.0, 900.0, size=shape)
        v[rng.uniform(size=shape) < 0.3] = 0.0
        vols.append(v.astype(np.float32))
    bg = [rng.uniform(0.0, 300.0, size=s[1:]).astype(np.float32)
          for s in shapes]
    return vols, bg


@pytest.mark.parametrize("kappa,with_bg", [(2.5, False), (0.0, False),
                                           (2.5, True), (0.0, True)],
                         ids=["smooth", "hard", "smooth-bg", "hard-bg"])
def test_stacked_effective_volumes_matches_reference(kappa, with_bg):
    vols, bg = _random_vols(int(kappa * 10) + with_bg)
    want = RO._stacked_effective_volumes(
        tuple(jnp.asarray(v) for v in vols), kappa,
        bg=tuple(jnp.asarray(b) for b in bg) if with_bg else None)
    got = TO._stacked_effective_volumes(
        tuple(torch.from_numpy(v) for v in vols), kappa,
        bg=tuple(torch.from_numpy(b) for b in bg) if with_bg else None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def _joint_inputs(fabric, R=6, seed=0):
    """float32 inputs of one joint solve as the joint policy builds them,
    with random logits and per-job references."""
    views = job_views(RC, fabric)
    sub = RC.Substrate.of(views[0])
    J = len(views)
    rng = np.random.default_rng(seed)
    lx = rng.normal(0.0, 1.5, size=(R, J, sub.nS, sub.nM)).astype(np.float32)
    ly = rng.normal(0.0, 1.5, size=(R, J, sub.nR)).astype(np.float32)
    D = np.stack([v.D for v in views])
    scale = RC.makespan(views[0], RC.uniform_plan(views[0]), RC.BARRIERS_GGL)
    arrays = [D, np.array([v.alpha for v in views]), sub.B_sm, sub.B_mr,
              sub.C_m, sub.C_r, lx, ly, np.float32(scale),
              rng.uniform(0.5, 2.0, size=J) * scale]
    kappa = max(1e-3 * float(D.sum()) / sub.nM, 1e-9)
    return [np.asarray(a, np.float32) for a in arrays], kappa


@pytest.mark.parametrize("objective", ["makespan", "min_max_slowdown"])
@pytest.mark.parametrize("fabric", FABRICS)
def test_solve_joint_batch_follows_reference(fabric, objective):
    """25 steps from the same logits: x, y at atol 1e-4, the exact
    aggregate at rtol 1e-4 (float32 Adam in another op order)."""
    arrays, kappa = _joint_inputs(fabric)
    statics = dict(kappa=kappa, barriers=RC.BARRIERS_GGL, steps=25,
                   objective=objective)
    want = RO._solve_joint_batch(*(jnp.asarray(a) for a in arrays), **statics)
    got = TO._solve_joint_batch(*(torch.from_numpy(a) for a in arrays),
                                **statics)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


@pytest.fixture(scope="module")
def schedules():
    """Every (fabric, policy, objective) at 6 x 150, reference and port."""
    out = {}
    for fabric in FABRICS:
        for policy, objective in POLICIES:
            kw = dict(policy=policy, barriers=RC.BARRIERS_GGL,
                      objective=objective, **OPT)
            out[fabric, policy, objective] = (
                RC.optimize_schedule(job_views(RC, fabric), **kw),
                TC.optimize_schedule(job_views(TC, fabric), device=CPU, **kw),
            )
    return out


@pytest.mark.parametrize("policy,objective", POLICIES,
                         ids=[f"{p}-{o}" for p, o in POLICIES])
@pytest.mark.parametrize("fabric", FABRICS)
def test_optimize_schedule_matches_reference(schedules, fabric, policy,
                                             objective):
    """Per-job and aggregate shared-capacity makespans within 1e-3
    relative; every plan validates."""
    ref, port = schedules[fabric, policy, objective]
    assert (port.policy, port.mode, port.objective, port.barriers) == (
        ref.policy, ref.mode, ref.objective, ref.barriers)
    assert port.makespan == pytest.approx(ref.makespan, rel=1e-3)
    assert len(port.results) == len(ref.results)
    for p, r in zip(port.results, ref.results):
        assert p.makespan == pytest.approx(r.makespan, rel=1e-3)
        assert p.mode == r.mode == f"{policy}:e2e_multi"
        validate_plan(p.plan.x, p.plan.y)


@pytest.mark.parametrize("fabric", FABRICS)
def test_joint_never_worse_than_independent(schedules, fabric):
    """The independent stack competes inside joint, on both sides: under
    the makespan objective no aggregate worse than independent's, under
    min_max_slowdown no worst slowdown (contended over sole-tenant
    makespan of the independent plan) worse than independent's."""
    for side, pkg in enumerate((RC, TC)):
        indep = schedules[fabric, "independent", "makespan"][side]
        joint = schedules[fabric, "joint", "makespan"][side]
        fair = schedules[fabric, "joint", "min_max_slowdown"][side]
        assert joint.makespan <= indep.makespan
        solo = [pkg.makespan(v, r.plan, RC.BARRIERS_GGL)
                for v, r in zip(job_views(pkg, fabric), indep.results)]

        def worst(res):
            return max(r.makespan / s for r, s in zip(res.results, solo))

        assert worst(fair) <= worst(indep)


def test_shared_schedule_result_bit_identical():
    """The float64 shared pricing of the same plans, both packages."""
    rng = np.random.default_rng(3)
    rviews, tviews = job_views(RC, "planetlab4"), job_views(TC, "planetlab4")
    xs = [rng.dirichlet(np.ones(8), size=8) for _ in rviews]
    ys = [rng.dirichlet(np.ones(8)) for _ in rviews]
    want = RO._shared_schedule_result(
        rviews, [RC.ExecutionPlan(x=x, y=y) for x, y in zip(xs, ys)],
        RC.BARRIERS_GGL, "p", "m")
    got = TO._shared_schedule_result(
        tviews, [TC.ExecutionPlan(x=x, y=y) for x, y in zip(xs, ys)],
        RC.BARRIERS_GGL, "p", "m")
    assert got.makespan == want.makespan
    for g, w in zip(got.results, want.results):
        assert g.breakdown == w.breakdown and g.mode == w.mode == "p:m"


def test_normalized_plans_bit_identical():
    rng = np.random.default_rng(5)
    xs = rng.dirichlet(np.ones(4), size=(3, 4)).astype(np.float32)
    ys = rng.dirichlet(np.ones(3), size=3).astype(np.float32)
    xs[0, 1, 2] = 1e-9  # below 1e-6 of its row max: cut
    for g, w in zip(TO._normalized_plans(xs, ys, "joint"),
                    RO._normalized_plans(xs, ys, "joint")):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert g.meta == w.meta == "joint"


# ---------------------------------------------------------------------------
# the GeoSchedule facade, with word count executed on three corpora
# ---------------------------------------------------------------------------

def _corpora(n_jobs=3, n_sources=8):
    out = []
    for g in range(n_jobs):
        keys, vals = r_apps.generate_documents(
            n_docs=40, words_per_doc=60, vocab=500, seed=g)
        out.append(RA.split_sources(keys, vals, n_sources))
    return out


def _word_counts(report):
    """Each job's (word, count) pairs, merged over its reducers."""
    counts = []
    for job in report.jobs:
        k = np.concatenate([k for k, _ in job.outputs])
        v = np.concatenate([v for _, v in job.outputs])
        order = np.argsort(k, kind="stable")
        counts.append((k[order], v[order]))
    return counts


@pytest.fixture(scope="module")
def facade_reports():
    """GeoSchedule joint plan → simulate and execute, then the same plans
    adopted again through with_plans(), reference and port."""
    corpora = _corpora()
    out = {}
    for name, A, C, app, kw in (
        ("ref", RA, RC, r_apps.word_count(), {}),
        ("port", TA, TC, t_apps.word_count(device=CPU), {"device": CPU}),
    ):
        views = job_views(C, "planetlab4")
        jobs = [A.GeoJob(v, app, **kw).calibrate(srcs)
                for v, srcs in zip(views, corpora)]
        sched = A.GeoSchedule(jobs, **kw).plan(
            "joint", barriers=C.BARRIERS_GGL, **OPT)
        adopted = all(job.planned is res
                      for job, res in zip(jobs, sched.planned.results))
        sim = sched.simulate()
        executed = sched.execute(corpora)
        replay = A.GeoSchedule(jobs, **kw).with_plans()
        out[name] = (adopted, sim, executed, replay.simulate())
    return out


def test_geoschedule_reports_match_reference(facade_reports):
    """as_dict() makespans within 1e-3 relative, word counts equal, and
    every job adopted its shared-priced result."""
    _, rsim, rexe, rrep = facade_reports["ref"]
    adopted, tsim, texe, trep = facade_reports["port"]
    assert adopted
    for got, want in ((tsim, rsim), (texe, rexe), (trep, rrep)):
        gd, wd = got.as_dict(), want.as_dict()
        assert gd.keys() == wd.keys()
        assert (gd["policy"], gd["barriers"]) == (wd["policy"], wd["barriers"])
        for key in ("makespan_modeled", "makespan_sim", "makespan_measured"):
            if key in wd:
                assert gd[key] == pytest.approx(wd[key], rel=1e-3), key
    for (gk, gv), (wk, wv) in zip(_word_counts(texe), _word_counts(rexe)):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)
    assert texe.makespan_measured == pytest.approx(rexe.makespan_measured,
                                                   rel=1e-3)
    assert trep.policy == "external"
    assert trep.makespan_modeled == pytest.approx(tsim.makespan_modeled,
                                                  rel=1e-12)


def test_geoschedule_validates_members():
    views = job_views(TC, "contended_pair")
    with pytest.raises(ValueError, match="at least one job"):
        TA.GeoSchedule([])
    with pytest.raises(TypeError, match="must be GeoJob or GeoPipeline"):
        TA.GeoSchedule([TA.GeoJob(views[0]), object()])
    other = TC.Substrate.of(TC.planetlab_platform(2, seed=0)).view(
        np.ones(8), 1.0)
    with pytest.raises(ValueError, match="does not share the substrate"):
        TA.GeoSchedule([TA.GeoJob(views[0]), TA.GeoJob(other)])
    with pytest.raises(RuntimeError, match="no plan yet"):
        TA.GeoSchedule([TA.GeoJob(views[0])], device=CPU).simulate()
