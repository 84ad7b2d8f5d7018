"""The port's batched torch solver against the reference's jitted jnp
solver: identical initial logits, matching Adam trajectories from the same
inits, matching best objectives in every planner mode, batched == sequential
solves, the solver counters, and brute force."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import optimize as RO  # noqa: E402
from repro.core.plan import uniform_plan as r_uniform  # noqa: E402
from repro.core.platform import (  # noqa: E402
    planetlab_platform as r_planetlab,
    two_cluster_example as r_two_cluster,
)
from repro_torch.core import (  # noqa: E402
    BARRIERS_GGL,
    SolverService,
    brute_force_plan,
    makespan,
    optimize_plan,
    optimize_plan_batch,
    reset_solver_cache_stats,
    solver_cache_stats,
    uniform_plan,
)
from repro_torch.core import optimize as TO  # noqa: E402
from repro_torch.core.plan import validate_plan  # noqa: E402
from repro_torch.core.platform import (  # noqa: E402
    Substrate,
    planetlab_platform,
    two_cluster_example,
)

CPU = "cpu"
MODES = ["uniform", "local_push", "myopic_push", "myopic_multi", "e2e_push",
         "e2e_shuffle", "e2e_multi"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,restarts,seed", [(8, 24, 0), (4, 6, 3), (2, 2, 9)])
def test_initial_logits_identical(n, restarts, seed):
    rlx, rly = RO._initial_logits(r_planetlab(n, seed=seed), restarts, seed)
    tlx, tly = TO._initial_logits(planetlab_platform(n, seed=seed), restarts,
                                  seed)
    assert tlx.dtype == torch.float32 and tly.dtype == torch.float32
    np.testing.assert_array_equal(tlx.numpy(), np.asarray(rlx))
    np.testing.assert_array_equal(tly.numpy(), np.asarray(rly))


@pytest.mark.parametrize("kind,opt_x,opt_y", [("e2e", True, True),
                                              ("push", True, False),
                                              ("shuffle", False, True)])
@pytest.mark.parametrize("barriers", [("G", "G", "G"), ("G", "G", "L"),
                                      ("P", "L", "P")],
                         ids=["GGG", "GGL", "PLP"])
def test_solve_batch_many_follows_reference(kind, opt_x, opt_y, barriers):
    """B=2 requests × R=6 restarts × 25 steps from the same inits: final
    x/y within atol 1e-4, exact objectives within rtol 1e-4 (float32 Adam
    in another op order)."""
    ps = [r_planetlab(8, alpha=1.0, seed=0), r_planetlab(8, alpha=0.3, seed=1)]
    raw = [p.as_arrays() for p in ps]
    arrs = [np.stack([np.asarray(r[i], np.float64) for r in raw]).astype(np.float32)
            for i in range(6)]
    inits = [RO._initial_logits(p, 6, s) for p, s in zip(ps, (0, 1))]
    lx = np.stack([np.asarray(a) for a, _ in inits])
    ly = np.stack([np.asarray(b) for _, b in inits])
    xf = np.stack([r_uniform(p).x for p in ps]).astype(np.float32)
    yf = np.stack([r_uniform(p).y for p in ps]).astype(np.float32)
    sc = np.array([RO.makespan(p, r_uniform(p), barriers) for p in ps],
                  np.float32)
    args = (arrs, lx, ly, xf, yf, sc)
    want = RO._solve_batch_many(
        tuple(jnp.asarray(a) for a in arrs), *(jnp.asarray(a) for a in args[1:]),
        kind, barriers, opt_x, opt_y, 25)
    got = TO._solve_batch_many(
        tuple(torch.from_numpy(a) for a in arrs),
        *(torch.from_numpy(a) for a in args[1:]),
        kind, barriers, opt_x, opt_y, 25)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


@pytest.fixture(scope="module")
def mode_results():
    """Every built-in mode on the paper's 8-DC platform at 6×150, port and
    reference."""
    rp, tp = r_planetlab(8, alpha=1.0, seed=0), planetlab_platform(8, alpha=1.0,
                                                                   seed=0)
    return {
        mode: (RO.optimize_plan(rp, mode, n_restarts=6, steps=150),
               optimize_plan(tp, mode, n_restarts=6, steps=150, device=CPU))
        for mode in MODES
    }


@pytest.mark.parametrize("mode", MODES)
def test_mode_objective_matches_reference(mode_results, mode):
    """Best objective within 1e-3 relative of the reference's (float32
    anneals that agree step by step drift apart over 150 steps)."""
    ref, port = mode_results[mode]
    assert port.objective == pytest.approx(ref.objective, rel=1e-3)
    assert port.makespan == pytest.approx(ref.makespan, rel=1e-3)
    assert port.mode == mode and port.barriers == ref.barriers
    validate_plan(port.plan.x, port.plan.y)


def test_e2e_multi_dominates_other_modes(mode_results):
    multi = mode_results["e2e_multi"][1]
    p = planetlab_platform(8, alpha=1.0, seed=0)
    assert multi.makespan <= makespan(p, uniform_plan(p)) + 1e-6
    for mode in ["uniform", "local_push", "myopic_multi", "e2e_push",
                 "e2e_shuffle"]:
        assert multi.makespan <= mode_results[mode][1].makespan * 1.01, mode


def _small_platform(name="svc_small"):
    """A 2x2x2 platform: the differently-shaped problem for key tests."""
    return Substrate(
        B_sm=np.array([[200.0, 150.0], [150.0, 200.0]]),
        B_mr=np.array([[500.0, 100.0], [500.0, 100.0]]),
        C_m=np.array([100.0, 100.0]),
        C_r=np.array([2000.0, 2000.0]),
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name=name,
    ).view(np.array([8000.0, 8000.0]), 1.0, name=name)


def _delta(before):
    after = solver_cache_stats()
    return {k: after[k] - before[k] for k in after}


class TestSolverCounters:
    """Counter semantics; each test uses its own step budget so that no
    other test's solve makes its first call a hit."""

    def test_same_shape_second_solve_is_a_hit(self):
        opts = dict(n_restarts=3, steps=41, device=CPU)
        optimize_plan(planetlab_platform(2, alpha=0.7, seed=0), seed=1, **opts)
        before = solver_cache_stats()
        optimize_plan(planetlab_platform(2, alpha=1.3, seed=1), seed=2, **opts)
        d = _delta(before)
        assert d["compiles"] == 0, d
        assert d["hits"] == d["calls"] == 1 and d["misses"] == 0, d

    def test_different_shape_compiles_exactly_once(self):
        opts = dict(n_restarts=3, steps=43, device=CPU)
        optimize_plan(planetlab_platform(2, seed=0), seed=1, **opts)
        before = solver_cache_stats()
        optimize_plan(_small_platform(), seed=1, **opts)
        d = _delta(before)
        assert d["compiles"] == 1 and d["misses"] == 1, d
        before = solver_cache_stats()
        optimize_plan(_small_platform("svc_small_2"), seed=3, **opts)
        d = _delta(before)
        assert d["compiles"] == 0 and d["hits"] == d["calls"], d

    def test_reset_zeroes_counters_not_first_call_history(self):
        opts = dict(n_restarts=3, steps=53, device=CPU)
        optimize_plan(planetlab_platform(2, seed=0), seed=1, **opts)
        reset_solver_cache_stats()
        assert solver_cache_stats() == {"calls": 0, "hits": 0, "misses": 0,
                                        "compiles": 0, "entries": 0,
                                        "shapes": 0}
        optimize_plan(planetlab_platform(2, seed=0), seed=1, **opts)
        d = solver_cache_stats()
        assert d["misses"] == 1 and d["compiles"] == 0, d
        assert d["entries"] == 1 and d["shapes"] == 1, d

    def test_solver_service_shares_the_process_counters(self):
        svc1 = SolverService(mode="e2e_multi", barriers=BARRIERS_GGL,
                             n_restarts=3, steps=59, device=CPU)
        svc2 = SolverService(mode="e2e_multi", barriers=BARRIERS_GGL,
                             n_restarts=3, steps=59, device=CPU)
        svc1.plan(planetlab_platform(2, seed=0), seed=1)
        res = svc2.plan_many([planetlab_platform(2, seed=1),
                              planetlab_platform(2, seed=2)], seeds=[3, 4])
        assert len(res) == 2
        # a batch of 2 is a new key (B is a shape axis) that the other
        # service instance then hits
        before = svc2.stats()
        svc1.plan_many([planetlab_platform(2, seed=3),
                        planetlab_platform(2, seed=4)], seeds=[5, 6])
        d = _delta(before)
        assert d["compiles"] == 0 and d["hits"] == d["calls"] == 1, d


@pytest.mark.parametrize("mode", ["e2e_multi", "myopic_multi", "e2e_push"])
def test_plan_batch_matches_sequential(mode):
    """Batching requests changes nothing but float32 batching round-off:
    short anneals keep that below atol 1e-6 on the plans."""
    opts = dict(n_restarts=4, steps=10, device=CPU)
    plats = [planetlab_platform(2, alpha=a, seed=s)
             for s, a in enumerate((0.5, 1.0, 2.0))]
    seeds = [11, 12, 13]
    batch = optimize_plan_batch(plats, mode, barriers=BARRIERS_GGL,
                                seeds=seeds, **opts)
    for p, s, b in zip(plats, seeds, batch):
        solo = optimize_plan(p, mode, barriers=BARRIERS_GGL, seed=s, **opts)
        np.testing.assert_allclose(b.plan.x, solo.plan.x, atol=1e-6)
        np.testing.assert_allclose(b.plan.y, solo.plan.y, atol=1e-6)
        assert b.makespan == pytest.approx(solo.makespan, rel=1e-4)


def test_plan_batch_groups_shapes_and_checks_seeds():
    opts = dict(n_restarts=2, steps=5, device=CPU)
    plats = [planetlab_platform(2, seed=0), planetlab_platform(4, seed=0),
             planetlab_platform(2, seed=1)]
    res = optimize_plan_batch(plats, "e2e_multi", seeds=[1, 2, 3], **opts)
    assert [r.plan.x.shape[1] for r in res] == [p.nM for p in plats]
    with pytest.raises(ValueError, match="one seed per platform"):
        optimize_plan_batch(plats[:1], "e2e_multi", seeds=[1, 2], **opts)
    with pytest.raises(ValueError, match="mode must be one of"):
        optimize_plan_batch(plats[:1], "no_such_mode", **opts)


@pytest.mark.parametrize("seed,alpha", [(0, 0.1), (3, 1.0), (5, 2.0)])
def test_linearization_matches_reference(seed, alpha):
    """The paper's MIP linearization (the copied ``milp.py``) over the
    port's platform and a random plan: bit-identical to the reference's and
    within its 10% bar of the exact model."""
    from repro.core import milp as r_milp
    from repro.core.plan import ExecutionPlan as RPlan
    from repro_torch.core import milp as t_milp
    from repro_torch.core.plan import ExecutionPlan

    rng = np.random.default_rng(seed)
    x = rng.dirichlet(np.ones(8), size=8)
    y = rng.dirichlet(np.ones(8))
    rp, tp = r_planetlab(8, alpha=alpha, seed=seed), planetlab_platform(
        8, alpha=alpha, seed=seed)
    gap = t_milp.linearization_gap(tp, ExecutionPlan(x=x, y=y))
    assert gap == r_milp.linearization_gap(rp, RPlan(x=x, y=y))
    assert gap < 0.10
    assert t_milp.worst_case_pwl_deviation(9) < 0.0062


@pytest.mark.parametrize("alpha", [0.1, 1.0, 10.0])
def test_brute_force_matches_reference(alpha):
    """Same grid, same first-minimum rule: the float32 grid minimum agrees
    to rtol 1e-6, and the annealed solver matches or beats it."""
    ref = RO.brute_force_plan(r_two_cluster(alpha=alpha, nonlocal_bw=10.0),
                              grid=20)
    p = two_cluster_example(alpha=alpha, nonlocal_bw=10.0)
    port = brute_force_plan(p, grid=20, device=CPU)
    assert port.makespan == pytest.approx(ref.makespan, rel=1e-6)
    np.testing.assert_array_equal(port.plan.x, ref.plan.x)
    np.testing.assert_array_equal(port.plan.y, ref.plan.y)
    opt = optimize_plan(p, "e2e_multi", n_restarts=12, steps=400, device=CPU)
    assert opt.makespan <= port.makespan * 1.02
