"""The port's makespan model against the reference's: float64 pricing is
bit-identical over every barrier triple, and the smooth float32 model and
its gradient match the jnp model and ``jax.grad``."""
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad  # noqa: E402

from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.core.platform import planetlab_platform as r_planetlab  # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan  # noqa: E402
from repro_torch.core.platform import planetlab_platform as t_planetlab  # noqa: E402

# the packages re-export a function named `makespan` over the submodule
RM = importlib.import_module("repro.core.makespan")
TM = importlib.import_module("repro_torch.core.makespan")

BARRIER_TRIPLES = list(itertools.product("GLP", repeat=3))
IDS = ["".join(b) for b in BARRIER_TRIPLES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plans(seed, nS, nM, nR):
    rng = np.random.default_rng(seed)
    x = rng.dirichlet(np.ones(nM), size=nS)
    y = rng.dirichlet(np.ones(nR))
    return RPlan(x=x, y=y), TPlan(x=x, y=y)


@pytest.mark.parametrize("barriers", BARRIER_TRIPLES, ids=IDS)
def test_cost_model_pricing_bit_identical(barriers):
    rp, tp = r_planetlab(8, alpha=1.7, seed=3), t_planetlab(8, alpha=1.7, seed=3)
    rplan, tplan = _plans(7, rp.nS, rp.nM, rp.nR)
    want = RM.CostModel(rp, barriers).price_plan(rplan)
    got = TM.CostModel(tp, barriers).price_plan(tplan)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert (TM.makespan(tp, tplan, barriers)
            == RM.makespan(rp, rplan, barriers))
    assert (TM.phase_breakdown(tp, tplan, barriers)
            == RM.phase_breakdown(rp, rplan, barriers))
    # measured volumes take the same float64 path
    vols = RM.CostModel(rp).analytic_volumes(rplan)
    assert (TM.CostModel(tp, barriers).breakdown_volumes(*vols)
            == RM.CostModel(rp, barriers).breakdown_volumes(*vols))


SMOOTH_CASES = [(tau, b) for tau in (1.0, 10.0, 100.0)
                for b in (("G", "G", "G"), ("G", "G", "L"), ("P", "L", "P"))]


@pytest.mark.parametrize("tau,barriers", SMOOTH_CASES,
                         ids=[f"tau{t:g}-{''.join(b)}" for t, b in SMOOTH_CASES])
def test_smooth_model_value_matches(tau, barriers):
    """Float32 smooth model at a fixed temperature: rtol 1e-5 (float32
    logsumexp in another order)."""
    rp, tp = r_planetlab(8, seed=1), t_planetlab(8, seed=1)
    rplan, tplan = _plans(2, rp.nS, rp.nM, rp.nR)
    want = RM.makespan(rp, rplan, barriers, tau=tau)
    got = TM.makespan(tp, tplan, barriers, tau=tau, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    # the smooth bound sits above the exact makespan
    assert got >= TM.makespan(tp, tplan, barriers) * (1 - 1e-5)


@pytest.mark.parametrize("tau,barriers", SMOOTH_CASES,
                         ids=[f"tau{t:g}-{''.join(b)}" for t, b in SMOOTH_CASES])
def test_smooth_model_gradient_matches_jax_grad(tau, barriers):
    """d makespan / d(x, y) of the smooth model: rtol 1e-4 plus atol
    1e-6·max|g| (float32 gradients of logsumexp chains)."""
    p = r_planetlab(8, seed=4)
    rplan, _ = _plans(5, p.nS, p.nM, p.nR)
    arrs = [np.asarray(a, np.float32) for a in p.as_arrays()[:5]]
    alpha = float(p.alpha)

    def jloss(x, y):
        return RM.makespan_model(*[jnp.asarray(a) for a in arrs], alpha, x, y,
                                 barriers=barriers, tau=tau)["makespan"]

    gx_j, gy_j = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(rplan.x, jnp.float32), jnp.asarray(rplan.y, jnp.float32))

    targs = [torch.from_numpy(a) for a in arrs]

    def tloss(x, y):
        return TM.makespan_model(*targs, alpha, x, y, barriers=barriers,
                                 tau=tau)["makespan"]

    gx_t, gy_t = grad(tloss, argnums=(0, 1))(
        torch.tensor(rplan.x, dtype=torch.float32),
        torch.tensor(rplan.y, dtype=torch.float32))
    for got, want in ((gx_t.numpy(), np.asarray(gx_j)),
                      (gy_t.numpy(), np.asarray(gy_j))):
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def test_hard_ops_reduce_like_numpy():
    v = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mx, pmax = TM.hard_ops()
    np.testing.assert_array_equal(mx(v, axis=0).numpy(), v.numpy().max(axis=0))
    assert float(mx(v)) == 11.0
    smx, _ = TM.smooth_ops(torch.tensor(1e-3))
    np.testing.assert_allclose(smx(v, axis=0).numpy(), v.numpy().max(axis=0),
                               atol=1e-2)
