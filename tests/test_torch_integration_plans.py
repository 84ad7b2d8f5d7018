"""The paper's planner applied to multi-pod training through the port:
cross-pod gradient aggregation (``repro_torch.core.collective_plan``) and
MoE dispatch planning (``repro_torch.core.moe_plan``), on the CPU.

Every case of ``tests/test_integration_plans.py`` runs through the port,
and each is held to the reference on the same inputs: the same fractions
within 0.02, ``est_time_s`` within 1e-3 relative (the port's solver bar),
segment sizes summing exactly to ``n_elements``, and never worse than the
uniform plan.  One case is held otherwise: with slow experts the
reference's own ``e2e_shuffle`` anneal has not settled at 8 × 300 (two of
its seeds end 0.9% apart), and from the same initial logits the two
packages agree to 1e-6 at 25 steps and then part by a factor of ten every
20 steps or so, as float32 rounding steers each; that case holds the 25
steps to the solver bar, the fractions within 0.02, and the plan never
worse than uniform.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import collective_plan as RCP  # noqa: E402
from repro.core import moe_plan as RMP  # noqa: E402
from repro_torch.core.collective_plan import plan_cross_pod_reduction  # noqa: E402
from repro_torch.core.moe_plan import plan_moe_dispatch  # noqa: E402

#: the reference test file's cases, by name: (planner kwargs)
REDUCTIONS = {
    "homogeneous": dict(grad_mb=4000.0, pod_dcn_bw_mbps=[6400] * 4,
                        n_elements=1 << 20),
    "slow_pod": dict(grad_mb=4000.0, pod_dcn_bw_mbps=[6400, 6400, 1600, 6400],
                     n_elements=1 << 20),
    "unaligned": dict(grad_mb=1000.0, pod_dcn_bw_mbps=[6400, 3200],
                      n_elements=1_000_003),
}
DISPATCHES = {
    "homogeneous": dict(tokens_mb_per_shard=64.0, n_token_shards=4,
                        group_pod=[0, 0, 1, 1], shard_pod=[0, 0, 1, 1],
                        top_k=1),
    "slow_experts": dict(tokens_mb_per_shard=64.0, n_token_shards=4,
                         group_pod=[0, 0, 1, 1], shard_pod=[0, 0, 1, 1],
                         top_k=1,
                         expert_flops_rate_mbps=[25000, 25000, 8000, 8000]),
    "capacity_cap": dict(tokens_mb_per_shard=64.0, n_token_shards=2,
                         group_pod=[0, 1, 1, 1], shard_pod=[0, 1], top_k=2,
                         expert_flops_rate_mbps=[50000, 1000, 1000, 1000],
                         max_capacity_factor=2.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reduction(name):
    return plan_cross_pod_reduction(**REDUCTIONS[name], device="cpu")


def _dispatch(name):
    return plan_moe_dispatch(**DISPATCHES[name], device="cpu")


# --- the reference test file's cases, through the port ------------------------

def test_homogeneous_dcn_is_uniform():
    rp = _reduction("homogeneous")
    assert np.allclose(rp.fractions, 0.25, atol=0.02)
    assert rp.speedup_vs_uniform == pytest.approx(1.0, abs=1e-3)


def test_slow_pod_owns_less():
    rp = _reduction("slow_pod")
    assert rp.fractions[2] < 0.15  # the 4x-slower pod owns much less
    assert rp.speedup_vs_uniform > 1.05
    assert rp.est_time_s <= rp.uniform_time_s + 1e-9


def test_segments_partition_exactly():
    n = REDUCTIONS["unaligned"]["n_elements"]  # deliberately non-aligned
    rp = _reduction("unaligned")
    assert int(rp.segment_sizes.sum()) == n
    assert (rp.segment_sizes >= 0).all()
    offs = rp.segment_offsets()
    assert offs[0] == 0 and offs[-1] == n


def test_moe_homogeneous_is_uniform():
    mp = _dispatch("homogeneous")
    assert np.allclose(mp.group_fractions, 0.25, atol=0.02)


def test_slow_experts_get_fewer_tokens():
    mp = _dispatch("slow_experts")
    assert mp.group_fractions[:2].sum() > mp.group_fractions[2:].sum()
    assert mp.speedup_vs_uniform > 1.1
    # the bias implements the fractions in log space
    assert np.all(mp.router_bias[:2] > mp.router_bias[2:].max())


def test_capacity_cap_respected():
    mp = _dispatch("capacity_cap")
    assert mp.group_fractions.max() <= 2.0 / 4 + 1e-9
    assert mp.capacity_factor.max() <= 2.0 + 1e-9


# --- port against reference ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_plan_matches_the_reference(name):
    got = _reduction(name)
    want = RCP.plan_cross_pod_reduction(**REDUCTIONS[name])
    np.testing.assert_allclose(got.fractions, want.fractions, atol=0.02)
    np.testing.assert_allclose(got.est_time_s, want.est_time_s, rtol=1e-3)
    assert got.uniform_time_s == want.uniform_time_s  # float64, bit for bit
    assert int(got.segment_sizes.sum()) == got.n_elements == want.n_elements
    assert got.block == want.block
    assert got.est_time_s <= got.uniform_time_s + 1e-9


@pytest.mark.parametrize("name", ["capacity_cap", "homogeneous"])
def test_dispatch_plan_matches_the_reference(name):
    got = _dispatch(name)
    want = RMP.plan_moe_dispatch(**DISPATCHES[name])
    np.testing.assert_allclose(got.group_fractions, want.group_fractions,
                               atol=0.02)
    np.testing.assert_allclose(got.est_time_s, want.est_time_s, rtol=1e-3)
    assert got.uniform_time_s == want.uniform_time_s
    np.testing.assert_allclose(got.capacity_factor,
                               got.group_fractions * len(got.group_fractions),
                               rtol=1e-12)
    assert got.est_time_s <= got.uniform_time_s + 1e-9


def test_platforms_are_the_reference_s():
    """The two platform builders are numpy, and give the reference's
    arrays bit for bit."""
    from repro_torch.core.collective_plan import reduction_platform
    from repro_torch.core.moe_plan import moe_platform

    pairs = [
        (reduction_platform(4000.0, [6400, 1600, 3200]),
         RCP.reduction_platform(4000.0, [6400, 1600, 3200])),
        (moe_platform(64.0, 2, [0, 1, 1, 1], [0, 1], top_k=2),
         RMP.moe_platform(64.0, 2, [0, 1, 1, 1], [0, 1], top_k=2)),
    ]
    for got, want in pairs:
        for field in ("D", "B_sm", "B_mr", "C_m", "C_r", "cluster_s",
                      "cluster_m", "cluster_r"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.alpha == want.alpha and got.name == want.name


def test_slow_experts_dispatch_follows_the_reference():
    """The slow-experts plan: 25 steps of the planner's own solve (its
    platform, its 8 restarts' initial logits, ``x`` pinned to the identity)
    within the solver bar of the reference's (x, y atol 1e-4, exact
    objective rtol 1e-4); the full plan's fractions within 0.02 of the
    reference's and never worse than uniform."""
    import jax.numpy as jnp
    import torch

    from repro.core import optimize as RO
    from repro.core.makespan import makespan as r_makespan
    from repro.core.plan import ExecutionPlan as RPlan
    from repro_torch.core import optimize as TO

    kw = DISPATCHES["slow_experts"]
    plat = RMP.moe_platform(kw["tokens_mb_per_shard"], kw["n_token_shards"],
                            kw["group_pod"], kw["shard_pod"], kw["top_k"],
                            expert_flops_rate_mbps=kw["expert_flops_rate_mbps"])
    barriers = ("P", "P", "P")
    arrs = [np.asarray(a, np.float64)[None].astype(np.float32)
            for a in plat.as_arrays()]
    lx, ly = (np.asarray(a)[None] for a in RO._initial_logits(plat, 8, 0))
    xf = np.eye(4, dtype=np.float32)[None]
    yf = np.full((1, 4), 0.25, np.float32)
    sc = np.array([r_makespan(plat, RPlan(x=np.eye(4), y=yf[0]), barriers)],
                  np.float32)
    want = RO._solve_batch_many(
        tuple(jnp.asarray(a) for a in arrs),
        *(jnp.asarray(a) for a in (lx, ly, xf, yf, sc)),
        "e2e", barriers, False, True, 25)
    got = TO._solve_batch_many(
        tuple(torch.from_numpy(a) for a in arrs),
        *(torch.from_numpy(a) for a in (lx, ly, xf, yf, sc)),
        "e2e", barriers, False, True, 25)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)
    port, ref = _dispatch("slow_experts"), RMP.plan_moe_dispatch(**kw)
    np.testing.assert_allclose(port.group_fractions, ref.group_fractions,
                               atol=0.02)
    assert port.uniform_time_s == ref.uniform_time_s
    assert port.est_time_s <= port.uniform_time_s + 1e-9


def test_slow_experts_anneal_has_not_settled_in_the_reference():
    """Witness for the case above: two seeds of the reference's own plan
    end more than 1e-3 apart, so 1e-3 between the packages is no invariant
    of the reference there."""
    kw = DISPATCHES["slow_experts"]
    a, b = (RMP.plan_moe_dispatch(**kw, seed=s).est_time_s for s in (0, 1))
    assert abs(a - b) > 1e-3 * min(a, b)
