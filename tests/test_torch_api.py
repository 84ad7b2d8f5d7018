"""The port's ``GeoJob`` slice end to end against the reference's, on the
CPU: calibration, pricing of external plans, the discrete-event simulator,
the planned loop ``calibrate → plan("e2e_multi") → execute``, and the
conversion of the reference's platforms and plans into the port's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import GeoJob as RGeoJob  # noqa: E402
from repro.api import split_sources as r_split  # noqa: E402
from repro.core.makespan import makespan as r_makespan  # noqa: E402
from repro.core.plan import ExecutionPlan as RPlan  # noqa: E402
from repro.core.plan import local_push_plan as r_local  # noqa: E402
from repro.core.plan import uniform_plan as r_uniform  # noqa: E402
from repro.core.platform import CapacityTrace as RTrace  # noqa: E402
from repro.core.platform import FailureEvent as RFailure  # noqa: E402
from repro.core.platform import Substrate as RSubstrate  # noqa: E402
from repro.core.platform import planetlab_platform as r_planetlab  # noqa: E402
from repro.core.simulate import SimConfig as RSimConfig  # noqa: E402
from repro.core.simulate import simulate as r_simulate  # noqa: E402
from repro.mapreduce.apps import generate_documents, word_count as r_word_count  # noqa: E402
from repro_torch.api import GeoJob, split_sources  # noqa: E402
from repro_torch.convert import plan_from_fields, platform_from_fields  # noqa: E402
from repro_torch.core.makespan import makespan  # noqa: E402
from repro_torch.core.plan import local_push_plan, uniform_plan  # noqa: E402
from repro_torch.core.platform import planetlab_platform  # noqa: E402
from repro_torch.core.simulate import SimConfig, simulate  # noqa: E402
from repro_torch.mapreduce.apps import word_count  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    keys, vals = generate_documents(800, 60, seed=0)
    return r_split(keys, vals, 8)


@pytest.fixture(scope="module")
def jobs(corpus):
    """The calibrated word-count job on the paper's 8-DC platform: the
    reference's and the port's."""
    ref = RGeoJob(r_planetlab(8, alpha=1.0, seed=0), r_word_count()).calibrate(corpus)
    port = GeoJob(planetlab_platform(8, alpha=1.0, seed=0),
                  word_count(device=CPU), device=CPU).calibrate(corpus)
    return ref, port


def test_split_sources_identical(corpus):
    keys, vals = generate_documents(800, 60, seed=0)
    for (tk, tv), (rk, rv) in zip(split_sources(keys, vals, 8), corpus):
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tv, rv)


def test_calibrate_gives_the_same_alpha_and_volumes(jobs):
    ref, port = jobs
    assert port.platform.alpha == ref.platform.alpha
    np.testing.assert_array_equal(port.platform.D, ref.platform.D)
    assert port.device == CPU


def _report_pair(jobs, corpus, plan_name):
    ref, port = jobs
    r_plan = {"uniform": r_uniform, "local_push": r_local}[plan_name](ref.platform)
    t_plan = {"uniform": uniform_plan, "local_push": local_push_plan}[plan_name](
        port.platform)
    return (ref.with_plan(r_plan).execute(corpus),
            port.with_plan(t_plan).execute(corpus))


@pytest.mark.parametrize("plan_name", ["uniform", "local_push"])
def test_with_plan_reports_identical(jobs, corpus, plan_name):
    """Float64 pricing on both sides: identical to the last bit."""
    r_rep, t_rep = _report_pair(jobs, corpus, plan_name)
    assert t_rep.measured == r_rep.measured
    assert t_rep.modeled == r_rep.modeled
    assert t_rep.model_error() == r_rep.model_error()
    assert t_rep.summary() == r_rep.summary()
    for (tk, tv), (rk, rv) in zip(t_rep.outputs, r_rep.outputs):
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tv, rv)


@pytest.mark.parametrize("plan_name", ["uniform", "local_push"])
def test_simulate_makespan_identical(jobs, plan_name):
    ref, port = jobs
    r_plan = {"uniform": r_uniform, "local_push": r_local}[plan_name](ref.platform)
    t_plan = {"uniform": uniform_plan, "local_push": local_push_plan}[plan_name](
        port.platform)
    r_sim = ref.with_plan(r_plan).simulate()
    t_sim = port.with_plan(t_plan).simulate()
    assert t_sim.makespan == r_sim.makespan
    assert t_sim.as_dict() == r_sim.as_dict()


def test_planned_loop_matches_reference(jobs, corpus):
    """``plan("e2e_multi", 6×150)`` then ``execute``: the float32 anneals
    agree step by step and drift apart by float32 round-off over 150 steps,
    so the makespans agree within 1e-3 relative; the word counts exactly."""
    ref, port = jobs
    opts = dict(n_restarts=6, steps=150)
    r_rep = ref.plan("e2e_multi", **opts).execute(corpus)
    t_rep = port.plan("e2e_multi", **opts).execute(corpus)
    assert t_rep.result.mode == "e2e_multi"
    assert t_rep.makespan_modeled == pytest.approx(r_rep.makespan_modeled, rel=1e-3)
    assert t_rep.makespan_measured == pytest.approx(r_rep.makespan_measured,
                                                    rel=1e-3)
    assert np.isfinite(t_rep.model_error())
    t_counts = np.concatenate([v for _, v in t_rep.outputs])
    r_counts = np.concatenate([v for _, v in r_rep.outputs])
    assert t_counts.sum() == r_counts.sum() == sum(k.shape[0] for k, _ in corpus)
    # the optimized plan beats both baselines on the measured makespan
    for name in ("uniform", "local_push"):
        _, base = _report_pair(jobs, corpus, name)
        assert t_rep.makespan_measured < base.makespan_measured, name


def _reference_state():
    """A reference platform that is a view of a substrate carrying capacity
    traces and a failure script, and a non-trivial plan."""
    base = r_planetlab(4, alpha=0.8, seed=2)
    sub = (RSubstrate.of(base)
           .with_traces({"push[s0->m1]": RTrace.step(40.0, 10.0, 5.0),
                         "reduce[r2]": RTrace(times=(0.0, 3.0, 9.0),
                                              values=(50.0, 20.0, 60.0))})
           .with_failures([RFailure.mapper_kill(1, 4.0),
                           RFailure.cluster_partition(0, 2.0, t_repair=6.0)]))
    platform = sub.view(base.D, base.alpha, name="converted")
    rng = np.random.default_rng(1)
    plan = RPlan(x=rng.dirichlet(np.ones(platform.nM), size=platform.nS),
                 y=rng.dirichlet(np.ones(platform.nR)), meta="random")
    return platform, plan


def _assert_same_fields(got, want, path="platform"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_fields(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_fields(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_convert_round_trips_platform_and_plan():
    r_platform, r_plan = _reference_state()
    fields = dataclasses.asdict(r_platform)
    platform = platform_from_fields(fields)
    plan = plan_from_fields(dataclasses.asdict(r_plan))
    # every field, the substrate's traces and failures included, survives
    _assert_same_fields(dataclasses.asdict(platform), fields)
    _assert_same_fields(dataclasses.asdict(plan), dataclasses.asdict(r_plan),
                        "plan")
    assert platform.substrate is not None
    assert platform.substrate.failures is not None
    assert len(platform.substrate.failures) == 2
    assert platform.substrate.drift_times() == r_platform.substrate.drift_times()
    # the converted objects price and simulate as the reference's do
    for barriers in (("G", "G", "L"), ("P", "L", "G")):
        assert makespan(platform, plan, barriers) == r_makespan(r_platform, r_plan,
                                                                barriers)
    got = simulate(platform, plan, SimConfig())
    want = r_simulate(r_platform, r_plan, RSimConfig())
    assert got.as_dict() == want.as_dict()
