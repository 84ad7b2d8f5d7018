"""The port's multi-stage pipelines against the reference's: the stage-DAG
validation, ``derived_D`` and the float64 end-to-end pricing bit for bit,
the pipeline planner registry, the ``end_to_end`` solver's inputs bit for
bit and its 25-step trajectories from the reference's logits,
``optimize_pipeline`` in both modes, the ``GeoPipeline`` facade (adoption,
``with_plans``, ``as_dict``, an executed word-count chain) and a pipeline
inside ``GeoSchedule`` (plan, simulate, the refused ``execute``, and
``run_online``), on a 2-node chain fabric and a 3-stage diamond over the
4-data-centre (8-node) PlanetLab platform, all on the CPU."""
import dataclasses
import json

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
GGL = ("G", "G", "L")
SIDES = {"ref": (RA, RC), "port": (TA, TC)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solves here are many small operations: under several test
    workers torch's thread pool only contends for the cores (a tenfold
    slowdown), and one thread also keeps the float32 sums in one order
    whatever the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def chain_substrate(C, traces=None):
    """Asymmetric outgoing access: node 0 hosts the fast reducer but its
    outgoing push links crawl — the stagewise trap."""
    sub = C.Substrate(
        B_sm=np.array([[4.0, 4.0], [200.0, 200.0]]),
        B_mr=np.full((2, 2), 200.0),
        C_m=np.array([100.0, 100.0]),
        C_r=np.array([300.0, 60.0]),
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name="chain_pair",
    )
    return sub.with_traces(traces) if traces else sub


def chain_views(C):
    sub = chain_substrate(C)
    return [sub.view(np.array([0.0, 6000.0]), 1.0, name="ingest"),
            sub.view(np.zeros(2), 1.0, name="transform"),
            sub.view(np.zeros(2), 0.5, name="aggregate")]


def diamond_views(C):
    """A root, a stage fed by it, and a sink fed by both (two parents)."""
    sub = C.Substrate.of(C.planetlab_platform(4, alpha=1.0, seed=0))
    D = np.full(sub.nS, 300.0)
    D[1] = 1800.0
    return [sub.view(D, 1.0, name="root"),
            sub.view(np.zeros(sub.nS), 0.5, name="mid"),
            sub.view(np.zeros(sub.nS), 2.0, name="sink")]


def even_diamond_views(C):
    """The diamond's DAG with the same input at every source and alpha 1
    in every stage."""
    sub = C.Substrate.of(C.planetlab_platform(4, alpha=1.0, seed=0))
    return [sub.view(np.full(sub.nS, 500.0), 1.0, name="root"),
            sub.view(np.zeros(sub.nS), 1.0, name="mid"),
            sub.view(np.zeros(sub.nS), 1.0, name="sink")]


DIAMOND = ((0, 1), (0, 2), (1, 2))
#: spec name -> (stage views, edges, out_scales)
SPECS = {
    "chain": (chain_views, ((0, 1), (1, 2)), (1.0, 1.0, 1.0)),
    "diamond": (diamond_views, DIAMOND, (0.5, 1.5, 1.0)),
    "even_diamond": (even_diamond_views, DIAMOND, (0.5, 0.5, 1.0)),
}


def make_spec(C, name):
    views_fn, edges, scales = SPECS[name]
    views = views_fn(C)
    return C.PipelineSpec(stages=tuple(
        C.StageSpec(v, deps=tuple(u for u, w in edges if w == k),
                    out_scale=s, name=f"{name}/stage{k}")
        for k, (v, s) in enumerate(zip(views, scales))
    ))


def random_plans(C, name, seed=3):
    spec = make_spec(C, name)
    sub = spec.substrate
    rng = np.random.default_rng(seed)
    return [C.ExecutionPlan(x=rng.dirichlet(np.ones(sub.nM), size=sub.nS),
                            y=rng.dirichlet(np.ones(sub.nR)))
            for _ in spec.stages]


# ---------------------------------------------------------------------------
# the stage DAG (a copy of the reference's module) and its float64 pricing
# ---------------------------------------------------------------------------

def _invalid(C, case):
    sub = chain_substrate(C)
    root = sub.view(np.full(2, 10.0), 1.0)
    if case == "cycle":
        C.PipelineSpec(stages=(C.StageSpec(root, deps=(1,)),
                               C.StageSpec(sub.view(np.zeros(2), 1.0),
                                           deps=(0,))))
    elif case == "duplicate_deps":
        C.StageSpec(root, deps=(0, 0))
    elif case == "negative_out_scale":
        C.StageSpec(root, out_scale=-0.5)
    elif case == "non_square":
        wide = C.Substrate(
            B_sm=np.full((2, 2), 100.0), B_mr=np.full((2, 3), 100.0),
            C_m=np.full(2, 100.0), C_r=np.full(3, 100.0),
            cluster_s=np.zeros(2, dtype=int), cluster_m=np.zeros(2, dtype=int),
            cluster_r=np.zeros(3, dtype=int))
        C.PipelineSpec(stages=(
            C.StageSpec(wide.view(np.full(2, 10.0), 1.0)),
            C.StageSpec(wide.view(np.zeros(2), 1.0), deps=(0,))))
    elif case == "substrate_mismatch":
        C.PipelineSpec(stages=(C.StageSpec(root),
                               C.StageSpec(C.two_cluster_example(),
                                           deps=(0,))))


@pytest.mark.parametrize("case,pattern", [
    ("cycle", "cycle"), ("duplicate_deps", "duplicate"),
    ("negative_out_scale", "out_scale"), ("non_square", "nS"),
    ("substrate_mismatch", "substrate")])
def test_spec_validation_matches_reference(case, pattern):
    messages = []
    for C in (RC, TC):
        with pytest.raises(ValueError, match=pattern) as err:
            _invalid(C, case)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("barriers", [GGL, ("G", "G", "G"), ("P", "P", "P")],
                         ids="".join)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_derived_D_and_price_pipeline_bit_identical(name, barriers):
    want_spec, got_spec = make_spec(RC, name), make_spec(TC, name)
    rplans, tplans = random_plans(RC, name), random_plans(TC, name)
    for g, w in zip(got_spec.derived_D(tplans), want_spec.derived_D(rplans)):
        np.testing.assert_array_equal(g, w)
    want = RO._pipeline_result(want_spec, rplans, barriers, "m", "s", 0.0)
    got = TO._pipeline_result(got_spec, tplans, barriers, "m", "s", 0.0)
    assert (got.makespan, got.starts, got.finishes) == (
        want.makespan, want.starts, want.finishes)
    for g, w in zip(got.stage_D, want.stage_D):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.results, want.results):
        assert g.breakdown == w.breakdown and g.mode == w.mode == "m:s"
    assert repr(got) == repr(want)


def test_pipeline_registry_matches_reference():
    assert TC.available_pipeline_modes() == RC.available_pipeline_modes() == (
        "stagewise", "end_to_end")
    with pytest.raises(ValueError, match="pipeline mode must be one of"):
        TC.optimize_pipeline(make_spec(TC, "chain"), mode="nope", device=CPU)
    with pytest.raises(ValueError, match="already registered"):
        TC.register_pipeline_planner("stagewise", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# the end_to_end solver
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _recorder(store):
    def solve(*args, **kwargs):
        store.append((args, kwargs))
        raise _Stop
    return solve


@pytest.fixture(scope="module")
def solver_inputs():
    """Per spec, the arguments each package's ``end_to_end`` planner hands
    its solver at 6 x 150: the reference's from its own stagewise stack,
    the port's from the same stagewise plans."""
    out = {}
    real = RO._stagewise_plans
    with pytest.MonkeyPatch.context() as mp:
        for name in SPECS:
            stagewise, ref, port = [], [], []

            def keep(*args, **kwargs):
                stagewise.extend(real(*args, **kwargs))
                return list(stagewise)

            mp.setattr(RO, "_stagewise_plans", keep)
            mp.setattr(RO, "_solve_pipeline_batch", _recorder(ref))
            with pytest.raises(_Stop):
                RC.optimize_pipeline(make_spec(RC, name), "end_to_end",
                                     barriers=GGL, seed=3, **OPT)
            mp.setattr(TO, "_stagewise_plans", lambda *a, **k: [
                TC.ExecutionPlan(x=p.x, y=p.y, meta=p.meta)
                for p in stagewise])
            mp.setattr(TO, "_solve_pipeline_batch", _recorder(port))
            with pytest.raises(_Stop):
                TC.optimize_pipeline(make_spec(TC, name), "end_to_end",
                                     barriers=GGL, seed=3, device=CPU, **OPT)
            out[name] = (ref[0], port[0])
    return out


def _tensors(val):
    """The reference's (nested) jax arguments as CPU tensors."""
    if isinstance(val, (tuple, list)):
        return type(val)(_tensors(item) for item in val)
    return torch.from_numpy(np.array(val))


def _leaves(val):
    if isinstance(val, (tuple, list)):
        for item in val:
            yield from _leaves(item)
    else:
        yield val


@pytest.mark.parametrize("name", sorted(SPECS))
def test_solver_inputs_bit_identical(solver_inputs, name):
    """Every array the planner builds — the restarts' logits above all —
    equals the reference's bit for bit given the same stagewise stack,
    and so do the static arguments."""
    (rargs, rkw), (targs, tkw) = solver_inputs[name]
    assert tkw == rkw
    assert len(targs) == len(rargs) == 7
    for t, r in zip(_leaves(targs), _leaves(rargs)):
        assert t.dtype == torch.float32 and t.device.type == CPU
        r = np.asarray(r)
        assert tuple(t.shape) == r.shape
        np.testing.assert_array_equal(t.numpy(), r)
    assert tuple(targs[4].shape) == (6, 3) + tuple(targs[3][0].shape)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_solve_pipeline_batch_follows_reference(solver_inputs, name):
    """25 steps from the reference's logits: x, y at atol 1e-4, the exact
    pipeline span at rtol 1e-4."""
    (rargs, rkw), _ = solver_inputs[name]
    kw = dict(rkw, steps=25)
    want = RO._solve_pipeline_batch(*rargs, **kw)
    got = TO._solve_pipeline_batch(*_tensors(rargs), **kw)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


#: the 3-stage word-count chain of chip_smoke.py phase 13a: 40 MB at each
#: of the 8 PlanetLab sources, and the alphas and out_scales its probe run
#: measures on the 20M-word corpus
CHAIN_13A = dict(D=40.0, alphas=(0.0177065, 0.00744068, 0.10618729),
                 out_scales=(0.47211194, 0.96141479, 0.74803150))


def test_float32_anneal_at_the_chip_paths_inputs_misses_the_bar():
    """At the inputs the ``end_to_end`` planner builds for phase 13a's
    chain (24 restarts, the stagewise stack priced at ~4 s as the
    temperature unit), the reference's own float32 25-step trajectory is
    further than the solver bar (1e-4) from the same anneal in float64, so
    no float32 solve can be held to another at that bar there: phase 13c
    holds the card's float64 trajectory to the CPU's and prints the
    float32 ones."""
    sub = TC.Substrate.of(TC.planetlab_platform(8, alpha=1.0, seed=0))
    a = CHAIN_13A["alphas"]
    spec = TC.chain_spec(
        [sub.view(np.full(sub.nS, CHAIN_13A["D"]), a[0])]
        + [sub.view(np.zeros(sub.nS), alpha) for alpha in a[1:]],
        out_scales=list(CHAIN_13A["out_scales"]))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "_solve_pipeline_batch", _recorder(seen))
        with pytest.raises(_Stop):
            TC.optimize_pipeline(spec, "end_to_end", barriers=GGL,
                                 n_restarts=24, steps=500, device=CPU)
    (args, kwargs), = seen
    kw = dict(kwargs, steps=25)
    f64 = [tuple(t.double() for t in a) if isinstance(a, tuple) else a.double()
           for a in args]
    exact = TO._solve_pipeline_batch(*f64, **kw)[0].numpy()
    ref = RO._solve_pipeline_batch(
        *[tuple(jnp.asarray(t.numpy()) for t in a) if isinstance(a, tuple)
          else jnp.asarray(a.numpy()) for a in args], **kw)[0]
    assert np.abs(np.asarray(ref) - exact).max() > 1e-4


@pytest.fixture(scope="module")
def optimized():
    out = {}
    for name in SPECS:
        for mode in ("stagewise", "end_to_end"):
            out[name, mode] = (
                RC.optimize_pipeline(make_spec(RC, name), mode, barriers=GGL,
                                     **OPT),
                TC.optimize_pipeline(make_spec(TC, name), mode, barriers=GGL,
                                     device=CPU, **OPT),
            )
    return out


#: (spec, mode) pairs held to 1e-3; the diamond's end_to_end solve is
#: not (see the next test)
MATCHED = [(name, mode) for name in sorted(SPECS)
           for mode in ("stagewise", "end_to_end")
           if (name, mode) != ("diamond", "end_to_end")]


@pytest.mark.parametrize("name,mode", MATCHED,
                         ids=[f"{n}-{m}" for n, m in MATCHED])
def test_optimize_pipeline_matches_reference(optimized, name, mode):
    """End-to-end and per-stage makespans within 1e-3 relative; every
    plan validates."""
    ref, port = optimized[name, mode]
    assert (port.mode, port.stage_mode, port.barriers) == (
        ref.mode, ref.stage_mode, ref.barriers)
    assert port.makespan == pytest.approx(ref.makespan, rel=1e-3)
    assert port.objective == port.makespan
    for p, r in zip(port.results, ref.results):
        assert p.makespan == pytest.approx(r.makespan, rel=1e-3)
        assert p.mode == r.mode == f"{mode}:e2e_multi"
        validate_plan(p.plan.x, p.plan.y)
    for t, f in zip(port.starts + port.finishes, ref.starts + ref.finishes):
        assert t == pytest.approx(f, rel=1e-3, abs=1e-9)


def test_diamond_end_to_end_is_sensitive_to_rounding_in_the_reference(
        solver_inputs, optimized):
    """On the diamond, the reference's own 150-step anneal moves its
    stagewise-started restart by more than the 1e-3 bar when the logits
    move by 1e-6: float32 rounding in another op order decides the
    winner there, for the port as for the reference.  The port's
    ``end_to_end`` plan is held to be no worse than the reference's by
    more than 1e-3, and valid."""
    (rargs, rkw), _ = solver_inputs["diamond"]
    spans = np.asarray(RO._solve_pipeline_batch(*rargs, **rkw)[2])
    noise = np.random.default_rng(0).normal(size=rargs[4].shape)
    moved = list(rargs)
    moved[4] = jnp.asarray(np.asarray(rargs[4]) + 1e-6 * noise, jnp.float32)
    spans_moved = np.asarray(RO._solve_pipeline_batch(*moved, **rkw)[2])
    assert abs(spans_moved[0] / spans[0] - 1.0) > 1e-3
    ref, port = optimized["diamond", "end_to_end"]
    assert port.makespan <= ref.makespan * (1 + 1e-3)
    for res in port.results:
        validate_plan(res.plan.x, res.plan.y)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_end_to_end_never_modeled_worse_than_stagewise(optimized, name):
    for side in (0, 1):
        sw = optimized[name, "stagewise"][side]
        e2e = optimized[name, "end_to_end"][side]
        assert e2e.makespan <= sw.makespan + 1e-9


# ---------------------------------------------------------------------------
# the GeoPipeline facade
# ---------------------------------------------------------------------------

def chain_stages(A, C, **kw):
    return [A.GeoJob(v, **kw) for v in chain_views(C)]


@pytest.fixture(scope="module")
def facade():
    """The chain planned end_to_end and simulated; the same plans adopted
    again through with_plans(); reference and port."""
    out = {}
    for side, (A, C) in SIDES.items():
        kw = {"device": CPU} if side == "port" else {}
        stages = chain_stages(A, C, **kw)
        pipe = A.GeoPipeline(stages, name="chain", **kw).plan(
            "end_to_end", barriers=GGL, **OPT)
        report = pipe.simulate()
        replay = A.GeoPipeline(
            [A.GeoJob(job.platform, **kw).with_plan(job.planned.plan, GGL)
             for job in stages], name="chain", **kw).with_plans()
        out[side] = (stages, pipe, report, replay.simulate())
    return out


def test_geopipeline_adopts_plans_and_derived_views(facade):
    stages, pipe, report, _ = facade["port"]
    for k, job in enumerate(stages):
        assert job.planned is pipe.planned.results[k]
        assert job.planned.plan is report.plans[k]
        assert job.device == CPU  # _adopt keeps each stage job's device
        np.testing.assert_array_equal(job.platform.D, pipe.planned.stage_D[k])
    assert stages[1].platform.D.sum() == pytest.approx(6000.0)
    assert stages[2].platform.D.sum() == pytest.approx(6000.0)
    assert "GeoPipeline(chain: 3 stages" in repr(pipe)
    with pytest.raises(RuntimeError, match="no plan"):
        TA.GeoPipeline(chain_stages(TA, TC, device=CPU)).planned
    with pytest.raises(ValueError, match="out_scale"):
        TA.GeoPipeline(chain_stages(TA, TC), out_scales=[1.0])
    with pytest.raises(ValueError, match="cycle"):
        TA.GeoPipeline(chain_stages(TA, TC), edges=[(0, 1), (1, 0)])


def test_geopipeline_reports_match_reference(facade):
    """as_dict() round-trips through JSON; modeled and simulated
    makespans within 1e-3 of the reference's; with_plans() re-prices the
    adopted plans to the planned makespan."""
    _, _, rrep, rreplay = facade["ref"]
    _, pipe, trep, treplay = facade["port"]
    for got, want in ((trep, rrep), (treplay, rreplay)):
        doc = got.as_dict()
        assert json.loads(json.dumps(doc)) == doc
        wdoc = want.as_dict()
        assert doc.keys() == wdoc.keys()
        assert doc["mode"] == wdoc["mode"]
        assert doc["makespan"] == pytest.approx(wdoc["makespan"], rel=1e-3)
        assert doc["simulated"]["makespan"] == pytest.approx(
            wdoc["simulated"]["makespan"], rel=1e-3)
        assert len(doc["stages"]) == 3
    assert treplay.result.mode == "external"
    assert treplay.makespan_modeled == pytest.approx(trep.makespan_modeled,
                                                     rel=1e-12)
    assert "pipeline[end_to_end/GGL] 3 stages" in trep.summary()


def _chain_sources(C, A, p):
    keys, vals = r_apps.generate_documents(200, 30, seed=7)
    return A.split_sources(keys, vals, p.nS)


def test_execute_word_count_chain_matches_reference():
    """A 2-stage word-count chain (stage 2 counts stage 1's counts) under
    the reference's stagewise plans: every reducer's output equal, the
    measured makespan within 1e-3."""
    reports = {}
    plans = None
    for side, (A, C) in SIDES.items():
        p = C.planetlab_platform(4, alpha=1.0, seed=0)
        sub = C.Substrate.of(p)
        kw = {"device": CPU} if side == "port" else {}
        app = (t_apps.word_count(device=CPU) if side == "port"
               else r_apps.word_count())
        stages = [A.GeoJob(sub.view(p.D, 1.0), app, **kw),
                  A.GeoJob(sub.view(np.zeros(p.nS), 1.0), app, **kw)]
        pipe = A.GeoPipeline(stages, name="wc", **kw)
        if plans is None:
            pipe.plan("stagewise", barriers=GGL, **OPT)
            plans = pipe.planned.plans
        else:
            for job, plan in zip(stages, plans):
                job.with_plan(C.ExecutionPlan(x=plan.x, y=plan.y), GGL)
            pipe.with_plans()
        reports[side] = pipe.execute(_chain_sources(C, A, p))
    want, got = reports["ref"], reports["port"]
    assert len(got.jobs) == 2
    assert got.jobs[1].stats.volumes_mb()[0].sum() > 0
    for gjob, wjob in zip(got.jobs, want.jobs):
        assert len(gjob.outputs) == len(wjob.outputs)
        for (gk, gv), (wk, wv) in zip(gjob.outputs, wjob.outputs):
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)
    assert got.makespan_measured == pytest.approx(want.makespan_measured,
                                                  rel=1e-3)
    doc = json.loads(json.dumps(got.as_dict()))
    assert doc["measured"]["makespan"] == pytest.approx(got.makespan_measured)


# ---------------------------------------------------------------------------
# a pipeline inside GeoSchedule
# ---------------------------------------------------------------------------

#: both shuffle links into the pipeline's reducer r1 step down 250x at
#: t = 30 s, while its second stage has not been released yet
DRIFT = {f"shuffle[m{m}->r1]": (200.0, 0.8, 30.0) for m in (0, 1)}


def pipeline_schedule(A, C, traced=False, **kw):
    traces = ({name: C.CapacityTrace.step(*args)
               for name, args in DRIFT.items()} if traced else None)
    sub = chain_substrate(C, traces)
    pipe = A.GeoPipeline([
        A.GeoJob(sub.view(np.array([0.0, 4000.0]), 1.0, name="ingest"), **kw),
        A.GeoJob(sub.view(np.zeros(2), 1.0, name="transform"), **kw),
    ], name="p", **kw)
    plain = A.GeoJob(sub.view(np.array([0.0, 1000.0]), 1.0, name="q"), **kw)
    return A.GeoSchedule([pipe, plain], **kw)


@pytest.fixture(scope="module")
def scheduled():
    out = {}
    for side, (A, C) in SIDES.items():
        kw = {"device": CPU} if side == "port" else {}
        for policy in ("independent", "joint"):
            sched = pipeline_schedule(A, C, **kw).plan(
                policy, barriers=GGL, pipeline_mode="end_to_end", **OPT)
            out[side, policy] = (sched, sched.simulate())
    return out


@pytest.mark.parametrize("policy", ["independent", "joint"])
def test_schedule_with_pipeline_matches_reference(scheduled, policy):
    """The flat stack (two stages + the plain job) priced under shared
    capacity and simulated with the stage link: modeled and simulated
    makespans within 1e-3 of the reference's."""
    rsched, rrep = scheduled["ref", policy]
    tsched, trep = scheduled["port", policy]
    assert len(tsched.jobs) == 3 and len(tsched.members) == 2
    assert tsched._links == rsched._links == {1: [(0, 1.0)]}
    assert trep.policy == rrep.policy == policy
    assert trep.makespan_modeled == pytest.approx(rrep.makespan_modeled,
                                                  rel=1e-3)
    assert trep.makespan_sim == pytest.approx(rrep.makespan_sim, rel=1e-3)
    # the pipeline's second stage cannot finish before its first
    assert trep.sims[1].reduce_end >= trep.sims[0].reduce_end
    for job, res in zip(tsched.jobs, tsched.planned.results):
        assert job.planned is res
        validate_plan(res.plan.x, res.plan.y)
    with pytest.raises(RuntimeError, match="GeoPipeline.execute"):
        tsched.execute([[], [], []])


def test_schedule_members_must_be_jobs_or_pipelines():
    sub = chain_substrate(TC)
    with pytest.raises(TypeError, match="GeoJob or GeoPipeline"):
        TA.GeoSchedule([TA.GeoJob(sub.view(np.ones(2), 1.0)), object()])


def test_run_online_static_equals_the_frozen_pipeline_schedule(scheduled):
    sched, _ = scheduled["port", "joint"]
    cfg = TC.SimConfig(barriers=GGL)
    frozen = sched.simulate(cfg)
    rep = sched.run_online(policy="static", cfg=cfg)
    assert rep.makespan_online == pytest.approx(frozen.makespan_sim, abs=1e-9)
    assert rep.makespan_static == pytest.approx(frozen.makespan_sim, abs=1e-9)
    assert rep.decisions == ()


def test_run_online_reactive_steers_the_unreleased_stage():
    """The shuffle links into r1 drift while the pipeline's second stage
    waits for its first: ``reactive`` with the charge pinned decides on
    every job, the unreleased stage included, as the reference does
    (same decision count and actions, makespans within 1e-3)."""
    reports = {}
    for side, (A, C) in SIDES.items():
        kw = {"device": CPU} if side == "port" else {}
        sched = pipeline_schedule(A, C, traced=True, **kw).plan(
            "joint", barriers=GGL, **OPT)
        online = dataclasses.replace(C.get_online_config("reactive"),
                                     solver_cost_s=0.1)
        reports[side] = sched.run_online(
            policy="reactive", cfg=C.SimConfig(barriers=GGL), online=online,
            **OPT)
    want, got = reports["ref"], reports["port"]
    assert len(got.decisions) == len(want.decisions) > 0
    assert [(d.time, d.event, d.job, d.action) for d in got.decisions] == [
        (d.time, d.event, d.job, d.action) for d in want.decisions]
    assert {d.job for d in got.decisions} >= {1}  # the waiting stage
    assert got.makespan_online == pytest.approx(want.makespan_online,
                                                rel=1e-3)
    assert got.makespan_static == pytest.approx(want.makespan_static,
                                                rel=1e-3)
    for plan in got.plans:
        validate_plan(plan.x, plan.y)
    assert np.isfinite(got.makespan_online)
