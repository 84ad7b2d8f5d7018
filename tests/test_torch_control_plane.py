"""The control plane at the reference's scale (``chip_smoke.py`` phase 23)
against the reference.

Phase 23 runs on the card the control-plane scenarios of the reference's
``benchmarks/paper_figures.py``: ``fig12_replication``,
``schedule_failover`` and ``schedule_online_shared`` (23a),
``bench_planner`` (23b) and ``bench_scale_online``'s ``online_1000``
(23c).  Its scenario builders take a package's entry points, so the same
builders run the reference here.  On the CPU:

* the builders' fabrics are the benchmark's own;
* Fig 12's three DES runs equal the reference's bit for bit;
* ``schedule_failover`` and ``schedule_online_shared`` with the charge
  pinned, at phase 23's 6 restarts x 200 steps: each frozen and online
  makespan within 1e-3 of the reference's, or where the reference's
  anneals have not settled within its own spread (its runs under
  ``run_online`` seeds 1 and 2 and with one bandwidth moved by 1e-7);
  decisions, swaps and rejections equal;
* ``online_1000``'s configuration on the 100-node tier
  (``scale_tier_substrate(seed=0)``): the incremental co-replan anneals 16
  of the live jobs at each of its three decisions, and decisions, swaps,
  rejections and makespan equal the reference's;
* ``replan_batch`` full and incremental from the same incumbents, and
  ``bench_planner``'s solver counters;
* the tables phase 23 holds the card to, as the reference computes them;
* phase 23 rehearsed end to end on the CPU at a reduced size (23a at 6 x
  100, 23b at 4 x 61 and 4 x 227, 23c on the 100-node tier of seed 1,
  where its co-replans swap), the card's name stubbed: every check runs.

Run as a script, it prints the tables phase 23 holds (``REF_FIG12``,
``REF_CONTROL``, ``REF_CONTROL_COUNTS``, ``REF_CONTROL_SPREAD``,
``REF_PLANNER_STATS``, ``REF_SCALE``, ``REF_SCALE_SPREAD``) as the
reference computes them, then the port's ``online_1000`` on the CPU and
how far float32 rounding alone moves one of its co-replans' anneals (the
reason 23c holds that anneal in float64):
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_control_plane.py``
(about 6 minutes: the reference's ``online_1000`` three times).
"""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def reference_pkg():
    """The reference's entry points, as ``chip_smoke.control_pkg`` gives
    the port's."""
    import repro.api as api
    import repro.core as core

    return types.SimpleNamespace(api=api, core=core, dev={},
                                 sync=lambda: None)


def control_runs(C, pkg, opt, seed=0, measured=False):
    return (C.control_failover(pkg, opt, C.CONTROL_CHARGE_S, seed, measured),
            C.control_online_shared(pkg, opt, C.CONTROL_CHARGE_S, seed,
                                    measured))


@contextlib.contextmanager
def nudged_fabrics(C, nudge):
    """Both 23a fabrics with the bandwidth of their first shuffle link
    (``B_mr[0, 0]``) moved by ``nudge`` relative."""
    import dataclasses

    real = {name: getattr(C, name)
            for name in ("failover_fabric", "shared_online_fabric")}

    def wrap(build):
        def nudged(*args, **kwargs):
            sub = build(*args, **kwargs)
            b_mr = np.array(sub.B_mr, dtype=float)
            b_mr[0, 0] *= 1 + nudge
            return dataclasses.replace(sub, B_mr=b_mr)
        return nudged

    for name, build in real.items():
        setattr(C, name, wrap(build))
    try:
        yield
    finally:
        for name, build in real.items():
            setattr(C, name, build)


def reference_control(C, opt, seeds=None, nudges=None):
    """The reference's 23a at ``opt``: (its held makespans, decisions,
    swaps and rejections of each pinned run, its spread where more than
    ``CONTROL_RTOL``, Fig 12's makespans).  The spread is the largest
    relative move of each makespan over ``run_online``'s other seeds and
    over the fabrics with one bandwidth nudged (``CONTROL_SPREAD_NUDGES``):
    a solve whose winner is a warm start or a heuristic restart does not
    move with the seed, but its anneal's end point moves with its inputs."""
    seeds = C.CONTROL_SPREAD_SEEDS if seeds is None else seeds
    nudges = C.CONTROL_SPREAD_NUDGES if nudges is None else nudges
    pkg = reference_pkg()
    runs = control_runs(C, pkg, opt)
    cells = {k: float(v) for k, v in C.control_cells(*runs).items()}
    counts = {"failover": C.control_counts(runs[0]),
              "online_shared": C.control_counts(runs[1])}
    others = [C.control_cells(*control_runs(C, pkg, opt, seed))
              for seed in seeds]
    for nudge in nudges:
        with nudged_fabrics(C, nudge):
            others.append(C.control_cells(*control_runs(C, pkg, opt)))
    spread = {}
    for other in others:
        for key, value in cells.items():
            spread[key] = max(spread.get(key, 0.0),
                              float(abs(other[key] / value - 1)))
    spread = {k: v for k, v in spread.items() if v > C.CONTROL_RTOL}
    fig12 = {r: float(span) for r, (span, _) in C.fig12_runs(pkg).items()}
    return cells, counts, spread, fig12


def reference_scale(C, tier, seeds=()):
    """The reference's online_1000 configuration on ``tier``: its numbers
    (run_online seed 0) and, over ``seeds`` too, the spread of its
    decisions, swaps and makespan."""
    pkg = reference_pkg()
    setup = C.scale_online_setup(pkg, tier)
    sub = setup[0]
    runs = [C.scale_numbers(*C.scale_online(pkg, setup, seed=s),
                            sub.nS + sub.nM + sub.nR) for s in (0, *seeds)]
    ref = {k: (v if isinstance(v, int) else float(v))
           for k, v in runs[0].items()
           if k not in ("wall_s", "decisions_per_s")}
    spread = {k: (min(r[k] for r in runs), max(r[k] for r in runs))
              for k in ("decisions", "swaps")}
    spread["makespan"] = float(max(abs(r["makespan"] / ref["makespan"] - 1)
                                   for r in runs))
    return ref, spread


def print_tables():
    """The tables phase 23 holds, as the reference computes them; then the
    port's online_1000 on the CPU and the float32 witness of 23c."""
    import torch

    C = _chip_smoke()
    cells, counts, spread, fig12 = reference_control(C, C.CONTROL_OPT)
    stats = C.planner_service(reference_pkg())["stats"]
    scale, scale_spread = reference_scale(C, C.SCALE_TIER,
                                          C.CONTROL_SPREAD_SEEDS)
    print(f"REF_FIG12 = {fig12!r}")
    for name, table in (("REF_CONTROL", cells),
                        ("REF_CONTROL_COUNTS", counts),
                        ("REF_CONTROL_SPREAD", spread),
                        ("REF_SCALE", scale),
                        ("REF_SCALE_SPREAD", scale_spread)):
        print(f"{name} = {{")
        for key, value in table.items():
            print(f"    {key!r}: {value!r},")
        print("}")
    print(f"REF_PLANNER_STATS = {stats!r}")

    from repro_torch.core import optimize as O

    real = O._solve_residual_shared_batch
    held = []

    def recording(*args, **kwargs):
        if not held:
            held.append((args, kwargs))
        return real(*args, **kwargs)

    O._solve_residual_shared_batch = recording
    try:
        pkg = C.control_pkg(torch.device("cpu"))
        setup = C.scale_online_setup(pkg)
        report, wall = C.scale_online(pkg, setup)
    finally:
        O._solve_residual_shared_batch = real
    print(f"# the port's online_1000 on the CPU: "
          f"{C.scale_numbers(report, wall, 996)!r}")
    args, kwargs = held[0]
    base = real(*args, **kwargs)
    f64 = real(*[tuple(t.double() for t in a) if isinstance(a, tuple)
                 else a.double() for a in args], **kwargs)
    lx = args[4]
    up = torch.rand(lx.shape, generator=torch.Generator().manual_seed(0)) < 0.5
    nudged = list(args)
    nudged[4] = torch.nextafter(lx, torch.where(up, torch.inf, -torch.inf))
    moved = real(*nudged, **kwargs)
    print(f"# its first co-replan's anneal, logits {tuple(lx.shape)}, "
          f"{kwargs['steps']} steps, on the CPU: max |x - x'| with each logit "
          f"moved one ulp {float((moved[0] - base[0]).abs().max())!r}; "
          f"float32 against float64 "
          f"{float((base[0].double() - f64[0]).abs().max())!r}")


torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro_torch  # noqa: E402

CPU = torch.device("cpu")
#: the rehearsal's 23a at a reduced budget, held to the reference's
#: spread there (online_shared's makespans move by 1-5% over run_online
#: seeds and nudged fabrics at 100 steps; the held runs below take phase
#: 23's own 6 x 200)
SMALL_OPT = dict(n_restarts=6, steps=100)
#: the 100-node tier: the reference bench's own (seed 0) and the one the
#: rehearsal runs (seed 1, where the co-replans swap and the margin is
#: positive)
TIER = dict(seed=0)
REHEARSAL_TIER = dict(seed=1)
#: bench_planner's sequence at step counts no other test uses (the
#: incremental replans at 4 x 27 and 4 x 28), so that each package's first
#: call of a key is its compile
PLANNER = (dict(n_restarts=4, steps=59), dict(n_restarts=4, steps=219))
REHEARSAL_PLANNER = (dict(n_restarts=4, steps=61), dict(n_restarts=4,
                                                         steps=227))


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
def C():
    return _chip_smoke()


@pytest.fixture(scope="module")
def full_ref(C):
    """The reference's 23a at phase 23's budget."""
    return reference_control(C, C.CONTROL_OPT)


@pytest.fixture(scope="module")
def full_port(C):
    """The port's pinned 23a runs at phase 23's budget."""
    return control_runs(C, C.control_pkg(CPU), C.CONTROL_OPT)


@pytest.mark.parametrize("fabric", ["failover", "failover with its faults",
                                    "online_shared"])
def test_fabrics_are_the_benchmarks(C, fabric):
    """The builders make the benchmark's substrates: capacities, clusters,
    traces and faults."""
    import repro.core as RC
    from benchmarks import paper_figures as F

    if fabric == "online_shared":
        got, want = C.shared_online_fabric(RC), F.shared_online_substrate()
    elif fabric == "failover":
        got, want = C.failover_fabric(RC), F.failover_substrate()
    else:
        # schedule_failover's faults, as paper_figures.py:568 lists them
        faults = [RC.FailureEvent.reducer_kill(1, 115.0),
                  RC.FailureEvent.cluster_partition(1, 118.0, 400.0)]
        assert C.failover_faults(RC) == faults
        got = C.failover_fabric(RC, C.failover_faults(RC))
        want = F.failover_substrate(faults)
    for name in ("B_sm", "B_mr", "C_m", "C_r", "cluster_s", "cluster_m",
                 "cluster_r"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.name == want.name
    assert got.drift_times() == want.drift_times()
    assert got.failure_times() == want.failure_times()
    for t in (0.0, 116.0, 120.0, 160.0, 200.0, 500.0):
        a, b = got.at(t), want.at(t)
        for name in ("B_sm", "B_mr", "C_m", "C_r"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_fig12_equals_the_reference_bit_for_bit(C, full_ref):
    """Fig 12's three DES runs are host numpy on byte-identical copies."""
    got = C.fig12_runs(C.control_pkg(CPU))
    want = C.fig12_runs(reference_pkg())
    assert got == want
    assert {r: span for r, (span, _) in got.items()} == full_ref[3]


@pytest.mark.parametrize("scenario", ["failover", "online_shared"])
def test_frozen_schedules_match_the_reference(C, full_ref, full_port,
                                              scenario):
    """The frozen joint plans at 6 x 200, priced by the DES under the
    scenario's faults or drift: within 1e-3 of the reference's."""
    port = full_port[0 if scenario == "failover" else 1]
    key = f"{scenario} frozen"
    assert port["frozen"] == pytest.approx(full_ref[0][key],
                                           rel=C.CONTROL_RTOL)


@pytest.mark.parametrize("scenario,name", [
    ("failover", "reactive_shared"), ("failover", "reactive_failover"),
    ("online_shared", "reactive_solo"), ("online_shared", "reactive_shared"),
    ("online_shared", "shared_no_hysteresis")])
def test_pinned_online_runs_match_the_reference(C, full_ref, full_port,
                                                scenario, name):
    """Each pinned ``run_online`` at phase 23's 6 x 200: its online and
    static makespans within phase 23a's bar of the reference's
    (``control_bar``: 1e-3, or where its anneals have not settled twice
    the reference's own spread over run_online seeds and nudged fabrics
    plus 1e-3, under 6%), its decisions,
    swaps and rejections the reference's, and phase 23a's invariants."""
    cells, counts, spread, _ = full_ref
    port = full_port[0 if scenario == "failover" else 1]
    report = port["runs"][name, "pinned"][0]
    C.check_online_run(name, report, name != "reactive_solo")
    for key, got in ((f"{scenario} {name}", report.makespan_online),
                     (f"{scenario} {name} static", report.makespan_static)):
        bar = C.control_bar(key, spread)
        assert bar < 6e-2, (key, bar)
        assert abs(got / cells[key] - 1) <= bar, (key, got, cells[key])
    assert C.control_counts(port)[name] == counts[scenario][name]


def test_online_1000_configuration_on_the_100_node_tier(C):
    """online_1000's configuration (fluid jobs, the backbone brownout, 90
    live and 10 arrivals, reactive_shared incremental at a pinned 5 s) on
    the reference bench's 100-node tier: each of its three co-replans
    anneals the 16 most-behind of more live jobs (the stack cap) in both
    packages; decisions, swaps and rejections equal, the makespan within
    1e-3."""
    from repro.core import optimize as RO
    from repro_torch.core import optimize as TO

    out = {}
    for name, pkg, O in (("ref", reference_pkg(), RO),
                         ("port", C.control_pkg(CPU), TO)):
        real = O._solve_residual_shared_batch
        shapes = []

        def recording(*args, _real=real, _shapes=shapes, **kwargs):
            _shapes.append((tuple(args[4].shape), kwargs["steps"]))
            return _real(*args, **kwargs)

        O._solve_residual_shared_batch = recording
        try:
            setup = C.scale_online_setup(pkg, TIER)
            report = C.scale_online(pkg, setup)[0]
        finally:
            O._solve_residual_shared_batch = real
        live = len(setup[1])
        assert live == C.SCALE_LIVE > O._INCREMENTAL_STACK_CAP == 16
        assert shapes == [((4, 16, setup[0].nS, setup[0].nM), 8)] * 3, shapes
        out[name] = report
    got, want = out["port"], out["ref"]
    C.check_online_run("the 100-node tier", got, True)
    assert [(d.time, d.event, d.job, d.action) for d in got.decisions] == \
        [(d.time, d.event, d.job, d.action) for d in want.decisions]
    assert (len(got.swaps), len(got.rejected)) == (len(want.swaps),
                                                   len(want.rejected))
    assert got.makespan_online == pytest.approx(want.makespan_online,
                                                rel=C.CONTROL_RTOL)
    assert got.makespan_static == pytest.approx(want.makespan_static,
                                                rel=1e-12)


def test_control_tables_are_the_references(C, full_ref):
    """``REF_FIG12``, ``REF_CONTROL``, ``REF_CONTROL_COUNTS``,
    ``REF_CONTROL_SPREAD`` (to 1e-3 of each spread) and
    ``REF_PLANNER_STATS`` as the reference computes them now at phase 23's
    settings; ``REF_SCALE``'s budget is the one ``_shared_incremental_
    budget`` gives at both the quick and the full budgets.  It runs before
    ``test_replan_batch_matches_the_reference``, whose reference batch at
    ``PLANNER_OPT`` would make one of the service's keys seen already."""
    from repro.core import optimize as RO

    cells, counts, spread, fig12 = full_ref
    assert C.REF_FIG12 == fig12
    assert set(C.REF_CONTROL) == set(cells)
    for key, value in cells.items():
        assert C.REF_CONTROL[key] == pytest.approx(value, rel=1e-6), key
    assert C.REF_CONTROL_COUNTS == counts
    assert set(C.REF_CONTROL_SPREAD) == set(spread)
    for key, value in spread.items():
        assert C.REF_CONTROL_SPREAD[key] == pytest.approx(value, rel=1e-3)
    assert C.REF_PLANNER_STATS == C.planner_service(reference_pkg())["stats"]
    # online_1000's 90-odd live jobs: 4 restarts x 8 steps at the quick
    # budget and at the figures' 16 x 400 alike
    for opt in (C.CONTROL_OPT, dict(n_restarts=16, steps=400)):
        assert RO._shared_incremental_budget(
            opt["n_restarts"], opt["steps"], C.SCALE_LIVE) == (4, 8)
    assert C.REF_SCALE["n_nodes"] == 996


def test_a_spread_alone_does_not_cover_the_reference_itself(C, full_ref):
    """Why ``control_bar`` widens the spread: the reference's own
    reactive_solo at run_online seed 3, another sample of the chaos its
    spread measures (seeds 1 and 2, one bandwidth nudged by +-1e-7), lands
    outside that spread of its seed-0 run, and inside ``control_bar``'s
    twice the spread plus 1e-3 (the card's first run landed 1.84e-3 off,
    against a spread of 1.31e-3)."""
    cells, _, spread, _ = full_ref
    key = "online_shared reactive_solo"
    out = C.control_online_shared(reference_pkg(), C.CONTROL_OPT,
                                  C.CONTROL_CHARGE_S, 3, False)
    other = out["runs"]["reactive_solo", "pinned"][0].makespan_online
    rel = abs(other / cells[key] - 1)
    assert spread[key] < rel <= C.control_bar(key, spread), (rel, spread)


@pytest.mark.parametrize("incremental", [False, True])
def test_replan_batch_matches_the_reference(C, incremental):
    """bench_planner's replans: the 8 seeded views from the same
    incumbents (the reference's B = 8 plans at 6 x 203), at 6 x 75 (the
    full anneal settles where its incumbent does not win: at 6 x 50 one
    request's winner flips between the packages, at 6 x 500 several end
    up to 6e-3 apart, float32 rounding choosing each end point); the
    incremental polish at its 4 x 25 floor.  Each package keeps an
    incumbent exactly where the other does, makespans within 1e-3, none
    worse than its incumbent."""
    import repro.core as RC
    import repro_torch.core as TC

    seeds = list(range(10, 18))
    views = {pkg: [P.planetlab_platform(8, alpha=1.0, seed=s)
                   for s in range(8)] for pkg, P in (("ref", RC),
                                                     ("port", TC))}
    batch = RC.optimize_plan_batch(views["ref"], "e2e_multi", seeds=seeds,
                                   **C.PLANNER_OPT)
    incumbents = {"ref": [r.plan for r in batch],
                  "port": [TC.ExecutionPlan(x=r.plan.x, y=r.plan.y)
                           for r in batch]}
    kw = dict(seeds=seeds, incremental=incremental, n_restarts=6, steps=75)
    want = RC.replan_batch(views["ref"], incumbents["ref"], **kw)
    got = TC.replan_batch(views["port"], incumbents["port"], device=CPU,
                          **kw)
    for g, w, gi, wi, b in zip(got, want, incumbents["port"],
                               incumbents["ref"], batch):
        assert (g.plan is gi) == (w.plan is wi)
        assert g.makespan == pytest.approx(w.makespan, rel=1e-3)
        assert g.makespan <= b.makespan + 1e-9


def test_planner_service_counters_match_the_reference(C):
    """bench_planner's call sequence through each package: the same
    calls, hits, misses, compiles, entries and shapes; every plan never
    worse than uniform."""
    opt, ropt = PLANNER
    want = C.planner_service(reference_pkg(), opt, ropt, repeats=1)
    got = C.planner_service(C.control_pkg(CPU), opt, ropt, repeats=1)
    assert got["stats"] == want["stats"]
    for r in got["single"]:
        assert r.makespan <= got["uniform"]
    for r, u in zip(got["batch"], got["views_uniform"]):
        assert r.makespan <= u


@pytest.fixture
def rehearsal(C, monkeypatch):
    """chip_smoke on the CPU: the default device the CPU, the card's name
    stubbed."""
    previous = repro_torch._device.default_device()
    repro_torch.set_default_device("cpu")
    monkeypatch.setattr(C, "card_name_and_limit", lambda: "the CPU")
    yield C
    repro_torch.set_default_device(previous)


@pytest.fixture(scope="module")
def rehearsal_refs(C):
    """The reference at the rehearsal's settings: 23a's tables at 6 x 100,
    23b's counters at 4 x 61 and 4 x 227, 23c's numbers on the 100-node
    tier of seed 1."""
    opt, ropt = REHEARSAL_PLANNER
    return (reference_control(C, SMALL_OPT),
            C.planner_service(reference_pkg(), opt, ropt)["stats"],
            reference_scale(C, REHEARSAL_TIER))


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["in turn", "at once"])
def test_phase_23_rehearses_on_the_cpu(rehearsal, rehearsal_refs,
                                       concurrent):
    """Phase 23 end to end on the CPU, held to the reference at the same
    settings: 23a at 6 x 100 (both charges), 23b at 4 x 61 and 4 x 227,
    23c on the 100-node tier of seed 1; every check runs and passes, and
    no kernel launches.  In turn in this process (as ``run_phases.py 23``
    runs it), and at once, each part in a process of its own (as the whole
    script does)."""
    C = rehearsal
    (cells, counts, spread, fig12), stats, (scale, scale_spread) = \
        rehearsal_refs
    opt, ropt = REHEARSAL_PLANNER
    parts = {"23a": dict(opt=SMALL_OPT, ref=cells, spread=spread,
                         counts=counts, fig12=fig12),
             "23b": dict(opt=opt, ropt=ropt, stats=stats),
             "23c": dict(tier=REHEARSAL_TIER, ref=scale, spread=scale_spread)}
    if concurrent:
        out = C.phase_control_plane(
            CPU, started=C.start_control_parts(CPU, parts))
    else:
        out = C.phase_control_plane(CPU, a=parts["23a"], b=parts["23b"],
                                    c=parts["23c"])
    assert out["launches"] == dict.fromkeys(out["launches"], 0)
    assert len(out["launches"]) == 5
    assert set(out["23a"]["cells"]) == set(cells)
    assert set(out["23a"]["walls"]) == {
        f"{s} {n} {label}" for s, names in (
            ("failover", C.FAILOVER_POLICIES),
            ("online_shared", [v[0] for v in C.SHARED_VARIANTS]))
        for n in names for label in ("pinned", "measured")}
    assert out["23b"]["stats"] == stats
    assert out["23c"]["anneals"] == 3 and out["23c"]["swaps"] > 0
    assert out["23c"]["online_margin"] > 0
    assert all(e == 0.0 for e in out["23c"]["held_errs"])


if __name__ == "__main__":
    print_tables()
