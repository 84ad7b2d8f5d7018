"""The paper's evaluation (``chip_smoke.py`` phase 22) against the reference.

Phase 22 runs on the card what ``benchmarks/paper_figures.py`` runs on the
reference: every planner mode under all-global barriers over the 13
PlanetLab platforms (Figs 5, 6, 8), ``e2e_multi`` with one barrier at a
time relaxed (Fig 7), the model against the discrete-event simulator
(Fig 4), the three applications executed (Fig 9) and the dynamic
mechanisms under a straggler (Fig 10).  Here, on the CPU:

* ``PAPER_REF``, the reference's modeled makespan of every cell phase 22
  holds, recomputed from the reference at the figures' 16 restarts x 400
  steps; ``REF_FIG4`` and ``REF_FIG10``, the reference's DES numbers;
* the port's ``optimize_plan_batch`` over the 13 platforms against the
  reference's sequential ``optimize_plan`` in every mode, at 6 x 25;
* the two applications phase 22 adds, their outputs held to the plain
  numpy versions phase 22 holds them to, and the reference's outputs;
* phase 22 rehearsed at 6 x 25 steps on corpora of about 200k records, the
  card's clocks stubbed and ``segment_sum`` replaced by a counting plain
  version: every check runs.

Run as a script, it prints the tables phase 22 holds (``PAPER_REF``,
``PAPER_BAND``, ``REF_FIG4``, ``REF_FIG10``) as the reference computes them:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper_figures.py``
(a few minutes: ``PAPER_BAND`` takes the reference's plans at 21 step
counts).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BAND_STEPS = range(390, 411)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def reference_cells(C, n_restarts, steps, apps_D, with_des=True):
    """The reference's makespan of every cell phase 22 holds, keyed as
    ``chip_smoke.paper_key`` keys them, as ``benchmarks/paper_figures.py``
    computes each (sequential ``optimize_plan``, seed 0); with the plans,
    and, where ``with_des``, its Fig 4 fit and Fig 10 runs.  ``apps_D``
    maps each application to its calibrated platform's (MB a source,
    alpha)."""
    from repro.core.makespan import BARRIERS_GGL, makespan
    from repro.core.optimize import optimize_plan
    from repro.core.plan import local_push_plan, uniform_plan
    from repro.core.platform import planetlab_platform
    from repro.core.simulate import SimConfig, simulate

    opt = dict(n_restarts=n_restarts, steps=steps)
    cells, plans = {}, {}

    def solve(label, p, mode, barriers):
        key = C.paper_key(label, mode, barriers)
        r = optimize_plan(p, mode, barriers=tuple(barriers), **opt)
        cells[key], plans[key] = r.makespan, r.plan
        return r

    for n, a in C.PAPER_PLATFORMS:
        p = planetlab_platform(n, alpha=a, seed=0)
        for mode in C.PAPER_HEURISTICS + C.PAPER_MODES:
            solve(C.paper_label(n, a), p, mode, C.BARRIERS_GGG)
    for a in C.PAPER_ALPHAS:
        p = planetlab_platform(8, alpha=a, seed=0)
        for b in C.PAPER_RELAXED:
            solve(C.paper_label(8, a), p, "e2e_multi", b)
    fig4 = []
    for a in C.PAPER_FIG4_ALPHAS:
        p = planetlab_platform(8, alpha=a, seed=0)
        label = C.paper_label(8, a)
        opt_plan = plans[C.paper_key(label, "e2e_multi", C.BARRIERS_GGG)]
        for name, plan in (("uniform", uniform_plan(p)),
                           ("e2e_multi@GGG", opt_plan)):
            for b in C.PAPER_FIG4_BARRIERS:
                modeled = makespan(p, plan, tuple(b))
                cells[C.paper_key(label, name, b)] = modeled
                if with_des:
                    fig4.append((modeled, simulate(p, plan, SimConfig(
                        barriers=b, chunk_mb=C.PAPER_CHUNK_MB)).makespan))
    base = planetlab_platform(8, alpha=1.0, seed=0)
    for app, (d, alpha) in apps_D.items():
        p = dataclasses.replace(base, D=np.full(base.nS, d), alpha=alpha)
        solve(C.paper_app_label(app, d), p, "e2e_multi", BARRIERS_GGL)
    fig10 = solve(C.paper_label(8, 1.0), base, "e2e_multi", BARRIERS_GGL)
    out = {"cells": cells, "plans": plans}
    if with_des:
        preds, meas = np.array(fig4).T
        slope = np.polyfit(preds, meas, 1)[0]
        out["fig4"] = {"r2": float(np.corrcoef(preds, meas)[0, 1] ** 2),
                       "slope": float(slope)}
        out["fig10"] = {
            name: {dyn: float(simulate(base, plan, SimConfig(
                barriers=BARRIERS_GGL, stragglers=C.PAPER_STRAGGLERS,
                **flags)).makespan)
                for dyn, flags in C.PAPER_DYNAMICS.items()}
            for name, plan in (("optimized", fig10.plan),
                               ("hadoop_baseline", local_push_plan(base)))}
    return out


def _band_cells(steps):
    C = _chip_smoke()
    return reference_cells(C, C.PAPER_OPT["n_restarts"], steps,
                           C.PAPER_APPS_D, with_des=False)["cells"]


def _port_band_cells(steps):
    """The port's CPU makespans of 22a's and 22b's solver cells at
    ``steps``, one batched call a (mode, barriers) pair, as phase 22 runs
    them."""
    import torch
    from repro_torch.core import optimize_plan_batch, planetlab_platform

    torch.set_num_threads(1)
    C = _chip_smoke()
    groups = [(mode, C.BARRIERS_GGG, C.PAPER_PLATFORMS)
              for mode in C.PAPER_MODES]
    groups += [("e2e_multi", b, [(8, a) for a in C.PAPER_ALPHAS])
               for b in C.PAPER_RELAXED]
    out = {}
    for mode, b, cells in groups:
        planned = optimize_plan_batch(
            [planetlab_platform(n, alpha=a, seed=0) for n, a in cells], mode,
            barriers=b, seeds=[0] * len(cells), device="cpu",
            n_restarts=C.PAPER_OPT["n_restarts"], steps=steps)
        for (n, a), r in zip(cells, planned):
            out[C.paper_key(C.paper_label(n, a), mode, b)] = r.makespan
    return out


def print_tables():
    """Print PAPER_REF, PAPER_BAND, REF_FIG4 and REF_FIG10 as the reference
    gives them at the figures' settings (the band: its plans at 390-410
    steps, one process a step count), and how many of the port's CPU plans
    at those step counts fall outside the reference's at 396-404 widened
    by PAPER_RTOL, and outside ``paper_bar``."""
    from multiprocessing import get_context

    C = _chip_smoke()
    opt = C.PAPER_OPT
    ref = reference_cells(C, opt["n_restarts"], opt["steps"], C.PAPER_APPS_D)
    with get_context("spawn").Pool(8) as pool:
        runs = pool.map(_band_cells, list(BAND_STEPS))
        port_runs = pool.map(_port_band_cells, list(BAND_STEPS))
    band = {}
    for key, v in ref["cells"].items():
        vals = [r[key] for r in runs]
        if max(vals) - min(vals) > C.PAPER_RTOL * v:
            band[key] = (min(vals), max(vals))
    near = [r for s, r in zip(BAND_STEPS, runs) if 396 <= s <= 404]
    draws = narrow = wide = 0
    for port in port_runs:
        for key, v in port.items():
            vals = [r[key] for r in near]
            draws += 1
            narrow += not (min(vals) * (1 - C.PAPER_RTOL) <= v
                           <= max(vals) * (1 + C.PAPER_RTOL))
            lo, hi = C.paper_bar(key, ref["cells"], band)
            wide += not lo <= v <= hi
    print(f"# the port's CPU plans at {BAND_STEPS.start}-{BAND_STEPS.stop - 1}"
          f" steps: {narrow} of {draws} outside the reference's plans at "
          f"396-404 steps widened by PAPER_RTOL, {wide} outside paper_bar")
    print("PAPER_REF = {")
    for key, v in ref["cells"].items():
        print(f"    {key!r}: {v!r},")
    print("}")
    print("PAPER_BAND = {")
    for key, (lo, hi) in band.items():
        print(f"    {key!r}: ({lo!r}, {hi!r}),")
    print("}")
    print(f"REF_FIG4 = {ref['fig4']!r}")
    print("REF_FIG10 = {")
    for name, row in ref["fig10"].items():
        print(f"    {name!r}: {{")
        for dyn, v in row.items():
            print(f"        {dyn!r}: {v!r},")
        print("    },")
    print("}")


torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro.core.plan import uniform_plan as r_uniform  # noqa: E402
from repro.core.platform import planetlab_platform as r_planetlab  # noqa: E402
from repro.mapreduce import apps as rapps  # noqa: E402
from repro.mapreduce.engine import GeoMapReduce as RGeoMapReduce  # noqa: E402
from repro_torch.core import optimize_plan_batch, planetlab_platform  # noqa: E402
from repro_torch.kernels import ops, ref as kref  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_sum  # noqa: E402

CPU = torch.device("cpu")
#: the rehearsal's solves and corpora: 6 x 25 steps, about 200k records
SMALL_OPT = dict(n_restarts=6, steps=25)
SMALL_LOGS, SMALL_DOCS, SMALL_WORDS = 200_000, 200, 1_000
SMALL_APPS_D = {"sessionization": (SMALL_LOGS / 8 * 16 / 1e6, 1.0),
                "inverted_index": (SMALL_DOCS * SMALL_WORDS / 8 * 8 / 1e6, 2.0)}


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
def small_ref(C):
    """The reference at the rehearsal's 6 x 25, its apps' platforms at the
    rehearsal's corpus sizes."""
    return reference_cells(C, SMALL_OPT["n_restarts"], SMALL_OPT["steps"],
                           SMALL_APPS_D, with_des=False)


def test_paper_ref_is_the_reference(C):
    """PAPER_REF, REF_FIG4 and REF_FIG10 as the reference computes them
    now, at rtol 1e-4; each band holds its cell's value and spreads more
    than PAPER_RTOL."""
    opt = C.PAPER_OPT
    ref = reference_cells(C, opt["n_restarts"], opt["steps"], C.PAPER_APPS_D)
    assert list(ref["cells"]) == list(C.PAPER_REF)
    for key, want in C.PAPER_REF.items():
        assert ref["cells"][key] == pytest.approx(want, rel=1e-4), key
    for key, (lo, hi) in C.PAPER_BAND.items():
        assert lo <= C.PAPER_REF[key] <= hi and hi - lo > C.PAPER_RTOL * lo
    # the reference's orderings, which phase 22 holds the card to where the
    # reference holds them, hold in every cell
    cells, dom = C.PAPER_REF, C.PAPER_DOMINANCE
    for n, a in C.PAPER_PLATFORMS:
        label = C.paper_label(n, a)
        multi = cells[C.paper_key(label, "e2e_multi", C.BARRIERS_GGG)]
        for mode in C.PAPER_HEURISTICS + C.PAPER_MODES:
            assert multi <= dom * cells[C.paper_key(label, mode,
                                                    C.BARRIERS_GGG)]
    for a in C.PAPER_ALPHAS:
        label = C.paper_label(8, a)
        glob = cells[C.paper_key(label, "e2e_multi", C.BARRIERS_GGG)]
        for b in C.PAPER_RELAXED:
            assert cells[C.paper_key(label, "e2e_multi", b)] <= dom * glob
    assert ref["fig4"] == pytest.approx(C.REF_FIG4, rel=1e-4)
    for name, row in C.REF_FIG10.items():
        assert ref["fig10"][name] == pytest.approx(row, rel=1e-4), name


def _port_cells(C, mode, barriers, cells):
    return optimize_plan_batch(
        [planetlab_platform(n, alpha=a, seed=0) for n, a in cells], mode,
        barriers=barriers, seeds=[0] * len(cells), device=CPU, **SMALL_OPT)


@pytest.mark.parametrize("mode,barriers", [
    ("uniform", "GGG"), ("local_push", "GGG"), ("myopic_multi", "GGG"),
    ("e2e_push", "GGG"), ("e2e_shuffle", "GGG"), ("e2e_multi", "GGG"),
    ("e2e_multi", "PGG"), ("e2e_multi", "GPG"), ("e2e_multi", "GGP"),
    ("e2e_multi", "PPP")])
def test_batch_over_the_platforms_matches_the_reference(C, small_ref, mode,
                                                         barriers):
    """The port's one batched call over phase 22's platforms (22a: all 13;
    22b: the three 8-site ones) at 6 x 25: against the port's sequential
    ``optimize_plan`` of each at the batch test's bar (plans at atol 1e-6,
    makespans at rtol 1e-4; tests/test_torch_optimize.py), and against the
    reference's at the solver's bar (plans at atol 1e-4, makespans at rtol
    1e-4: jax and torch sum in other orders)."""
    from repro_torch.core import optimize_plan

    cells = C.PAPER_PLATFORMS if barriers == "GGG" else \
        [(8, a) for a in C.PAPER_ALPHAS]
    got = _port_cells(C, mode, tuple(barriers), cells)
    for (n, a), r in zip(cells, got):
        key = C.paper_key(C.paper_label(n, a), mode, barriers)
        solo = optimize_plan(planetlab_platform(n, alpha=a, seed=0), mode,
                             barriers=tuple(barriers), device=CPU,
                             **SMALL_OPT)
        np.testing.assert_allclose(r.plan.x, solo.plan.x, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(r.plan.y, solo.plan.y, atol=1e-6,
                                   err_msg=key)
        assert r.makespan == pytest.approx(solo.makespan, rel=1e-4), key
        want = small_ref["plans"][key]
        np.testing.assert_allclose(r.plan.x, want.x, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(r.plan.y, want.y, atol=1e-4, err_msg=key)
        assert r.makespan == pytest.approx(small_ref["cells"][key], rel=1e-4)
        assert r.mode == mode and r.barriers == tuple(barriers)


@pytest.mark.parametrize("kind,opt_x,opt_y", [
    ("push", True, False), ("e2e", True, False), ("e2e", False, True),
    ("e2e", True, True)], ids=["push", "e2e_push", "e2e_shuffle",
                               "e2e_multi"])
def test_25_steps_over_the_platforms_follow_the_reference(C, kind, opt_x,
                                                          opt_y):
    """22a's solver inputs (the 13 platforms, 16 restarts, seed 0) through
    25 steps of both packages' ``_solve_batch_many`` on the CPU: every
    request of more than one site at the bar phase 22 holds the card to
    (x, y atol 1e-4, the exact objective rtol 1e-4); the one-site requests,
    whose objective is flat in the plan (8 identical nodes), at rounding's
    mercy: their exact objective within 1e-3, their distance printed
    (phase 22 prints the card's, unchecked)."""
    import jax.numpy as jnp
    from repro.core import optimize as RO
    from repro_torch.core import optimize as TO

    ps = [r_planetlab(n, alpha=a, seed=0) for n, a in C.PAPER_PLATFORMS]
    raw = [p.as_arrays() for p in ps]
    arrs = [np.stack([np.asarray(r[i], np.float64) for r in raw])
            .astype(np.float32) for i in range(6)]
    inits = [RO._initial_logits(p, C.PAPER_OPT["n_restarts"], 0) for p in ps]
    rest = (np.stack([np.asarray(x) for x, _ in inits]),
            np.stack([np.asarray(y) for _, y in inits]),
            np.stack([r_uniform(p).x for p in ps]).astype(np.float32),
            np.stack([r_uniform(p).y for p in ps]).astype(np.float32),
            np.array([RO.makespan(p, r_uniform(p), C.BARRIERS_GGG)
                      for p in ps], np.float32))
    statics = (kind, C.BARRIERS_GGG, opt_x, opt_y, 25)
    want = RO._solve_batch_many(tuple(map(jnp.asarray, arrs)),
                                *map(jnp.asarray, rest), *statics)
    got = TO._solve_batch_many(tuple(map(torch.from_numpy, arrs)),
                               *map(torch.from_numpy, rest), *statics)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    flat = [g for g, (n, _) in enumerate(C.PAPER_PLATFORMS) if n == 1]
    held = [g for g in range(len(ps)) if g not in flat]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[held], w[held], atol=1e-4)
    np.testing.assert_allclose(got[2][held], want[2][held], rtol=1e-4)
    np.testing.assert_allclose(got[2][flat], want[2][flat], rtol=1e-3)
    print(f"{kind} opt_x {opt_x} opt_y {opt_y}, the one-site requests after "
          f"25 steps: max |x - x_ref| "
          f"{float(np.abs(got[0][flat] - want[0][flat]).max())!r}, |y - "
          f"y_ref| {float(np.abs(got[1][flat] - want[1][flat]).max())!r}")


def _reference_outputs(app, corpus):
    p = r_planetlab(8, alpha=1.0, seed=0)
    keys, vals = corpus
    srcs = list(zip(np.array_split(keys, 8), np.array_split(vals, 8)))
    return RGeoMapReduce(p, r_uniform(p), app).run(srcs)[0]


@pytest.mark.parametrize("case", ["as run", "a session cut moved",
                                  "a user's entry dropped",
                                  "a user at two reducers"])
def test_session_check_holds_the_reference(C, case):
    """The reference's sessionization outputs pass phase 22d's numpy check;
    a moved cut point, a dropped entry or a user split across reducers
    fails it."""
    keys, vals = rapps.generate_logs(20_000, n_users=200, seed=5)
    outs = [(k.copy(), v.copy()) for k, v in _reference_outputs(
        rapps.sessionization(gap=1000), (keys, vals))]
    expect = C.expected_sessions(keys, vals, 1000)
    assert int(expect[2].sum()) > 200  # more sessions than users
    if case == "a session cut moved":
        k, v = max(outs, key=lambda kv: kv[0].size)
        sid = v >> 32
        # the first cut inside a user's entries goes: two sessions merge
        r = int(np.flatnonzero((sid[1:] != sid[:-1]) & (k[1:] == k[:-1]))[0])
        v[r + 1:] -= 1 << 32
    elif case == "a user's entry dropped":
        k, v = outs[0]
        outs[0] = (k[1:], v[1:])
    elif case == "a user at two reducers":  # its last entry, a session alone
        (k0, v0), (k1, v1) = outs[0], outs[1]
        outs[0] = (k0[:-1], v0[:-1])
        outs[1] = (np.concatenate([k0[-1:], k1]),
                   np.concatenate([v0[-1:] & ((1 << 32) - 1),
                                   v1 + (1 << 32)]))
    if case == "as run":
        C.check_sessions(outs, expect, case)
    else:
        with pytest.raises(SystemExit):
            C.check_sessions(outs, expect, case)


@pytest.mark.parametrize("case", ["as run", "two postings swapped",
                                  "a word at two reducers"])
def test_postings_check_holds_the_reference(C, case):
    """The reference's full inverted index passes phase 22d's numpy check;
    an unsorted reducer or a word split across reducers fails it."""
    corpus = rapps.generate_documents(600, 60, seed=6)
    outs = [(k.copy(), v.copy()) for k, v in _reference_outputs(
        rapps.inverted_index(), corpus)]
    expect = C.expected_postings(corpus[1])
    if case == "two postings swapped":
        k, v = outs[0]
        v[[0, 1]] = v[[1, 0]]
        k[[0, 1]] = k[[1, 0]]
    elif case == "a word at two reducers":
        (k0, v0), (k1, v1) = outs[0], outs[1]
        words, counts = np.unique(k0, return_counts=True)
        w = words[np.argmax(counts)]  # a word with many postings: one moves
        move = k0 == w
        outs[0] = (k0[~move], v0[~move])
        outs[1] = (np.concatenate([k1, k0[move][:1]]),
                   np.concatenate([v1, v0[move][:1]]))
        order = np.lexsort((outs[1][1], outs[1][0]))
        outs[1] = (outs[1][0][order], outs[1][1][order])
        outs[0] = (np.concatenate([outs[0][0], k0[move][1:]]),
                   np.concatenate([outs[0][1], v0[move][1:]]))
        order = np.lexsort((outs[0][1], outs[0][0]))
        outs[0] = (outs[0][0][order], outs[0][1][order])
    if case == "as run":
        C.check_postings(outs, expect, case)
    else:
        with pytest.raises(SystemExit):
            C.check_postings(outs, expect, case)


@pytest.fixture
def rehearsal(C, monkeypatch):
    """chip_smoke on the CPU: the default device the CPU, the card's name
    stubbed, and segment_sum replaced where word count calls it by its
    plain version that counts a launch."""
    previous = repro_torch._device.default_device()
    repro_torch.set_default_device("cpu")
    calls = []

    def counting(values, segment_ids, num_segments):
        segment_sum.launches += 1
        calls.append(1)
        return kref.segment_sum_ref(values, segment_ids, num_segments)

    monkeypatch.setattr(ops, "segment_sum", counting)
    monkeypatch.setattr(C, "card_name_and_limit", lambda: "the CPU")
    yield C, calls
    repro_torch.set_default_device(previous)


def test_phase_22_rehearses_on_the_cpu(rehearsal, small_ref):
    """Phase 2 at 200k words, then phase 22 at 6 x 25 on corpora of 200k
    records, held to the reference at the same settings: every check runs
    and passes, phase 2 launches segment_sum at every non-empty reducer of
    its four runs and phase 22 (whose word count row is phase 2's) none."""
    C, calls = rehearsal
    _, launches, row = C.phase_main_path(CPU, n_docs=SMALL_DOCS,
                                         words_per_doc=SMALL_WORDS,
                                         n_restarts=6, steps=150)
    assert launches == len(calls) and 8 <= launches <= 32
    calls.clear()
    out = C.phase_paper_figures(
        CPU, row, opt=SMALL_OPT, ref=small_ref["cells"], band={},
        n_logs=SMALL_LOGS, n_docs=SMALL_DOCS, words_per_doc=SMALL_WORDS)
    assert out["launches"] == len(calls) == 0
    assert len(out["held"]) == len(small_ref["cells"])
    assert {k for k, *_ in out["held"]} == set(small_ref["cells"])
    # ten solver calls and a warm repeat: 22a five (myopic_multi's two
    # rounds) and two without a solve, 22b four, 22d one
    assert [w[4] for w in out["walls"]] == [0, 0, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1]
    assert set(out["fig9"]) == {"word_count", "sessionization",
                                "inverted_index"}


@pytest.mark.parametrize("phase", ["22b", "22c", "22e"])
def test_sub_phases_run_alone(rehearsal, small_ref, phase):
    """22b, 22c and 22e alone solve what they take from an earlier
    sub-phase in the whole phase, and hold it."""
    C, _ = rehearsal
    kw = dict(opt=SMALL_OPT, ref=small_ref["cells"], band={})
    run = {"22b": C.paper_barriers, "22c": C.paper_des,
           "22e": C.paper_dynamics}[phase]
    log = run(CPU, None, **kw)[1]
    assert log["walls"] and log["held"]


if __name__ == "__main__":
    print_tables()
