"""The port's examples against the reference's, on the CPU.

Each geo example of the reference (``examples/geo_*.py``) and its port
(``examples/port_*.py --device cpu``, with ``jax`` and ``repro`` blocked)
runs once through ``runpy.run_path`` in a process of its own, and the
numbers are read from the globals the script leaves behind, not from its
prints.  A process of its own gives every run fresh solver counters (a
solver key's first call in the process is its "compile" in both packages)
and lets the runs go side by side.

Modeled and simulated makespans agree at 1e-3 relative, the bar the
roadmap sets for a solver's best objective, wherever the reference's own
anneal has settled.  Where it has not, the float32 rounding of each
package decides where the anneal ends.  There a witness in the same run
measures how far the reference itself moves (its spread, more than 1e-3),
and the port is held within that spread of the reference:

* the pipeline's two modes (another 1e-7 or 1e-6 of one bandwidth moves
  the reference's makespans by up to 4.3e-3 and 1.2e-3);
* ``reactive_shared`` and ``shared, no hysteresis`` (the co-replan at the
  drift ends 3.8e-3 elsewhere under another ``run_online`` seed).

``reactive_incremental`` charges each swap the measured solve time, which
differs between hosts and packages, so its line is held to invariants
only.  The LM examples draw their random weights in different packages,
so their values cannot match: serving and training are held as CPU runs
(their values against the reference, weights carried over, are held by
``tests/test_torch_serve.py`` and ``tests/test_torch_train.py``).
"""
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

#: the solver-objective bar (see the module docstring)
RTOL = 1e-3
#: a spread above this would make the witness's bar too wide to be a check
SPREAD_CAP = 1e-2

RUNNER = r"""
import contextlib, importlib.abc, io, json, runpy, sys
spec = json.loads(sys.argv[1])
if spec["block"]:
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError("blocked: " + name)
            return None
    sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
buf = io.StringIO()
out = []
for argv in spec["runs"]:
    sys.argv = [spec["path"]] + argv
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(spec["path"], run_name="__main__")
        exec(spec["post"], g)
    out.append({k: eval(v, g) for k, v in spec["eval"].items()})
print(json.dumps({"out": out, "stdout": buf.getvalue()}, default=float))
"""

_SPANS = {"modeled": "{k: r.makespan_modeled for k, r in reports.items()}",
          "sim": "{k: r.makespan_sim for k, r in reports.items()}"}
_ONLINE = "{k: (r.makespan_online, len(r.swaps), len(r.decisions)) for k, r in %s.items()}"

#: per geo example: the witness statements run in the reference's globals
#: after it ends (their result is its global ``witness``), and the
#: expressions read from both packages' globals
GEO = {
    "multijob": ("", _SPANS),
    "pipeline": (
        """
def _moved(eps):
    # stages() reads the script's own globals, of which runpy returns a copy
    script = stages.__globals__
    nominal = script["substrate"]
    B_sm = nominal.B_sm.copy()
    B_sm[1, 1] *= 1 + eps
    script["substrate"] = Substrate(
        B_sm=B_sm, B_mr=nominal.B_mr, C_m=nominal.C_m, C_r=nominal.C_r,
        cluster_s=nominal.cluster_s, cluster_m=nominal.cluster_m,
        cluster_r=nominal.cluster_r, name=nominal.name)
    try:
        return {m: GeoPipeline(stages(), name=m).plan(
                    m, stage_mode="e2e_multi", barriers=BARRIERS_GGL, **OPT
                ).simulate().makespan_modeled
                for m in ("stagewise", "end_to_end")}
    finally:
        script["substrate"] = nominal
witness = [_moved(1e-7), _moved(1e-6)]
""",
        _SPANS),
    "online": (
        """
def _reseeded(online):
    arrival = Arrival(GeoJob(stuck_view).with_plan(frozen2.planned.plans[1],
                                                   BARRIERS_GGL), t_arrival)
    return sched2.run_online(policy="reactive_shared", arrivals=[arrival],
                             cfg=cfg, online=online, seed=2,
                             **OPT).makespan_online
witness = {"reactive_shared": _reseeded(
               OnlineConfig(shared=True, hysteresis=1.0, solver_cost_s=1.0)),
           "shared, no hysteresis": _reseeded(
               OnlineConfig(shared=True, hysteresis=0.0))}
""",
        {"frozen": "frozen_sim.makespan", "frozen2": "frozen2_sim.makespan",
         "part1": _ONLINE % "reports", "part2": _ONLINE % "reports2"}),
    "planner_service": ("", {
        "batch": "[r.makespan for r in batch]",
        "inc": "[r.makespan for r in inc]",
        "worse": "worse", "stats": "solver_cache_stats()"}),
}


def _run(path, runs, post, extract, block, cwd):
    spec = dict(path=str(path), runs=runs, post=post, eval=extract,
                block=block)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(spec)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(cwd))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example of the reference and of the port, three at a time."""
    cwd = tmp_path_factory.mktemp("examples")
    ckpt = cwd / "ckpt"
    jobs = {}
    for name, (witness, extract) in GEO.items():
        jobs["ref", name] = (EXAMPLES / f"geo_{name}.py", [[]], witness,
                             dict(extract, witness="witness") if witness
                             else extract, False)
        jobs["port", name] = (EXAMPLES / f"port_{name}.py",
                              [["--device", "cpu"]], "", extract, True)
    jobs["port", "serve_lm"] = (
        EXAMPLES / "port_serve_lm.py", [["--device", "cpu"]], "",
        {"done": "[(r.rid, [int(t) for t in r.output]) for r in done]"}, True)
    # two runs in one checkpoint directory: the second resumes the first
    jobs["port", "train_lm"] = (
        EXAMPLES / "port_train_lm.py",
        [["--device", "cpu", "--steps", str(n), "--ckpt-dir", str(ckpt)]
         for n in (12, 24)],
        "", {"step": "int(state.step)"}, True)
    # the longest first
    order = sorted(jobs, key=lambda k: (k[1] != "online", k[1] != "pipeline"))
    with ThreadPoolExecutor(3) as ex:
        futures = {k: ex.submit(_run, *jobs[k], cwd) for k in order}
        return {k: f.result() for k, f in futures.items()}


def _close(port, ref, rtol):
    return abs(port - ref) <= rtol * abs(ref)


def _spreads(runs):
    """The reference's own spread on each unsettled line: the largest
    relative move of its makespan in the witness runs."""
    pipeline, online = runs["ref", "pipeline"]["out"][0], runs["ref", "online"]["out"][0]
    spread = {mode: max(abs(w[mode] / value - 1) for w in pipeline["witness"])
              for mode, value in pipeline["modeled"].items()}
    spread.update((name, abs(moved / online["part2"][name][0] - 1))
                  for name, moved in online["witness"].items())
    for name, value in spread.items():
        assert RTOL < value < SPREAD_CAP, (name, value)
    return spread


def test_multijob_matches_the_reference(runs):
    ref, port = runs["ref", "multijob"]["out"][0], runs["port", "multijob"]["out"][0]
    assert list(port["modeled"]) == ["independent", "sequential", "joint"]
    for kind in ("modeled", "sim"):
        for policy, value in ref[kind].items():
            assert _close(port[kind][policy], value, RTOL), (kind, policy)
    assert port["modeled"]["joint"] <= port["modeled"]["independent"]
    assert "joint planning reduces the executed aggregate makespan" in \
        runs["port", "multijob"]["stdout"]


def test_pipeline_matches_the_reference_within_its_own_spread(runs):
    ref, port = runs["ref", "pipeline"]["out"][0], runs["port", "pipeline"]["out"][0]
    # the witness: the reference's own anneal has not settled here
    spread = _spreads(runs)
    for kind in ("modeled", "sim"):
        for mode, value in ref[kind].items():
            assert _close(port[kind][mode], value, spread[mode]), (kind, mode)
    # the example's own asserts held in the port's run; restate them
    sw, e2e = port["modeled"]["stagewise"], port["modeled"]["end_to_end"]
    assert e2e <= sw + 1e-9
    assert 1 - port["sim"]["end_to_end"] / port["sim"]["stagewise"] >= 0.20


def test_online_matches_the_reference(runs):
    ref, port = runs["ref", "online"]["out"][0], runs["port", "online"]["out"][0]
    for key in ("frozen", "frozen2"):
        assert _close(port[key], ref[key], RTOL), key
    settled = [("part1", "static"), ("part1", "reactive"),
               ("part1", "horizon"), ("part2", "reactive (solo)")]
    for part, name in settled:
        (r_span, _, r_decisions), (p_span, _, p_decisions) = \
            ref[part][name], port[part][name]
        assert _close(p_span, r_span, RTOL), name
        assert p_decisions == r_decisions, name
    # reactive re-planning beats the frozen joint plan, as the example says
    assert port["part1"]["reactive"][0] < port["frozen"]
    # the co-replan at the drift has not settled in the reference: another
    # run_online seed moves its result by more than 1e-3
    spread = _spreads(runs)
    for name in ref["witness"]:
        assert _close(port["part2"][name][0], ref["part2"][name][0],
                      spread[name]), name
    shared, nohyst = port["part2"]["reactive_shared"], \
        port["part2"]["shared, no hysteresis"]
    assert shared[0] < port["frozen2"]
    assert shared[0] < port["part2"]["reactive (solo)"][0]
    assert shared[1] <= nohyst[1]
    # the measured charge differs between hosts: invariants only
    span, swaps, decisions = port["part2"]["reactive_incremental"]
    assert math.isfinite(span) and span > 0
    assert swaps <= decisions


def test_planner_service_counters_match_the_reference(runs):
    ref = runs["ref", "planner_service"]["out"][0]
    port = runs["port", "planner_service"]["out"][0]
    assert port["stats"] == ref["stats"]
    assert port["worse"] == ref["worse"] == 0
    assert all(i <= b + 1e-9 for i, b in zip(port["inc"], port["batch"]))
    assert len(port["inc"]) == 8


def test_serve_example_finishes_every_request(runs):
    from repro_torch.configs import get_config

    vocab = get_config("qwen3-1.7b").reduced().vocab
    done = runs["port", "serve_lm"]["out"][0]["done"]
    assert sorted(rid for rid, _ in done) == list(range(12))
    for _, tokens in done:
        assert len(tokens) == 16
        assert all(0 <= t < vocab for t in tokens)


def test_train_example_resumes_from_its_final_save(runs):
    first, second = runs["port", "train_lm"]["out"]
    assert (first["step"], second["step"]) == (12, 24)
    text = runs["port", "train_lm"]["stdout"]
    assert text.count("[resume] restored committed step 12") == 1
    assert "[resume]" not in text.split("[train] done")[0]
    losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)


def test_chip_smoke_constants_are_the_references(runs):
    """``chip_smoke.py`` phase 17 holds the card to the reference's numbers
    recorded as constants (jax is not on the card machine): they are this
    reference run's, makespans and spreads, to 1e-3 relative."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(ROOT))
    multijob = runs["ref", "multijob"]["out"][0]
    pipeline = runs["ref", "pipeline"]["out"][0]
    online = runs["ref", "online"]["out"][0]
    for kind in ("modeled", "sim"):
        for policy, value in multijob[kind].items():
            assert _close(C.REF_MULTIJOB[kind][policy], value, RTOL)
        for mode, value in pipeline[kind].items():
            assert _close(C.REF_PIPELINE[kind][mode], value, RTOL)
    spans = {"frozen": online["frozen"], "frozen2": online["frozen2"]}
    spans.update((k, v[0]) for part in ("part1", "part2")
                 for k, v in online[part].items())
    for name, value in C.REF_ONLINE.items():
        assert _close(value, spans[name], RTOL), name
    spread = _spreads(runs)
    assert set(C.REF_SPREAD) == set(spread)
    for name, value in spread.items():
        assert _close(C.REF_SPREAD[name], value, RTOL), name
    assert C.REF_SERVICE_STATS == runs["ref", "planner_service"]["out"][0]["stats"]
    assert C.EXAMPLE_RTOL == RTOL
