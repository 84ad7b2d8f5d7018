"""The port's scale tier and executor audits against the reference's: the
3-tier substrate and job-mix generators array for array, a small scale mix
through both packages' executors (both event loops and the fluid one), the audit
suite's report, and ``python -m repro_torch.analysis`` run with ``jax`` and
``repro`` blocked, all on the CPU."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as RC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro.analysis import audit as r_audit  # noqa: E402
from repro_torch.analysis import audit as t_audit  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 7, 123)
SUBSTRATE_FIELDS = ("B_sm", "B_mr", "C_m", "C_r", "cluster_s", "cluster_m",
                    "cluster_r")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_tier(C, seed=7):
    return C.scale_tier_substrate(
        n_regions=2, edges_per_region=6, mappers_per_region=4,
        n_backbone=1, reducers_per_backbone=4, seed=seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_scale_tier_substrate_matches_reference(seed):
    """The default 48-source, 32-mapper, 12-reducer tier and a small one."""
    for build in (lambda C: C.scale_tier_substrate(seed=seed),
                  lambda C: small_tier(C, seed)):
        want, got = build(RC), build(TC)
        assert got.name == want.name
        for field in SUBSTRATE_FIELDS:
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


@pytest.mark.parametrize("seed", SEEDS)
def test_scale_job_mix_matches_reference(seed):
    base = dict(n_jobs=12, seed=seed, arrival_spread_s=50.0)
    want = RC.scale_job_mix(RC.scale_tier_substrate(seed=seed), **base,
                            base_cfg=RC.SimConfig(chunk_mb=32.0))
    got = TC.scale_job_mix(TC.scale_tier_substrate(seed=seed), **base,
                           base_cfg=TC.SimConfig(chunk_mb=32.0))
    assert len(got) == len(want) == 12
    for (gp, gplan, gcfg), (wp, wplan, wcfg) in zip(got, want):
        assert (gp.name, gp.alpha) == (wp.name, wp.alpha)
        np.testing.assert_array_equal(gp.D, wp.D)
        np.testing.assert_array_equal(gplan.x, wplan.x)
        np.testing.assert_array_equal(gplan.y, wplan.y)
        assert gplan.meta == wplan.meta
        assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)


@pytest.mark.parametrize("mode", ["event", "event_vec", "fluid"])
def test_scale_mix_simulates_as_the_reference(mode):
    """Six jobs of a small tier, released over 40 s: the same schedule
    result, makespan included, in both executors."""
    results = []
    for C in (RC, TC):
        sub = small_tier(C)
        entries = C.scale_job_mix(
            sub, n_jobs=6, seed=11, arrival_spread_s=40.0,
            base_cfg=C.SimConfig(chunk_mb=32.0, mode=mode))
        results.append(C.simulate_schedule(entries, substrate=sub))
    want, got = results
    assert np.isfinite(got.makespan) and got.makespan > 0
    assert got.makespan == want.makespan
    assert json.dumps(got.as_dict(), sort_keys=True) == json.dumps(
        want.as_dict(), sort_keys=True)


def test_audit_run_all_matches_reference():
    want = r_audit.run_all(k=2, seed=0)
    got = t_audit.run_all(k=2, seed=0)
    assert got.lines() == want.lines()
    assert (got.ok, got.race_detected) == (want.ok, want.race_detected)
    assert got.violations == want.violations
    assert [n for n, _ in t_audit.QUICK_SCENARIOS] == [
        n for n, _ in r_audit.QUICK_SCENARIOS]
    assert "pipeline_chain" in dict(t_audit.QUICK_SCENARIOS)


def test_analysis_cli_runs_with_jax_and_repro_blocked():
    """``python -m repro_torch.analysis -k 2`` runs the audits and exits 0
    without ``jax`` or ``repro`` importable."""
    script = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["repro_torch.analysis", "-k", "2"]
runpy.run_module("repro_torch.analysis", run_name="__main__")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last == (f"audit: {len(t_audit.QUICK_SCENARIOS)} scenarios + swap "
                    "path, 2 tie-break permutations each: ok")
