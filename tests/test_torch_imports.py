"""The port stands alone: ``repro_torch`` imports without ``jax`` or
``repro``, no module of it (nor ``chip_smoke.py``) names either, the
numpy-only modules it carries are byte-identical to the reference's, and
its entry points refuse to fall back to the CPU quietly."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import optimize_plan, planetlab_platform  # noqa: E402
from repro_torch.mapreduce.apps import word_count  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

#: modules the port carries as byte-identical copies of the reference's
COPIES = [
    "analysis/validate.py",
    "core/platform.py",
    "core/plan.py",
    "core/milp.py",
    "core/simulate.py",
    "core/fluid.py",
    "data/__init__.py",
    "data/pipeline.py",
    "data/tokenizer.py",
    "mapreduce/partition.py",
    "mapreduce/engine.py",
    "models/config.py",
]

BLOCKED = ("jax", "jaxlib", "repro")


def _port_modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PORT)], prefix="repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = _port_modules()
    assert "repro_torch.core.optimize" in modules
    assert "repro_torch.kernels.segment_reduce" in modules
    assert "repro_torch.kernels.mamba_scan" in modules
    assert "repro_torch.kernels.moe_dispatch" in modules
    assert "repro_torch.serve.engine" in modules
    assert "repro_torch.launch.serve" in modules
    for name in ("train.optim", "train.compression", "train.train_step",
                 "train.checkpoint", "data.pipeline", "launch.train"):
        assert f"repro_torch.{name}" in modules
    script = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in {modules!r}:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in BLOCKED]
    assert bad == [], f"{path}: imports {bad}"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


@pytest.mark.parametrize(
    "rel", sorted(str(p.relative_to(REF)) for p in (REF / "configs").glob("*.py")
                  if p.name != "__init__.py"))
def test_architecture_file_differs_only_in_its_import(rel):
    want = (REF / rel).read_text().replace(
        "from repro.models.config import", "from repro_torch.models.config import")
    assert (PORT / rel).read_text() == want, rel


@pytest.fixture
def no_cuda(monkeypatch):
    """The process default device is the card, and there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = repro_torch.default_device()
    repro_torch.set_default_device("cuda")
    yield
    repro_torch.set_default_device(before)


def test_optimize_plan_raises_without_cuda(no_cuda):
    p = planetlab_platform(2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize_plan(p, "e2e_multi", n_restarts=2, steps=3)
    # asking for the CPU is the fix the message names
    r = optimize_plan(p, "e2e_multi", n_restarts=2, steps=3, device="cpu")
    assert np.isfinite(r.makespan)


def test_word_count_reduce_raises_without_cuda(no_cuda):
    keys = np.array([1, 1, 2], np.int64)
    counts = np.array([3, 4, 5], np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        word_count().reduce_fn(keys, counts)
    uniq, sums = word_count(device="cpu").reduce_fn(keys, counts)
    np.testing.assert_array_equal(uniq, [1, 2])
    np.testing.assert_array_equal(sums, [7, 5])


def _two_jobs():
    from repro_torch.core import Substrate

    sub = Substrate.of(planetlab_platform(2, seed=0))
    return [sub.view(np.full(sub.nS, 100.0 * (g + 1)), 1.0, name=f"j{g}")
            for g in range(2)]


def _schedule(device=None):
    from repro_torch.api import GeoJob, GeoSchedule

    return GeoSchedule([GeoJob(v) for v in _two_jobs()], device=device)


def _plan_schedule(device):
    return _schedule(device).plan("joint", n_restarts=2, steps=3).planned


def _optimize_schedule(device):
    from repro_torch.core import optimize_schedule

    return optimize_schedule(_two_jobs(), "joint", n_restarts=2, steps=3,
                             device=device)


def _replan(device):
    from repro_torch.core import replan, uniform_plan

    p = _two_jobs()[0]
    return replan(p, uniform_plan(p), n_restarts=2, steps=3, device=device)


def _replan_batch(device):
    from repro_torch.core import replan_batch, uniform_plan

    ps = _two_jobs()
    return replan_batch(ps, [uniform_plan(p) for p in ps], n_restarts=2,
                        steps=3, device=device)


def _replan_schedule(device):
    from repro_torch.core import (JobProgress, Substrate, replan_schedule,
                                  uniform_plan)

    ps = _two_jobs()
    return replan_schedule(Substrate.of(ps[0]), [uniform_plan(p) for p in ps],
                           [JobProgress.fresh(p, job=g)
                            for g, p in enumerate(ps)],
                           n_restarts=2, steps=3, device=device)


def _run_online(device):
    sched = _schedule(device)
    for job in sched.jobs:
        job.plan("uniform", device="cpu")
    return sched.with_plans().run_online("reactive", n_restarts=2, steps=3)


@pytest.mark.parametrize("entry", [_plan_schedule, _optimize_schedule, _replan,
                                   _replan_batch, _replan_schedule,
                                   _run_online],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_schedule_and_online_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(None)
    assert entry("cpu") is not None
