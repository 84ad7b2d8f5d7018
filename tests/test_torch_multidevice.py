"""The port's multi-device paths against the reference, on gloo worlds.

The targets of ``tests/test_multidevice.py``: expert-parallel MoE against
one device, the hierarchical all-reduce against a plain sum, an elastic
checkpoint reshard, the launcher's ``--mesh`` (also with gradient
compression), and the dry run.  Each case spawns a world of 4 processes
(a 2×2 mesh), each running torch on one thread, that meets through a
``file://`` rendezvous under ``tmp_path`` (no TCP port, so that test
workers run side by side), under a timeout of its own; a dry run's fake
world is one process of its own.  The world's processes import neither
jax nor the reference: what a rank needs of the reference (weights,
outputs) this process computes and writes to ``tmp_path`` first.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TIMEOUT_S = 4, 120
CPU = torch.device("cpu")

_PREAMBLE = """
import os, sys, json
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
def join():
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=RANK, world_size=int(os.environ["WORLD_SIZE"]))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_world(tmp_path, body: str, world: int = WORLD):
    """Run ``body`` in ``world`` processes (``RANK``, ``WORLD_SIZE`` and a
    ``file://`` rendezvous in ``INIT``); each must exit 0.  Returns each
    rank's standard output."""
    code = _PREAMBLE + textwrap.dedent(body)
    store = tmp_path / "rendezvous"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               WORLD_SIZE=str(world), INIT=f"file://{store}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r)), cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: rc {rc}\nSTDOUT:\n{out}\nSTDERR:\n{err}"
    return [out for _, out, _ in outs]


#: world code: ``record(name, arg)`` makes ``repro_torch.train.train_step``'s
#: function ``name`` save its argument ``arg`` (the gradients, gathered
#: whole: a collective, so every rank calls it) as rank 0's
#: ``<tag><name>_<call>.npz`` before it runs; ``RECORD["tag"]`` names the
#: run
_RECORD = """
import repro_torch.train.train_step as _TS
from repro_torch.models import model as _M
RECORD = {"tag": ""}
def record(name, arg):
    real = getattr(_TS, name)
    calls = {}
    def spy(*args, **kwargs):
        flat = {}
        def keep(path, g):
            if g is not None:
                g = g.full_tensor() if hasattr(g, "full_tensor") else g
                flat["/".join(path)] = g.detach().numpy()
        _M._tree_map(keep, args[arg])
        n = calls.get(RECORD["tag"], 0)
        calls[RECORD["tag"]] = n + 1
        if RANK == 0:
            np.savez(f"{RECORD['tag']}{name}_{n}.npz", **flat)
        return real(*args, **kwargs)
    setattr(_TS, name, spy)
"""


@contextlib.contextmanager
def replaying(name, arg, recorded):
    """Within: ``repro_torch.train.train_step``'s function ``name`` runs on
    ``recorded(t)`` (a path → array dict, a world's :data:`_RECORD` file)
    in place of its argument ``arg`` (the gradients) at its ``t``-th call:
    one device replays a mesh run's gradients.  Yields the list of the
    gradients it was handed, one tree a call."""
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    real, seen = getattr(TS, name), []

    def spy(*args, **kwargs):
        args = list(args)
        z = recorded(len(seen))
        seen.append(args[arg])
        args[arg] = M._tree_map(lambda path, g: g if g is None else torch.as_tensor(
            z["/".join(path)], dtype=g.dtype), args[arg])
        return real(*args, **kwargs)

    setattr(TS, name, spy)
    try:
        yield seen
    finally:
        setattr(TS, name, real)


def assert_leaves_close(got, want, label=""):
    """Every leaf of ``want`` (a tree of tensors; ``None`` leaves skipped)
    against ``got[path]`` (path → array) within 1e-5 of the leaf's largest
    entry."""
    from repro_torch.models import model as M

    def check(path, b):
        if b is not None:
            key = "/".join(path)
            np.testing.assert_allclose(got[key], b.numpy(), rtol=0,
                                       atol=1e-5 * float(b.abs().max()),
                                       err_msg=f"{label} {key}")
    M._tree_map(check, want)


# ---------------------------------------------------------------------------
# (a) expert-parallel MoE
# ---------------------------------------------------------------------------

def _granite(capacity_factor=8.0):
    import dataclasses

    from repro.configs import ARCHS as RA

    return dataclasses.replace(RA["granite-moe-3b-a800m"].reduced(),
                               capacity_factor=capacity_factor)


def _moe_plan_params(rp, cfg):
    """The reference's MoE parameters with a dispatch plan loaded: the
    experts in 4 groups of 2 (2 groups a pod), each expert taking its
    group's router bias and capacity factor."""
    from repro_torch.core.moe_plan import plan_moe_dispatch

    plan = plan_moe_dispatch(
        tokens_mb_per_shard=64.0, n_token_shards=4, group_pod=[0, 0, 1, 1],
        shard_pod=[0, 0, 1, 1], top_k=cfg.top_k,
        expert_flops_rate_mbps=[25000, 25000, 8000, 8000],
        n_restarts=4, steps=150, device="cpu")
    per = cfg.n_experts // 4
    bias = np.repeat(plan.router_bias, per).astype(np.float32)
    cap = np.repeat(plan.capacity_factor, per).astype(np.float32)
    assert not np.allclose(cap, 1.0) and not np.allclose(bias, 0.0)
    return dict(rp, plan_bias=jnp.asarray(bias), plan_capacity=jnp.asarray(cap))


@pytest.mark.parametrize("planned", [False, True], ids=["identity", "plan"])
def test_moe_expert_parallel_matches_one_device(tmp_path, planned):
    """``moe_fwd(mesh=)`` on a (data 2, model 2) mesh: each rank's tokens'
    ``y`` against the reference's single-device ``moe_fwd`` at atol/rtol
    2e-4, ``aux`` at rtol 1e-4 (the reference's own bar); once with the
    identity plan, once with the router bias and capacities of a
    ``plan_moe_dispatch`` plan."""
    from repro.models import layers as RL

    cfg = _granite()
    rp = RL.init_moe(cfg, jax.random.PRNGKey(0), tp=2)
    if planned:
        rp = _moe_plan_params(rp, cfg)
    x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = RL.moe_fwd(cfg, rp, jnp.asarray(x), mesh=None)
    np.savez(tmp_path / "moe.npz", x=x,
             **{k: np.asarray(v) for k, v in rp.items()})
    outs = run_world(tmp_path, """
        import dataclasses
        from repro_torch.configs import ARCHS
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        join()
        cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"].reduced(),
                                  capacity_factor=8.0)
        z = np.load("moe.npz")
        p = {k: torch.from_numpy(z[k]) for k in z.files if k != "x"}
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        d = mesh.get_local_rank("data")
        x = torch.from_numpy(z["x"])[2 * d:2 * d + 2]
        y, aux = L.moe_fwd(cfg, p, x, mesh=mesh)
        np.save(f"y{RANK}.npy", y.numpy())
        print("AUX", float(aux))
        dist.destroy_process_group()
    """)
    for r, out in enumerate(outs):
        d = r // 2  # init_device_mesh lays ranks out row-major
        np.testing.assert_allclose(np.load(tmp_path / f"y{r}.npy"),
                                   np.asarray(y_ref)[2 * d:2 * d + 2],
                                   atol=2e-4, rtol=2e-4)
        aux = float(out.split("AUX")[1].split()[0])
        np.testing.assert_allclose(aux, float(aux_ref), rtol=1e-4)


# ---------------------------------------------------------------------------
# (b) the hierarchical all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planned", [False, True], ids=["uniform", "plan"])
def test_hierarchical_allreduce_matches_the_sum(tmp_path, planned):
    """On (pod 2, data 2) every rank's tree comes back as 4× the tree
    (``mean=False``) to rtol 1e-6, with or without the segment sizes of a
    ``plan_cross_pod_reduction`` plan (which the schedule takes and does
    not read, as the reference)."""
    seg = None
    if planned:
        from repro_torch.core.collective_plan import plan_cross_pod_reduction

        rp = plan_cross_pod_reduction(grad_mb=4000.0,
                                      pod_dcn_bw_mbps=[6400, 1600],
                                      n_elements=1007, block=16,
                                      n_restarts=4, steps=150, device="cpu")
        assert int(rp.segment_sizes.sum()) == 1007
        seg = [int(v) for v in rp.segment_sizes]
    run_world(tmp_path, f"""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train.collective_schedule import (
            flat_size, hierarchical_allreduce)
        join()
        mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
        tree = {{"a": torch.arange(1000, dtype=torch.float32).reshape(10, 100),
                 "b": torch.ones(7)}}
        assert flat_size(tree) == 1007
        got = hierarchical_allreduce(tree, mesh, segment_sizes={seg!r},
                                     mean=False)
        np.testing.assert_allclose(got["a"].numpy(), 4.0 * tree["a"].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"].numpy(), 4.0, rtol=1e-6)
        mean = hierarchical_allreduce(tree, mesh)
        np.testing.assert_allclose(mean["a"].numpy(), tree["a"].numpy(),
                                   rtol=1e-6)
        dist.destroy_process_group()
    """)


# ---------------------------------------------------------------------------
# (c) elastic checkpoint reshard
# ---------------------------------------------------------------------------

def _qwen_tp2():
    from repro_torch.configs import ARCHS, padded_for_tp

    return padded_for_tp(ARCHS["qwen3-1.7b"].reduced(), 2)


def test_elastic_checkpoint_reshard(tmp_path):
    """A qwen3 state sharded on a 2×2 mesh (FSDP × TP) is saved; it is
    restored onto a (data 4, model 1) mesh in the same world, and in this
    process on one CPU device, and both are bitwise the unsharded
    ``init``."""
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import init_state

    ckpt = tmp_path / "ckpt"
    run_world(tmp_path, f"""
        from repro_torch.configs import ARCHS, padded_for_tp
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import model as M
        from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
        from repro_torch.train.checkpoint import CheckpointManager
        from repro_torch.train.train_step import (
            init_state, place_state, state_shardings)
        join()
        cfg = padded_for_tp(ARCHS["qwen3-1.7b"].reduced(), 2)
        gen = torch.Generator().manual_seed(0)
        full = init_state(cfg, M.init(cfg, gen, device="cpu", tp=2))
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with axis_rules(mesh, DEFAULT_RULES):
            sh = state_shardings(cfg, full, mesh)
        state = place_state(full, sh)
        shards = [a for a in state.params["groups"]["blk0"]["mixer"].values()]
        assert any(a.to_local().shape != a.shape for a in shards)
        mgr = CheckpointManager({str(ckpt)!r}, keep=2)
        mgr.save(5, state)
        dist.barrier()
        other = make_mesh((4, 1), ("data", "model"), "cpu")
        with axis_rules(other, DEFAULT_RULES):
            sh2 = state_shardings(cfg, full, other)
        back, _, step = mgr.restore(None, full, sh2)
        assert step == 5
        got, want = [], []
        M._tree_map(lambda _, a: got.append(a), back.params)
        M._tree_map(lambda _, a: want.append(a), full.params)
        for a, b in zip(got, want):
            assert torch.equal(a.full_tensor(), b)
        dist.destroy_process_group()
    """)
    cfg = _qwen_tp2()
    gen = torch.Generator().manual_seed(0)
    params = M.init(cfg, gen, device=CPU, tp=2)
    like = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(1),
                                  device=CPU, tp=2))
    restored, _, step = CheckpointManager(str(ckpt), keep=2).restore(None,
                                                                     like)
    assert step == 5
    got, want = [], []
    M._tree_map(lambda _, a: got.append(a), restored.params)
    M._tree_map(lambda _, a: want.append(a), params)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

_LAUNCH = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
           "--steps", "3", "--batch", "4", "--seq", "32", "--log-every", "1",
           "--warmup", "1"]


def _recording(losses):
    def wrap(step_fn):
        def step(state, batch):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return step
    return wrap


def test_launcher_mesh_matches_one_device(tmp_path):
    """``launch.train --mesh 2x2`` on four gloo processes gives the losses
    of the run without ``--mesh`` (held to the reference by
    ``tests/test_torch_train.py``) to 1e-5 relative, and its last
    checkpoint (gathered from the shards, written by rank 0) the same
    parameters to 1e-5 of each leaf's largest entry."""
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import CheckpointManager

    want = []
    state = T.main(_LAUNCH, wrap_step=_recording(want))
    ckpt = tmp_path / "ckpt"
    run_world(tmp_path, f"""
        from repro_torch.launch import train as T
        losses = []
        def wrap(step_fn):
            def step(state, batch):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                return state, metrics
            return step
        T.main({_LAUNCH!r} + ["--mesh", "2x2", "--init-method",
                              os.environ["INIT"], "--ckpt-dir", {str(ckpt)!r}],
               wrap_step=wrap)
        json.dump(losses, open(f"losses{{RANK}}.json", "w"))
    """)
    for r in range(WORLD):
        got = json.load(open(tmp_path / f"losses{r}.json"))
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
    saved, _, step = CheckpointManager(str(ckpt)).restore(None, state)
    assert step == 3

    def check(path, a):
        b = M._tree_map(lambda _, v: v, state.params)
        for key in path:
            b = b[key]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    M._tree_map(check, saved.params)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_launcher_mesh_compression_matches_one_device(tmp_path, kind):
    """``launch.train --mesh 2x2 --compression int8|bf16`` (it raised before
    the mesh step compressed) gives the losses of the one-device run with
    the same seed to 1e-5 relative, and compresses what one device
    compresses: each step's whole averaged gradient lies within 1e-5 of
    each leaf's largest entry of one device's, and one device that
    compresses the mesh's gradients with its own draws (a replay) ends at
    the mesh's parameters to 1e-5 of each leaf's largest entry.  With int8
    the mesh's parameters also match the plain one-device run's to that
    bar.  (On a tensor-parallel mesh the float32 gradient is one device's
    to about 1e-6 of its largest entry, not bit for bit, and a bf16
    rounding of an element that lies that close to a tie, or an AdamW
    update of a clipped gradient at the noise level, moves the plain
    runs' parameters apart by more.)"""
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import CheckpointManager

    argv = _LAUNCH + ["--compression", kind]
    want = []
    state = T.main(argv, wrap_step=_recording(want))
    ckpt = tmp_path / "ckpt"
    run_world(tmp_path, _RECORD + f"""
record("ef_compress_tree", 0)
from repro_torch.launch import train as T
losses = []
def wrap(step_fn):
    def step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return step
T.main({argv!r} + ["--mesh", "2x2", "--init-method",
                   os.environ["INIT"], "--ckpt-dir", {str(ckpt)!r}],
       wrap_step=wrap)
json.dump(losses, open(f"losses{{RANK}}.json", "w"))
""")
    for r in range(WORLD):
        got = json.load(open(tmp_path / f"losses{r}.json"))
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
    saved, _, step = CheckpointManager(str(ckpt)).restore(None, state)
    assert step == 3
    mesh_params = {}
    M._tree_map(lambda path, a: mesh_params.__setitem__("/".join(path),
                                                        a.numpy()),
                saved.params)

    def recorded(t):
        return np.load(tmp_path / f"ef_compress_tree_{t}.npz")
    with replaying("ef_compress_tree", 0, recorded) as own:
        replay = T.main(argv)
    assert len(own) == 3
    for t, grads in enumerate(own):
        assert_leaves_close(recorded(t), grads, f"step {t} gradient")
    assert_leaves_close(mesh_params, replay.params, "replayed parameters")
    if kind == "int8":
        assert_leaves_close(mesh_params, state.params, "parameters")


# ---------------------------------------------------------------------------
# (e) an expert-parallel MoE train step
# ---------------------------------------------------------------------------

_MOE_STEP = """
import dataclasses
from repro_torch.configs import ARCHS, padded_for_tp
from repro_torch.models import model as M
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
cfg = padded_for_tp(dataclasses.replace(
    ARCHS["granite-moe-3b-a800m"].reduced(), capacity_factor=8.0), 2)
tcfg = TrainConfig(compute_dtype=torch.float32, remat=False)
toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(4, 17))
batch = {"tokens": torch.from_numpy(toks[:, :-1]),
         "labels": torch.from_numpy(toks[:, 1:])}
state = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(0),
                               device="cpu", tp=2))
"""


def test_moe_train_step_on_a_mesh_matches_one_device(tmp_path):
    """Two float32 train steps of the reduced Granite-MoE (capacity factor
    8: no token dropped on either side, whose capacities differ, as the
    reference's do) on a 2×2 mesh, experts parallel over ``model``, give
    the single-device losses and gradient norms to 1e-5 relative and its
    parameters to 1e-5 of each leaf's largest entry: the expert-parallel
    backward is the gradient of the same loss (the norm is taken before
    clipping, so a gradient scaled by a mesh dim's size shows there, where
    AdamW's update would hide it)."""
    scope = {"torch": torch, "np": np}
    exec(_MOE_STEP, scope)
    step = scope["make_train_step"](scope["cfg"], scope["tcfg"])
    state, want = scope["state"], []
    for _ in range(2):
        state, metrics = step(state, scope["batch"])
        want.append([float(metrics["loss"]), float(metrics["grad_norm"])])
    run_world(tmp_path, _MOE_STEP + """
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train.train_step import place_state, state_shardings
join()
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
with axis_rules(mesh, DEFAULT_RULES):
    state = place_state(state, state_shardings(cfg, state, mesh))
    step = make_train_step(cfg, tcfg, mesh=mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append([float(metrics["loss"]),
                       float(metrics["grad_norm"].full_tensor())])
final = {}
M._tree_map(lambda path, a: final.__setitem__("/".join(path),
                                              a.full_tensor().numpy()),
            state.params)
if RANK == 0:
    np.savez("final.npz", **final)
json.dump(losses, open(f"losses{RANK}.json", "w"))
dist.destroy_process_group()
""")
    for r in range(WORLD):
        np.testing.assert_allclose(
            json.load(open(tmp_path / f"losses{r}.json")), want, rtol=1e-5)
    z = np.load(tmp_path / "final.npz")
    from repro_torch.models import model as M

    def check(path, a):
        np.testing.assert_allclose(z["/".join(path)], a.numpy(), rtol=0,
                                   atol=1e-5 * float(a.abs().max()))
    M._tree_map(check, state.params)


# ---------------------------------------------------------------------------
# (f) the logical-axis annotation on a DTensor
# ---------------------------------------------------------------------------

def test_shard_redistributes_a_dtensor(tmp_path):
    """Inside ``axis_rules`` on a 2×2 mesh, ``shard`` lays a DTensor out as
    the rules say (the batch over ``data``, heads over ``model``; the
    ``pod`` axis the mesh lacks dropped), keeps its values, and leaves a
    plain tensor as it is."""
    run_world(tmp_path, """
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.sharding import DEFAULT_RULES, axis_rules, shard
        join()
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        full = torch.arange(4 * 6 * 8 * 2, dtype=torch.float32).reshape(4, 6, 8, 2)
        x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
        with axis_rules(mesh, DEFAULT_RULES):
            y = shard(x, "act_batch", "act_heads", "act_seq", None)
            assert shard(full, "act_batch") is full
            assert shard(y, "act_batch", "act_heads", "act_seq", None) is y
        assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
        assert y.to_local().shape == (2, 3, 8, 2)
        assert torch.equal(y.full_tensor(), full)
        dist.destroy_process_group()
    """)


# ---------------------------------------------------------------------------
# (g) the dry run on fake worlds, held to real ones
# ---------------------------------------------------------------------------

def run_fake(tmp_path, body: str) -> str:
    """Run ``body`` in one process (the fake worlds it starts live there);
    returns its standard output."""
    code = "import json, torch\ntorch.set_num_threads(1)\n" + \
        textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return proc.stdout


#: the reference report's keys whose meaning carries over
CARRIED_KEYS = ("arch", "shape", "mesh", "n_devices", "kind", "model_params",
                "model_active_params", "padded_params",
                "padded_active_params", "attn_flops_total", "variant",
                "microbatches", "argument_size_in_bytes",
                "output_size_in_bytes", "per_device_bytes",
                "collectives_per_device_bytes")


#: the reference test's dry-run cells (``tests/test_multidevice.py``)
DRYRUN_CELLS = [("qwen3-1.7b", "train_4k"),
                ("granite-moe-3b-a800m", "train_4k"),
                ("falcon-mamba-7b", "decode_32k")]


@pytest.fixture(scope="module")
def fake_world_reports(tmp_path_factory):
    """``run_cell`` of each of ``DRYRUN_CELLS`` on a fake 2×4 world (reduced
    configs, ``--device cpu``), one world after the other in one process;
    each world must be gone after its cell."""
    out = run_fake(tmp_path_factory.mktemp("dryrun"), f"""
        import torch.distributed as dist
        from repro_torch.launch.dryrun import run_cell
        for arch, shape in {DRYRUN_CELLS!r}:
            rep = run_cell(arch, shape, multi_pod=False,
                           mesh=((2, 4), ("data", "model")), reduced=True,
                           device="cpu")
            assert not dist.is_initialized()
            print("REPORT", json.dumps(rep))
    """)
    reports = [json.loads(line.split("REPORT", 1)[1])
               for line in out.splitlines() if line.startswith("REPORT")]
    return {(r["arch"], r["shape"]): r for r in reports}


@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS)
def test_dryrun_cell_on_a_fake_world(fake_world_reports, arch, shape):
    """The report of a cell on a fake 2×4 world has the reference's
    carried-over keys and no invented HLO key, per-device flops and bytes
    above 0, collectives in every cell (a mesh with more than one
    ``"model"`` rank all-reduces every tensor-parallel layer's output), and
    the analytic keys equal the reference's functions on the reference's
    padded config."""
    from repro.configs import ARCHS as RA
    from repro.configs import SHAPES as RS
    from repro.configs import padded_for_tp as ref_padded
    from repro.launch.analysis import attention_flops

    rep = fake_world_reports[(arch, shape)]
    for key in CARRIED_KEYS:
        assert key in rep, key
    assert not [k for k in rep if k.startswith("hlo_") or k.endswith(
        "_rolled") or k in ("compile_s", "generated_code_size_in_bytes")]
    assert rep["mesh"] == "2x4" and rep["n_devices"] == 8
    assert rep["flops_per_device"] > 0 and rep["per_device_bytes"] > 0
    assert rep["argument_size_in_bytes"] > 0
    assert rep["per_device_bytes"] >= rep["argument_size_in_bytes"]
    coll = rep["collectives_per_device_bytes"]
    assert coll["total"] == pytest.approx(sum(
        v for k, v in coll.items() if k != "total"))
    # every cell on a mesh with "model" > 1 communicates
    assert coll["total"] > 0
    cfg0 = RA[arch].reduced()
    cfg = ref_padded(cfg0, 4)
    spec = RS[shape]
    assert rep["model_params"] == cfg0.n_params()
    assert rep["model_active_params"] == cfg0.n_active_params()
    assert rep["padded_params"] == cfg.n_params()
    assert rep["padded_active_params"] == cfg.n_active_params()
    assert rep["attn_flops_total"] == attention_flops(
        cfg, spec.kind, B=spec.global_batch,
        T=spec.seq_len if spec.kind != "decode" else 1,
        cache_len=spec.seq_len if spec.kind == "decode" else 0)


_TINY_TRAIN = """
import torch
from repro_torch.configs import SHAPES, ShapeSpec, get_config, padded_for_tp
SHAPES["train_tiny"] = ShapeSpec("train_tiny", 64, 8, "train")
TCFG = dict(compute_dtype=torch.bfloat16, remat=True, use_kernels=False)
"""


def test_dryrun_fake_world_matches_a_real_world(tmp_path):
    """The reduced qwen3 train step, bf16 with remat, on a real 2×2 gloo
    world (real tensors, ``DeviceCounter`` on each rank) and as the dry
    run on a fake 2×2 world as each rank: every rank's flop count and its
    list of collectives (kind, per-rank bytes, group size, in order) are
    the same.  The batch is 8 × 64 tokens, not ``train_4k``'s 256 × 4096
    (a real CPU step of a million tokens per rank): the collectives move
    the parameters and gradients, whose sizes do not depend on it."""
    run_world(tmp_path, _TINY_TRAIN + """
from repro_torch.launch.dryrun import DeviceCounter
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step, place_state,
                                          state_shardings)
join()
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
cfg = padded_for_tp(get_config("qwen3-1.7b").reduced(), 2)
state = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(0),
                               device="cpu", tp=2))
with axis_rules(mesh, DEFAULT_RULES):
    state = place_state(state, state_shardings(cfg, state, mesh))
toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(8, 65))
batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
         "labels": torch.from_numpy(toks[:, 1:]).int()}
step = make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh)
c = DeviceCounter("cpu")
with axis_rules(mesh, DEFAULT_RULES), c:
    step(state, batch)
json.dump({"flops": c.flops, "collectives": c.collectives},
          open(f"real{RANK}.json", "w"))
dist.destroy_process_group()
""")
    run_fake(tmp_path, _TINY_TRAIN + """
import torch.distributed as dist
import torch.testing._internal.distributed.fake_pg  # noqa: F401
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh
for rank in range(4):
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rep = run_cell("qwen3-1.7b", "train_tiny", False, mesh=mesh,
                   reduced=True, device="cpu")
    json.dump({"flops": rep["flops_per_device"],
               "collectives": rep["collectives"]},
              open(f"fake{rank}.json", "w"))
    dist.destroy_process_group()
""")
    for r in range(WORLD):
        real = json.load(open(tmp_path / f"real{r}.json"))
        fake = json.load(open(tmp_path / f"fake{r}.json"))
        assert real["flops"] > 0 and real["collectives"]
        assert fake["flops"] == real["flops"], r
        assert [list(c) for c in real["collectives"]] == fake["collectives"], r


def test_dryrun_flops_equal_flop_counter_on_the_real_step(tmp_path):
    """The CPU rehearsal of phase 15b: on a one-rank gloo world with a 1×1
    mesh, the dry run's per-device flops equal ``FlopCounterMode``'s count
    over the real step on the same shapes, for the reduced qwen3 train
    step (bf16, remat) and a reduced Granite-MoE prefill past the
    dense-attention limit (``chunked_attention`` traced once a layer
    signature and replayed)."""
    run_world(tmp_path, _TINY_TRAIN + """
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, ShapeSpec
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step, place_state,
                                          state_shardings)
SHAPES["prefill_tiny"] = ShapeSpec("prefill_tiny", 4096, 3, "prefill")
join()
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
cfg = get_config("qwen3-1.7b").reduced()
state = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(0),
                               device="cpu"))
with axis_rules(mesh, DEFAULT_RULES):
    state = place_state(state, state_shardings(cfg, state, mesh))
toks = torch.zeros((8, 64), dtype=torch.int32)
step = make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh)
f = FlopCounterMode(display=False)
with axis_rules(mesh, DEFAULT_RULES), f:
    step(state, {"tokens": toks, "labels": toks})
dry = run_cell("qwen3-1.7b", "train_tiny", False, mesh=mesh, reduced=True,
               device="cpu")
assert dry["flops_per_device"] == f.get_total_flops(), (
    dry["flops_per_device"], f.get_total_flops())
g = get_config("granite-moe-3b-a800m").reduced()
params = M.init(g, torch.Generator().manual_seed(0), device="cpu",
                dtype=torch.bfloat16)
f = FlopCounterMode(display=False)
with axis_rules(mesh, DEFAULT_RULES), f:
    M.prefill(g, params, {"tokens": torch.zeros((3, 4096), dtype=torch.int32)},
              max_cache_len=4096, mesh=mesh)
dry = run_cell("granite-moe-3b-a800m", "prefill_tiny", False, mesh=mesh,
               reduced=True, device="cpu")
assert dry["flops_per_device"] == f.get_total_flops(), (
    dry["flops_per_device"], f.get_total_flops())
assert dry["collectives_per_device_bytes"]["total"] == 0.0
dist.destroy_process_group()
""", world=1)
