"""The port's training stack against the reference's, on the CPU.

``repro_torch.train`` (AdamW, its schedule and decay mask, error-feedback
compression, the train step, checkpoints), ``repro_torch.data`` and
``repro_torch.launch.train``, each held against its reference module on
the same inputs: the reduced qwen3 config, parameters from the
reference's ``init`` carried across with ``repro_torch.convert``, batches
from ``synthetic_lm_batch``.  Float32 throughout.

Bars:

* the schedule, the decay mask and bf16 compression: equal;
* ``global_norm``, loss, grad norm and lr: rtol 1e-5 (float32 sums in
  another order);
* parameters and moments after AdamW: rtol 1e-6 plus atol 1e-6 · lr (the
  size of an update).  Adam's first step is ``g / (|g| + eps)``, which
  carries a gradient's own float error (``GRAD_ERR`` of its leaf's largest
  entry, from the two packages' backward passes) into the update where
  |g| is near ``eps``: there the error is held to that error propagated
  (at most 2 · lr), and such elements are counted, under 1% (81 of 90,496
  in the train step);
* the e2e_push data plan: its end-to-end makespan to the planner's 1e-3;
* int8 compression draws its rounding noise from a torch generator, not
  jax's stream, so it is held to its properties: |q| ≤ 127, the residual
  exactly ``g + r - rec``, ``|rec - (g + r)|`` within one scale step, and
  a mean error near zero over many draws;
* checkpoints: bit for bit, across the packages in both directions.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.core.makespan import makespan as ref_makespan  # noqa: E402
from repro.core.platform import tpu_pod_platform as ref_tpu_pod_platform  # noqa: E402
from repro.data.pipeline import GeoDataPipeline as RefPipeline  # noqa: E402
from repro.data.pipeline import synthetic_lm_batch as ref_batch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import compression as RCmp  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.core.makespan import BARRIERS_ALL_PIPELINED, makespan  # noqa: E402
from repro_torch.core.platform import tpu_pod_platform  # noqa: E402
from repro_torch.data.pipeline import GeoDataPipeline, synthetic_lm_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import compression as Cmp  # noqa: E402
from repro_torch.train import optim as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

CPU = torch.device("cpu")
QWEN = "qwen3-1.7b"
LR = 1e-2
#: the float error of a gradient leaf, relative to its largest entry: the
#: bar of tests/test_torch_arch_smoke.py is 1e-4, the archs measure at most
#: 8e-6 there, qwen3 1.1e-6
GRAD_ERR = 1e-5
RTOL = 1e-5


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The data pipeline plans on the process default device."""
    before = repro_torch.default_device()
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(before)


@pytest.fixture(scope="module")
def qwen():
    """(reference cfg, port cfg, reference params)."""
    rcfg, pcfg = REF_ARCHS[QWEN].reduced(), ARCHS[QWEN].reduced()
    return rcfg, pcfg, RM.init(rcfg, jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def _batch(vocab, B=4, T=32, step=0, seed=7):
    return synthetic_lm_batch(vocab, B, T, step, seed=seed)


@pytest.fixture(scope="module")
def qwen_grads(qwen):
    """The reference's float32 gradients of the qwen3 loss on ``_batch``, as
    numpy arrays."""
    rcfg, _, rparams = qwen
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg.vocab).items()}
    return _np(jax.jit(jax.grad(lambda p: RM.loss_fn(rcfg, p, batch)[0]))(
        rparams))


def _assert_adamw_close(got, want, grads, lr, label, grad_err, clip=1.0):
    """The AdamW bar of the module docstring, leaf for leaf: rtol 1e-6 plus
    atol 1e-6 · lr; where the first step's ``g / (|g| + eps)`` carries the
    gradient's own float error (``grad_err`` of the leaf's largest entry,
    both after clipping ``grads`` to ``clip``) further, that error
    propagated, at most 2 · lr.  Returns the number of elements outside
    the plain bar and inside the propagated one, which must be under 1%."""
    eps = O.AdamWConfig().eps
    scale = min(1.0, clip / float(np.sqrt(sum(
        np.sum(np.square(np.asarray(O.tree_get(grads, p), np.float64)))
        for p in _paths(grads)))))
    n_sensitive, n = 0, 0
    for path in _paths(want):
        w = np.asarray(O.tree_get(want, path))
        g = O.tree_get(got, path).detach().numpy()
        grad = scale * np.abs(np.asarray(O.tree_get(grads, path), np.float64))
        carried = lr * eps * grad_err * grad.max() / (grad + eps) ** 2
        err = np.abs(g - w)
        plain = 1e-6 * np.abs(w) + 1e-6 * lr
        ok = err <= np.minimum(plain + carried, 2 * lr)
        assert ok.all(), (label, "/".join(path), err[~ok].max())
        n_sensitive += int((err > plain).sum())
        n += w.size
    assert n_sensitive < 0.01 * n, (label, n_sensitive, n)
    return n_sensitive


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def test_cosine_schedule_equals_the_reference():
    want_fn = RO.cosine_schedule(3e-4, 10, 50)
    got_fn = O.cosine_schedule(3e-4, 10, 50)
    steps = np.arange(61)
    want = np.array([np.asarray(want_fn(jnp.int32(s))) for s in steps])
    got = got_fn(torch.tensor(steps, dtype=torch.int32)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "stablelm-1.6b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m"])
def test_decay_mask_equals_the_reference(name):
    """Over each package's own parameter tree (the reference's traced for
    its shapes only)."""
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    shapes = jax.eval_shape(lambda k: RM.init(rcfg, k), jax.random.PRNGKey(0))
    want = RO._decay_mask(shapes, RO.AdamWConfig().no_decay)
    got = O._decay_mask(M.init(pcfg, torch.Generator().manual_seed(0),
                               device=CPU), O.AdamWConfig().no_decay)
    assert sorted(_paths(got)) == sorted(_paths(want))
    for path in _paths(want):
        assert O.tree_get(got, path) == O.tree_get(want, path), path
    assert not all(O.tree_get(got, p) for p in _paths(got))


def test_global_norm_matches_the_reference(qwen):
    rcfg, pcfg, rparams = qwen
    want = RO.global_norm(rparams)
    got = O.global_norm(lm_params_from_numpy(pcfg, _np(rparams), device=CPU))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_adamw_update_matches_the_reference(qwen, qwen_grads):
    """Two updates from a fresh state and the same gradients: the first at
    the schedule's lr 0 (moments only), the second with decay, bias
    corrections at t = 2 and a clipped norm; a ``None`` gradient counts as
    zeros."""
    rcfg, pcfg, rparams = qwen
    grads = jax.tree.map(np.copy, qwen_grads)
    grads["final_norm"]["scale"] = np.zeros_like(grads["final_norm"]["scale"])
    cfg = RO.AdamWConfig(lr=LR, grad_clip=0.5)
    pcfg_opt = O.AdamWConfig(lr=LR, grad_clip=0.5)
    want_fn, got_fn = RO.cosine_schedule(LR, 1, 10), O.cosine_schedule(LR, 1, 10)
    want_p, want_s = rparams, RO.adamw_init(rparams)
    ref_update = jax.jit(lambda p, g, st: RO.adamw_update(cfg, p, g, st, want_fn))
    got_p = lm_params_from_numpy(pcfg, _np(rparams), device=CPU)
    got_s = O.adamw_init(got_p)
    got_g = lm_params_from_numpy(pcfg, grads, device=CPU)
    got_g["final_norm"]["scale"] = None
    for i in range(2):
        want_p, want_s, wm = ref_update(want_p, grads, want_s)
        got_p, got_s, gm = O.adamw_update(pcfg_opt, got_p, got_g, got_s, got_fn)
        np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                                   rtol=RTOL)
        assert float(gm["lr"]) == float(wm["lr"])
        assert int(got_s.step) == int(want_s.step) == i + 1
        for name, got, want in (("params", got_p, want_p),
                                ("m", got_s.m, want_s.m),
                                ("v", got_s.v, want_s.v)):
            _assert_adamw_close(got, _np(want), grads, LR, f"{name} {i}",
                                grad_err=1e-6, clip=0.5)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grad_and_residual(seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((64, 48)).astype(np.float32),
         "b": {"c": (rng.standard_normal(96) * 1e-3).astype(np.float32)}}
    r = {"a": (rng.standard_normal((64, 48)) * 1e-2).astype(np.float32),
         "b": {"c": (rng.standard_normal(96) * 1e-5).astype(np.float32)}}
    return g, r


def _tt(tree):
    return M._tree_map(lambda _, a: torch.from_numpy(np.array(a)), tree)


def test_bf16_error_feedback_equals_the_reference():
    g, r = _grad_and_residual()
    want_rec, want_res = RCmp.ef_compress_tree(g, r, jax.random.PRNGKey(0),
                                               kind="bf16")
    gen = torch.Generator().manual_seed(0)
    got_rec, got_res = Cmp.ef_compress_tree(_tt(g), _tt(r), gen, kind="bf16")
    for path in _paths(g):
        np.testing.assert_array_equal(O.tree_get(got_rec, path).numpy(),
                                      np.asarray(O.tree_get(want_rec, path)))
        np.testing.assert_array_equal(O.tree_get(got_res, path).numpy(),
                                      np.asarray(O.tree_get(want_res, path)))


def test_int8_error_feedback_properties():
    g, r = _grad_and_residual(1)
    gen = torch.Generator().manual_seed(3)
    total = (torch.from_numpy(g["a"]) + torch.from_numpy(r["a"]))
    q, scale = Cmp.compress_int8(total, gen)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert tuple(scale.shape) == (64, 1)
    rec, res = Cmp.ef_compress_tree(_tt(g), _tt(r), gen, kind="int8")
    for path in _paths(g):
        gr = torch.from_numpy(O.tree_get(g, path)) + torch.from_numpy(
            O.tree_get(r, path))
        got = O.tree_get(rec, path)
        assert got.shape == gr.shape, path  # a 1-D leaf keeps its shape
        assert torch.equal(O.tree_get(res, path), gr - got), path
        flat = gr.reshape(-1, gr.shape[-1]) if gr.dim() > 1 else gr[None]
        step = flat.abs().amax(-1, keepdim=True) / 127.0
        assert ((got.reshape(flat.shape) - flat).abs()
                <= step * (1 + 1e-6)).all(), path
    # stochastic rounding is unbiased: the mean reconstruction over many
    # draws approaches the input (the error of a mean of n uniform draws
    # has standard deviation step / sqrt(12 n))
    n = 400
    mean = sum(Cmp.decompress_int8(*Cmp.compress_int8(total, gen))
               for _ in range(n)) / n
    step = total.abs().amax(-1, keepdim=True) / 127.0
    assert ((mean - total).abs() <= 6 * step / np.sqrt(12 * n)).all()
    assert Cmp.ef_ratio("int8") == RCmp.ef_ratio("int8") == 0.25


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches,compression",
                         [(1, "none"), (2, "none"), (1, "bf16"), (2, "bf16")])
def test_train_step_matches_the_reference(qwen, qwen_grads, microbatches,
                                         compression):
    rcfg, pcfg, rparams = qwen
    rstate = RT.init_state(rcfg, rparams, seed=5, compression=compression)
    state = train_state_from_numpy(pcfg, _np(rstate), device=CPU)
    batch = _batch(rcfg.vocab)
    kw = dict(microbatches=microbatches, compression=compression, remat=True)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        adamw=RO.AdamWConfig(lr=LR), compute_dtype=jnp.float32, **kw)))
    step = TS.make_train_step(pcfg, TS.TrainConfig(
        adamw=O.AdamWConfig(lr=LR), compute_dtype=torch.float32, **kw))
    want_state, want = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got_state, got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr", "ce", "z_loss", "tokens"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    assert int(got_state.step) == int(got_state.opt.step) == 1
    assert got_state.rng.dtype == torch.uint32 and got_state.rng.shape == (2,)
    grads = qwen_grads
    n = _assert_adamw_close(got_state.params, _np(want_state.params), grads,
                            LR, "params", grad_err=GRAD_ERR)
    print(f"{n} elements held to the propagated gradient error")
    if compression == "bf16":
        for path in _paths(grads):
            np.testing.assert_allclose(
                O.tree_get(got_state.residual, path).numpy(),
                np.asarray(O.tree_get(want_state.residual, path)),
                rtol=0, atol=2 ** -8 * np.abs(O.tree_get(grads, path)).max())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_state(pcfg, rparams, seed=0):
    return TS.init_state(pcfg, lm_params_from_numpy(pcfg, _np(rparams),
                                                    device=CPU), seed=seed)


def _assert_state_equal(got, want):
    got_leaves, want_leaves = C._leaf_paths(got), C._leaf_paths(want)
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_checkpoint_round_trip_retention_and_uncommitted(qwen, tmp_path):
    rcfg, pcfg, rparams = qwen
    state = _port_state(pcfg, rparams, seed=3)
    mgr = C.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, extras={"step": s}, milestone=s == 1)
    assert mgr.steps() == [1, 3, 4]  # retention keeps the milestone
    restored, extras, step = mgr.restore(None, _port_state(pcfg, rparams))
    assert step == 4 and extras == {"step": 4}
    _assert_state_equal(restored, state)
    assert restored.params["embed"] is not state.params["embed"]
    # a step directory without its marker is garbage from a crashed save
    (tmp_path / "step_000000009" / "arrays").mkdir(parents=True)
    assert mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError, match="not committed"):
        mgr.restore(9, state)


def test_checkpoint_save_async_snapshots_before_the_step(qwen, tmp_path):
    rcfg, pcfg, rparams = qwen
    state = _port_state(pcfg, rparams)
    want = {p: a.clone() for p, a in C._leaf_paths(state).items()}
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_async(7, state)
    # the train step updates its tensors in place after the snapshot
    M._tree_map(lambda _, a: a.add_(1.0), state.params)
    mgr.wait()
    restored, _, step = mgr.restore(None, state)
    assert step == 7
    for path, a in C._leaf_paths(restored).items():
        assert torch.equal(a, want[path]), path


def test_checkpoint_save_after_save_async_of_the_same_step(tmp_path):
    """The launcher saves its last step asynchronously and then at once
    synchronously: the second save waits for the first, so the two never
    rename into one directory together and the later state is kept.  The
    async write is held back until the synchronous one has written (or 2 s
    have passed), the order that keeps the older state where saves race."""
    mgr = C.CheckpointManager(str(tmp_path))
    write, written, calls = mgr._write, threading.Event(), []

    def ordered_write(*args):
        calls.append(args[0])
        if len(calls) == 1:  # the async save's write
            written.wait(timeout=2.0)
            write(*args)
        else:
            write(*args)
            written.set()

    mgr._write = ordered_write
    mgr.save_async(6, {"w": torch.zeros(3)})
    mgr.save(6, {"w": torch.ones(3)}, milestone=True)
    mgr.wait()
    assert calls == [6, 6] and mgr.steps() == [6]
    restored, _, step = mgr.restore(None, {"w": torch.empty(3)})
    assert step == 6 and torch.equal(restored["w"], torch.ones(3))
    with open(tmp_path / "step_000000006" / "MANIFEST.json") as f:
        assert json.load(f)["milestone"]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_checkpoint_crosses_between_the_packages(qwen, tmp_path):
    """A state after one step of each package, written by one and restored
    by the other: params, moments, rng and step bit for bit, in the same
    files under the same paths."""
    rcfg, pcfg, rparams = qwen
    batch = _batch(rcfg.vocab)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        adamw=RO.AdamWConfig(lr=LR), compute_dtype=jnp.float32, remat=False)))
    rstate, _ = rstep(RT.init_state(rcfg, rparams, seed=1),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    RC.CheckpointManager(str(tmp_path / "ref")).save(1, rstate)
    like = _port_state(pcfg, rparams)
    got, _, step = C.CheckpointManager(str(tmp_path / "ref")).restore(None, like)
    assert step == 1
    _assert_state_equal(got, _np(rstate))

    pstep = TS.make_train_step(pcfg, TS.TrainConfig(
        adamw=O.AdamWConfig(lr=LR), compute_dtype=torch.float32, remat=False))
    pstate, _ = pstep(_port_state(pcfg, rparams, seed=2),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    C.CheckpointManager(str(tmp_path / "port")).save(1, pstate)
    rlike = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         rstate)
    back, _, step = RC.CheckpointManager(str(tmp_path / "port")).restore(
        None, rlike)
    assert step == 1
    _assert_state_equal(_np(back), pstate)
    assert (sorted((tmp_path / "ref" / "step_000000001" / "arrays").iterdir())
            and len(list((tmp_path / "port" / "step_000000001" / "arrays")
                         .iterdir()))
            == len(list((tmp_path / "ref" / "step_000000001" / "arrays")
                        .iterdir())))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (7, 3), (123, 99)])
def test_synthetic_batches_equal_the_reference(seed, step):
    for embeds in (False, True):
        want = ref_batch(1000, 3, 17, step, seed=seed, d_model=8, embeds=embeds)
        got = synthetic_lm_batch(1000, 3, 17, step, seed=seed, d_model=8,
                                 embeds=embeds)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


def test_geo_pipeline_plans_match_the_reference():
    kw = dict(vocab=512, batch=2, seq=8, seed=0)
    rplat = ref_tpu_pod_platform(n_pods=2, hosts_per_pod=4,
                                 compute_jitter=0.3, seed=0)
    plat = tpu_pod_platform(n_pods=2, hosts_per_pod=4, compute_jitter=0.3,
                            seed=0)
    want = RefPipeline(rplat, mode="uniform", **kw)
    got = GeoDataPipeline(plat, mode="uniform", **kw)
    np.testing.assert_array_equal(got.plan.x, want.plan.x)
    np.testing.assert_array_equal(got.plan.y, want.plan.y)
    assert got.modeled_ingest_time() == want.modeled_ingest_time()
    # the e2e_push plan is held by its end-to-end makespan, the planner's
    # objective; its push phase alone (``modeled_ingest_time``) is not what
    # the solve pins, and differs between plans of equal makespan
    want = RefPipeline(rplat, mode="e2e_push", **kw)
    got = GeoDataPipeline(plat, mode="e2e_push", **kw)
    np.testing.assert_allclose(
        makespan(plat, got.plan, BARRIERS_ALL_PIPELINED),
        ref_makespan(rplat, want.plan, BARRIERS_ALL_PIPELINED), rtol=1e-3)
    assert 0 < got.modeled_ingest_time() <= makespan(
        plat, got.plan, BARRIERS_ALL_PIPELINED)
    pipe = GeoDataPipeline(plat, mode="uniform", **kw).start(from_step=3)
    try:
        s, b = next(pipe)
    finally:
        pipe.stop()
    assert s == 3
    assert b["tokens"].tobytes() == ref_batch(512, 2, 8, 3, seed=0)[
        "tokens"].tobytes()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _train(tmp_path, *extra, wrap_step=None):
    return launch_train.main([
        "--arch", QWEN, "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq", "16", "--log-every", "1", "--warmup", "1",
        "--seed", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        *extra], wrap_step=wrap_step)


def test_launcher_resumes_from_the_newest_committed_step(qwen, tmp_path,
                                                         capsys):
    """Four steps with checkpoints, then on to six with ``--resume auto``:
    the log lines, the restored state equal to the first run's last one bit
    for bit, and the resumed run's first batch the one of step 4."""
    rcfg = qwen[0]
    first = _train(tmp_path)
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out if line.startswith("step")] == [
        ["step", str(s)] for s in range(1, 5)]
    assert out[-1] == "[train] done"
    restored, extras, step = C.CheckpointManager(str(tmp_path)).restore(
        None, first)
    assert step == 4 and extras == {"arch": rcfg.name}
    _assert_state_equal(restored, first)

    fed = []

    def recording(step_fn):
        def run(state, batch):
            fed.append({k: v.numpy().copy() for k, v in batch.items()})
            return step_fn(state, batch)
        return run

    _train(tmp_path, "--steps", "6", "--resume", "auto", wrap_step=recording)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[resume] restored committed step 4"
    steps = [line for line in out if line.startswith("step")]
    assert [line.split()[1] for line in steps] == ["5", "6"]
    for line in steps:
        fields = dict(f.split("=") for f in line.split()[2:])
        assert sorted(fields) == ["gnorm", "loss", "lr", "tok/s"]
        assert np.isfinite(float(fields["loss"]))
    assert C.CheckpointManager(str(tmp_path)).steps() == [2, 4, 6]
    assert len(fed) == 2
    want = ref_batch(rcfg.vocab, 2, 16, 4, seed=1)
    for k in want:
        assert fed[0][k].tobytes() == want[k].tobytes(), k


def test_launcher_geo_ingest_and_mesh(tmp_path, capsys):
    launch_train.main(["--arch", QWEN, "--reduced", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--geo-ingest", "--compression", "int8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[ingest] planned=") and "myopic-push=" in out[0]
    assert out[1].startswith("step     1 loss=")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        launch_train.main(["--arch", QWEN, "--reduced", "--device", "cpu",
                           "--mesh", "2x2"])
