"""The port's tensor-parallel mesh layout against the reference.

On a mesh every dense layer runs on this rank's ``"model"`` shard of its
weights, with ``column_in``/``row_out`` at the column- and row-parallel
edges, the embedding and the logits vocab parallel, and the parameters
gathered over ``"data"`` one group at a time.  The cases:

* each mixer family, the MLP and the vocab-parallel embedding + loss on
  ``(data 2, model 2)`` and ``(model 4)`` meshes, with the reference's
  parameters carried across by ``convert.py``, against the reference's
  function on one device (jax, CPU) at atol 1e-5 × the largest entry;
* ``ServeEngine(mesh=)`` against one device (the same greedy tokens, local
  cache leaves);
* three train steps of reduced Falcon-Mamba, RecurrentGemma and
  Granite-MoE on a 2×2 mesh against one device;
* the dry run of reduced qwen3 ``train_4k`` on a fake 2×4 world: no dense
  work repeated, the gathers per group, flops near the reference's.

Worlds are gloo processes as in ``tests/test_torch_multidevice.py`` (whose
``run_world`` and ``run_fake`` they use).
"""
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

from test_torch_multidevice import _ROOT, run_fake, run_world  # noqa: E402

CPU = torch.device("cpu")
#: the layer cases' bar: atol 1e-5 of the largest entry of the reference
LAYER_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_config(name, tp, **changes):
    """The reference's reduced config of ``name`` with ``changes``, padded
    for ``tp`` by its ``padded_for_tp`` (the world pads the port's alike)."""
    import dataclasses

    from repro.configs import ARCHS as RA
    from repro.configs import padded_for_tp as ref_padded

    return ref_padded(dataclasses.replace(RA[name].reduced(), **changes), tp)


#: the layer cases: (key, arch, config changes, the block of group 0 they
#: read); the attention case has 8 query heads on 1 kv head, which padding
#: for 4 ranks repeats to 4 kv heads (GQA, 2 query heads a kv head)
LAYER_CASES = (
    ("attention", "qwen3-1.7b", dict(n_heads=8, n_kv_heads=1, head_dim=8),
     ("groups", "blk0", "mixer")),
    ("mlp", "qwen3-1.7b", {}, ("groups", "blk0", "ffn")),
    ("mamba", "falcon-mamba-7b", {}, ("groups", "blk0", "mixer")),
    ("rglru", "recurrentgemma-9b", {}, ("groups", "blk0", "mixer")),
)


def _reference_layer(key, rcfg, p, x):
    from repro.models import layers as RL

    if key == "attention":
        positions = jnp.broadcast_to(jnp.arange(x.shape[1])[None],
                                     x.shape[:2])
        return RL.attention_fwd(rcfg, rcfg.pattern[0], p, x, positions)[0]
    if key == "mlp":
        return RL.mlp_fwd(rcfg, p, x)
    if key == "mamba":
        return RL.mamba_fwd(rcfg, p, x)[0]
    return RL.rglru_fwd(rcfg, p, x)[0]


def test_layers_and_vocab_parallel_loss_match_the_reference(tmp_path):
    """Each mixer family, the MLP, and the vocab-parallel embedding, logits
    and ``loss_fn`` of reduced qwen3, on a ``(data 2, model 2)`` and a
    ``(model 4)`` mesh of one gloo world: every rank's output (its rows,
    the logits assembled over ``"model"``) against the reference's
    function on one device in float32, at atol 1e-5 of the largest entry;
    the mean of the ranks' losses against the reference's loss likewise.
    Configs are padded for 4 ranks, so one set of weights serves both
    meshes."""
    from repro.models import model as RM

    rng = np.random.default_rng(23)
    want = {}
    for key, arch, changes, _ in LAYER_CASES:
        rcfg = _reference_config(arch, 4, **changes)
        rp = RM.init(rcfg, jax.random.PRNGKey(3), tp=4)
        np.savez(tmp_path / f"{key}_params.npz",
                 **{"/".join(map(str, k)): v for k, v in
                    _flat(_np_tree(rp)).items()})
        x = rng.standard_normal((4, 16, rcfg.d_model)).astype(np.float32)
        np.save(tmp_path / f"{key}_x.npy", x)
        p0 = jax.tree.map(lambda a: a[0], rp["groups"]["blk0"])
        sub = p0["mixer"] if key != "mlp" else p0["ffn"]
        want[key] = np.asarray(_reference_layer(key, rcfg, sub,
                                                jnp.asarray(x)))
    rcfg = _reference_config("qwen3-1.7b", 4)
    rp = RM.init(rcfg, jax.random.PRNGKey(4), tp=4)
    np.savez(tmp_path / "lm_params.npz", **{"/".join(map(str, k)): v for k, v
                                            in _flat(_np_tree(rp)).items()})
    toks = rng.integers(0, rcfg.vocab, size=(4, 17))
    np.save(tmp_path / "lm_tokens.npy", toks)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    want["logits"] = np.asarray(RM.forward(rcfg, rp, batch)[0])
    want["loss"] = float(RM.loss_fn(rcfg, rp, batch)[0])

    run_world(tmp_path, f"""
        import dataclasses
        from repro_torch.configs import ARCHS, padded_for_tp
        from repro_torch.convert import lm_params_from_numpy
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        from repro_torch.models.sharding import (DEFAULT_RULES, assemble,
                                                 axis_rules, mean_over)
        join()
        def tree(path):
            z = np.load(path)
            out = {{}}
            for k in z.files:
                *head, leaf = k.split("/")
                d = out
                for h in head:
                    d = d.setdefault(h, {{}})
                d[leaf] = z[k]
            return out
        def cfg_of(arch, **changes):
            return padded_for_tp(dataclasses.replace(ARCHS[arch].reduced(),
                                                     **changes), 4)
        meshes = {{"2x2": make_mesh((2, 2), ("data", "model"), "cpu"),
                  "m4": make_mesh((4,), ("model",), "cpu")}}
        for label, mesh in meshes.items():
            nb = 2 if "data" in mesh.mesh_dim_names else 1
            d = mesh.get_local_rank("data") if nb > 1 else 0
            rows = slice(d * 4 // nb, (d + 1) * 4 // nb)
            for key, arch, changes, where in {LAYER_CASES!r}:
                cfg = cfg_of(arch, **changes)
                full = lm_params_from_numpy(cfg, tree(f"{{key}}_params.npz"),
                                            device="cpu")
                with axis_rules(mesh, DEFAULT_RULES):
                    placed = M.place_params(cfg, full, mesh)
                local, plans = M._at_rest(placed, mesh)
                for k in where:
                    local, plans = local[k], plans[k]
                p = M._gathered(M._tree_map(lambda _, a: a[0], local), plans,
                                mesh)
                x = torch.from_numpy(np.load(f"{{key}}_x.npy"))[rows]
                if key == "attention":
                    pos = torch.arange(x.shape[1])[None].expand(x.shape[:2])
                    y = L.attention_fwd(cfg, cfg.pattern[0], p, x, pos,
                                        mesh=mesh)[0]
                elif key == "mlp":
                    y = L.mlp_fwd(cfg, p, x, mesh=mesh)
                elif key == "mamba":
                    y = L.mamba_fwd(cfg, p, x, mesh=mesh)[0]
                else:
                    y = L.rglru_fwd(cfg, p, x, mesh=mesh)[0]
                np.save(f"{{label}}_{{key}}_{{RANK}}.npy", y.numpy())
            cfg = cfg_of("qwen3-1.7b")
            full = lm_params_from_numpy(cfg, tree("lm_params.npz"),
                                        device="cpu")
            with axis_rules(mesh, DEFAULT_RULES):
                placed = M.place_params(cfg, full, mesh)
            toks = torch.from_numpy(np.load("lm_tokens.npy"))[rows]
            batch = {{"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
            logits = M.forward(cfg, placed, batch, mesh=mesh)[0]
            tp = mesh.size(mesh.mesh_dim_names.index("model"))
            assert logits.shape[-1] == cfg.vocab // tp
            logits = assemble(logits, mesh, ("model",), 2)
            np.save(f"{{label}}_logits_{{RANK}}.npy", logits.numpy())
            loss = M.loss_fn(cfg, placed, batch, mesh=mesh)[0]
            if nb > 1:
                loss = mean_over(loss, mesh, ("data",))
            json.dump(float(loss), open(f"{{label}}_loss_{{RANK}}.json", "w"))
        dist.destroy_process_group()
    """)
    for label, nb in (("2x2", 2), ("m4", 1)):
        for r in range(4):
            d = r // 2 if nb > 1 else 0
            rows = slice(d * 4 // nb, (d + 1) * 4 // nb)
            for key in [c[0] for c in LAYER_CASES] + ["logits"]:
                w = want[key][rows]
                got = np.load(tmp_path / f"{label}_{key}_{r}.npy")
                np.testing.assert_allclose(
                    got, w, rtol=0, atol=LAYER_ATOL * float(np.abs(w).max()),
                    err_msg=f"{label} rank {r} {key}")
            loss = json.load(open(tmp_path / f"{label}_loss_{r}.json"))
            np.testing.assert_allclose(loss, want["loss"], rtol=0,
                                       atol=LAYER_ATOL * abs(want["loss"]))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# ServeEngine(mesh=)
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "recurrentgemma-9b")
SERVE_PROMPTS = (9, 5)
NEW_TOKENS = 4  # the prefill's token and 3 decode steps


def _serve_one_device(cfg, params):
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=32,
                                               use_kernels=False),
                      device=CPU)
    rng = np.random.default_rng(5)
    for i, n in enumerate(SERVE_PROMPTS):
        eng.submit(Request(i, rng.integers(0, cfg.vocab, size=n),
                           NEW_TOKENS))
    return {r.rid: r.output for r in eng.run()}


def test_serve_engine_on_a_mesh_matches_one_device(tmp_path):
    """``ServeEngine(mesh=)`` on a ``(data 2, model 2)`` mesh (one slot a
    data rank, parameters placed by ``DEFAULT_RULES``) serves two requests
    (the prefill's token and three decode steps) of reduced qwen3,
    Falcon-Mamba and RecurrentGemma (its one kv head padded to 2 on both
    sides) with the greedy tokens of one device, on every rank; each
    rank's cache holds its one slot and its half of the kv heads and of
    the Mamba/RG-LRU channels."""
    from repro_torch.configs import ARCHS, padded_for_tp
    from repro_torch.models import model as M

    want = {}
    for arch in SERVE_ARCHS:
        cfg = padded_for_tp(ARCHS[arch].reduced(), 2)
        params = M.init(cfg, torch.Generator().manual_seed(7), device=CPU,
                        tp=2)
        want[arch] = _serve_one_device(cfg, params)
    run_world(tmp_path, f"""
        from repro_torch.configs import ARCHS, padded_for_tp
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import model as M
        from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
        join()
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        out = {{}}
        for arch in {SERVE_ARCHS!r}:
            cfg = padded_for_tp(ARCHS[arch].reduced(), 2)
            params = M.init(cfg, torch.Generator().manual_seed(7),
                            device="cpu", tp=2)
            eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=32,
                                                       use_kernels=False),
                              device="cpu", mesh=mesh)
            rng = np.random.default_rng(5)
            for i, n in enumerate({SERVE_PROMPTS!r}):
                eng.submit(Request(i, rng.integers(0, cfg.vocab, size=n),
                                   {NEW_TOKENS}))
            tokens = {{r.rid: r.output for r in eng.run()}}
            shapes = {{}}
            M._tree_map(lambda path, a: shapes.__setitem__("/".join(path),
                                                           list(a.shape)),
                        eng.cache)
            out[arch] = {{"tokens": tokens, "cache": shapes}}
        json.dump(out, open(f"serve{{RANK}}.json", "w"))
        dist.destroy_process_group()
    """)
    from repro_torch.configs import ARCHS, padded_for_tp

    for r in range(4):
        got = json.load(open(tmp_path / f"serve{r}.json"))
        for arch in SERVE_ARCHS:
            cfg = padded_for_tp(ARCHS[arch].reduced(), 2)
            tokens = {int(k): v for k, v in got[arch]["tokens"].items()}
            assert tokens == want[arch], (r, arch)
            whole = M.init_cache(cfg, 2, 32, dtype=torch.float32,
                                 device="meta")
            for path, shape in got[arch]["cache"].items():
                leaf = whole
                for k in path.split("/"):
                    leaf = leaf[k]
                expect = list(leaf.shape)
                slot = 0 if path.startswith("tail/") else 1
                expect[slot] //= 2  # one slot a data rank
                # half the kv heads (k, v: (B, Hkv, S, Dh)), of the Mamba
                # channels (h: (B, Di, Ds)) or of the conv's and the RG-LRU
                # state's channels (their last dim)
                name = path.split("/")[-1]
                split = (slot + 1 if name in ("k", "v") or
                         (name == "h" and len(expect) - slot == 3) else -1)
                expect[split] //= 2
                assert shape == expect, (r, arch, path, shape, expect)


# ---------------------------------------------------------------------------
# train steps on a 2×2 mesh
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "granite-moe-3b-a800m")
TRAIN_STEPS = 3

_TRAIN = """
import dataclasses
from repro_torch.configs import ARCHS, padded_for_tp
from repro_torch.models import model as M
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
tcfg = TrainConfig(compute_dtype=torch.float32, remat=True)
def setup(arch):
    cfg = padded_for_tp(dataclasses.replace(ARCHS[arch].reduced(),
                                            capacity_factor=8.0), 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    state = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(0),
                                   device="cpu", tp=2))
    return cfg, batch, state
"""


def _one_device(scope, arch):
    """(losses and gradient norms, the final parameters) of the one-device
    run of ``arch``."""
    cfg, batch, state = scope["setup"](arch)
    step = scope["make_train_step"](cfg, scope["tcfg"])
    out = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        out.append([float(metrics["loss"]), float(metrics["grad_norm"])])
    return out, state.params


def test_train_steps_on_a_mesh_match_one_device(tmp_path):
    """Three float32 AdamW steps (remat on: every group's gathers run again
    in the recompute) of reduced Falcon-Mamba, RecurrentGemma and
    Granite-MoE (capacity factor 8: no token dropped) on a 2×2 mesh, tensor
    parallel over ``model``: the losses and gradient norms (before
    clipping) of one device to 1e-5 relative, each step's averaged
    gradient within 1e-5 of each leaf's largest entry of one device's, and
    the parameters of one device that takes the mesh's gradients (a
    replay) to 1e-5 of each leaf's largest entry.  The plain runs'
    parameters are not compared: AdamW scales a clipped gradient at the
    float32 noise level (RecurrentGemma: a gradient of 3e-7, clipped 34×,
    against eps 1e-8) to an update of lr's size, so the float32 rounding
    of any reordering of the sums, a tensor-parallel split or a
    permutation of channels on one device alike, moves such an element by
    more than the bar."""
    from test_torch_multidevice import _RECORD, assert_leaves_close, replaying

    scope = {"torch": torch, "np": np}
    exec(_TRAIN, scope)
    want = {arch: _one_device(scope, arch) for arch in TRAIN_ARCHS}
    run_world(tmp_path, _TRAIN + _RECORD + f"""
record("adamw_update", 2)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train.train_step import place_state, state_shardings
join()
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
out = {{}}
for arch in {TRAIN_ARCHS!r}:
    RECORD["tag"] = arch
    cfg, batch, state = setup(arch)
    with axis_rules(mesh, DEFAULT_RULES):
        state = place_state(state, state_shardings(cfg, state, mesh))
        step = make_train_step(cfg, tcfg, mesh=mesh)
        losses = []
        for _ in range({TRAIN_STEPS}):
            state, metrics = step(state, batch)
            losses.append([float(metrics["loss"]),
                           float(metrics["grad_norm"].full_tensor())])
    final = {{}}
    M._tree_map(lambda path, a: final.__setitem__(
        "/".join(path), a.full_tensor().numpy()), state.params)
    if RANK == 0:
        np.savez(f"final_{{arch}}.npz", **final)
    out[arch] = losses
json.dump(out, open(f"losses{{RANK}}.json", "w"))
dist.destroy_process_group()
""")
    for r in range(4):
        got = json.load(open(tmp_path / f"losses{r}.json"))
        for arch in TRAIN_ARCHS:
            np.testing.assert_allclose(got[arch], want[arch][0], rtol=1e-5,
                                       err_msg=f"rank {r} {arch}")
    for arch in TRAIN_ARCHS:
        def recorded(t, arch=arch):
            return np.load(tmp_path / f"{arch}adamw_update_{t}.npz")
        with replaying("adamw_update", 2, recorded) as own:
            _, params = _one_device(scope, arch)
        assert len(own) == TRAIN_STEPS
        for t, grads in enumerate(own):
            assert_leaves_close(recorded(t), grads, f"{arch} step {t}")
        assert_leaves_close(dict(np.load(tmp_path / f"final_{arch}.npz")),
                            params, f"{arch} replayed parameters")


# ---------------------------------------------------------------------------
# the dry run of the layout
# ---------------------------------------------------------------------------

def _reference_flops(arch, shape) -> float:
    """The reference's flops a device of the reduced cell on a 2×4 mesh of
    8 XLA host devices (a process of its own, as
    ``tests/test_multidevice.py`` runs it): ``hlo_flops_per_device`` plus
    the chunked attention's matmuls, which its analysis build leaves in
    rolled scans that XLA counts once and which the reference adds
    analytically (``attn_flops_total`` over the devices)."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json
        from repro.launch.dryrun import run_cell
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        rep = run_cell({arch!r}, {shape!r}, multi_pod=False, mesh=mesh,
                       reduced=True)
        print("FLOPS", json.dumps(rep["hlo_flops_per_device"]
                                  + rep["attn_flops_total"] / 8))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return float(proc.stdout.split("FLOPS", 1)[1].split()[0])


def test_dryrun_layout_splits_the_dense_work(tmp_path):
    """Reduced qwen3 ``train_4k`` as the dry run traces it on a fake 2×4
    world: its flops a device times 8 lie within 10% of the 1×1 trace of
    the same global batch (no dense work repeated on the ``"model"``
    ranks; the 2×4 config pads 2 kv heads to 4), its bytes a device within
    10% of the 1×1 trace's over 8, and its flops at most 1.25× the
    reference's on the same reduced cell and mesh (``hlo_flops_per_device``
    with the attention the reference adds analytically; XLA also counts
    elementwise ops).  The gathers are per group: the
    largest all-gather is one leaf's, and a 16-layer cut at an 8 × 64
    batch, where the parameters and not the activations fill the card,
    peaks below its whole float32 parameter tree plus moments, and
    allocates less than the whole float32 tree above its arguments (a
    step that gathered the whole tree allocated that much at once)."""
    out = run_fake(tmp_path, """
        import dataclasses
        from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, get_config,
                                         padded_for_tp)
        from repro_torch.launch.dryrun import run_cell
        SHAPES["train_tiny"] = ShapeSpec("train_tiny", 64, 8, "train")
        ARCHS["qwen3-deep"] = dataclasses.replace(
            get_config("qwen3-1.7b").reduced(), n_layers=16)
        reps = {}
        for label, arch, shape, mesh, reduced in (
                ("2x4", "qwen3-1.7b", "train_4k", (2, 4), True),
                ("1x1", "qwen3-1.7b", "train_4k", (1, 1), True),
                ("deep", "qwen3-deep", "train_tiny", (2, 4), False)):
            r = run_cell(arch, shape, False, mesh=(mesh, ("data", "model")),
                         reduced=reduced, device="cpu")
            reps[label] = {
                "flops": r["flops_per_device"],
                "bytes": r["per_device_bytes"],
                "arguments": r["argument_size_in_bytes"],
                "collectives": r["collectives_per_device_bytes"]["total"],
                "largest_gather": max(c[1] for c in r["collectives"]
                                      if c[0] == "all-gather")
                if mesh != (1, 1) else 0}
        deep = padded_for_tp(ARCHS["qwen3-deep"], 4)
        leaf = max(deep.vocab * deep.d_model, deep.d_model * deep.d_ff,
                   deep.d_model * deep.n_heads * deep.head_dim_)
        print("REPORT", json.dumps(dict(reps, n_params=deep.n_params(),
                                        leaf=leaf)))
    """)
    line = next(v for v in out.splitlines() if v.startswith("REPORT"))
    reps = json.loads(line.split("REPORT", 1)[1])
    split, whole = reps["2x4"], reps["1x1"]
    assert abs(8 * split["flops"] - whole["flops"]) <= 0.10 * whole["flops"]
    assert abs(8 * split["bytes"] - whole["bytes"]) <= 0.10 * whole["bytes"]
    assert split["collectives"] > 0
    deep, tree = reps["deep"], 4 * reps["n_params"]
    assert deep["largest_gather"] <= 4 * reps["leaf"] // 4, deep
    assert deep["bytes"] < 3 * tree, (deep, tree)
    assert deep["bytes"] - deep["arguments"] < tree, (deep, tree)
    reference = _reference_flops("qwen3-1.7b", "train_4k")
    assert split["flops"] <= 1.25 * reference, (split["flops"], reference)
