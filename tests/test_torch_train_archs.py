"""Training the three block families of ``chip_smoke.py`` phase 21 through
the port, on the CPU: the MoE FFN (Granite-MoE-3B-A800M), the Mamba block
(Falcon-Mamba-7B) and the RG-LRU and local-attention blocks
(RecurrentGemma-9B), each at its reduced config.

* the AdamW ``make_train_step`` for 3 steps against the reference's, on
  the same batches (``synthetic_lm_batch``), each step from the
  reference's state before it carried across with
  ``train_state_from_numpy`` (the first: its ``init_state`` of the port's
  seeded init): each step's loss, grad norm and lr to rtol 1e-5, and the
  parameters after it to the AdamW bar of
  ``tests/test_torch_train.py::test_train_step_matches_the_reference``
  (rtol 1e-6 plus atol 1e-6 · lr, and where the gradients' own float error
  moves an element further through AdamW's moments, that error
  propagated; such elements under 1% at the first step), Falcon-Mamba also
  under remat, as phase 21b trains it;
* the port's training launcher's argparse defaults equal the reference
  launcher's for every flag the two share;
* phase 21 rehearsed on the reduced configs (launcher, checks and the
  float32 cuts; the "card" is the CPU), and 21d's rule for a routing
  choice that differs between the two sides: the CPU run's choices pinned
  on both;
* phase 21's reckoning (``chip_smoke.train_bytes``): under the card at
  phase 21's depths, over it at Falcon-Mamba's and RecurrentGemma's full
  depth, and its kept activations (``TRAIN_KEPT``) those a trace of the
  port's forward on meta stand-ins counts.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as ref_launcher  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batch  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import optim as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
GRANITE, FMAMBA, RGEMMA = ("granite-moe-3b-a800m", "falcon-mamba-7b",
                           "recurrentgemma-9b")
#: the AdamW bar's numbers, as tests/test_torch_train.py states them: lr,
#: the metrics' rtol, and a gradient leaf's float error relative to its
#: largest entry (the archs differ from the reference by at most 8e-6 of it
#: in tests/test_torch_arch_smoke.py)
LR, RTOL, GRAD_ERR = 1e-2, 1e-5, 1e-5
STEPS, B, T = 3, 4, 32


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """One torch thread (other workers run beside this one); the data
    pipeline plans on the process default device."""
    threads, before = torch.get_num_threads(), repro_torch.default_device()
    torch.set_num_threads(1)
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device(before)
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def _carried(grads, opt, lr):
    """By leaf, the first-order bound on how far the gradients' own float
    error (``GRAD_ERR`` of each leaf's largest entry, after clipping to 1)
    moves the parameters in one AdamW step from the moments ``opt`` (the
    reference's, before the step): the update ``u = m̂ / (√v̂ + eps)``
    moves by at most ``|dm̂| / (√v̂ + eps) + |m̂| |dv̂| / (2 √v̂ (√v̂ +
    eps)²)``, capped at 2 (an update's size), times lr.  At the first step
    this is ``tests/test_torch_train.py``'s ``lr · eps · err / (|g| +
    eps)²``."""
    cfg = O.AdamWConfig()
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    t = int(np.asarray(opt.step)) + 1
    scale = min(1.0, 1.0 / float(np.sqrt(sum(
        np.sum(np.square(np.asarray(O.tree_get(grads, p), np.float64)))
        for p in _paths(grads)))))
    out = {}
    for path in _paths(grads):
        g = scale * np.asarray(O.tree_get(grads, path), np.float64)
        err = GRAD_ERR * np.abs(g).max()
        m = (b1 * np.asarray(O.tree_get(opt.m, path), np.float64)
             + (1 - b1) * g) / (1 - b1 ** t)
        root = np.sqrt((b2 * np.asarray(O.tree_get(opt.v, path), np.float64)
                        + (1 - b2) * g * g) / (1 - b2 ** t))
        dm = (1 - b1) * err / (1 - b1 ** t)
        dv = (1 - b2) * 2 * np.abs(g) * err / (1 - b2 ** t)
        du = (dm / (root + eps) + np.abs(m) * dv
              / (2 * np.maximum(root, eps) * (root + eps) ** 2))
        out[path] = lr * np.minimum(du, 2.0)
    return out


def _assert_adamw_close(got, want, grads, opt, lr, label):
    """``tests/test_torch_train.py``'s AdamW bar for one step: rtol 1e-6
    plus atol 1e-6 · lr; where the gradients' own float error moves an
    element further, that error propagated (``_carried``).  At the first
    step, whose update is ``g / (|g| + eps)``, fewer than 1% of the
    elements may need it (there only where |g| is near eps); later the
    moments carry every small gradient's error into ``m̂ / √v̂`` (1.3% of
    RecurrentGemma's elements at its second step, each within 0.37 of its
    bound), so the count is returned, not bounded."""
    carried = _carried(grads, opt, lr)
    n_sensitive, n = 0, 0
    for path in _paths(want):
        w = np.asarray(O.tree_get(want, path))
        g = O.tree_get(got, path).detach().numpy()
        err = np.abs(g - w)
        plain = 1e-6 * np.abs(w) + 1e-6 * lr
        ok = err <= plain + carried[path]
        assert ok.all(), (label, "/".join(path), err[~ok].max())
        n_sensitive += int((err > plain).sum())
        n += w.size
    assert int(np.asarray(opt.step)) > 0 or n_sensitive < 0.01 * n, (
        label, n_sensitive, n)
    return n_sensitive


@pytest.mark.parametrize("name,remat", [(GRANITE, False), (FMAMBA, False),
                                        (FMAMBA, True), (RGEMMA, False)],
                         ids=["granite", "falcon-mamba", "falcon-mamba-remat",
                              "recurrentgemma"])
def test_three_adamw_steps_match_the_reference(name, remat):
    """Three steps on three batches, each from the reference's state before
    it (carried across, so that each is held to the one-step bar: a free
    run would compare the second step from parameters that already differ
    where |g| was near eps, by up to 2 · lr)."""
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    # the port's seeded init, given to both packages
    tree = M._tree_map(lambda _, a: a.numpy(), M.init(
        pcfg, torch.Generator().manual_seed(0), device=CPU))
    rstate = RT.init_state(rcfg, jax.tree.map(jnp.asarray, tree), seed=5)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        adamw=RO.AdamWConfig(lr=LR), compute_dtype=jnp.float32, remat=remat)))
    step = TS.make_train_step(pcfg, TS.TrainConfig(
        adamw=O.AdamWConfig(lr=LR), compute_dtype=torch.float32, remat=remat))
    for s in range(STEPS):
        before = _np(rstate)
        state = train_state_from_numpy(pcfg, before, device=CPU)
        batch = {k: torch.from_numpy(v) for k, v in synthetic_lm_batch(
            rcfg.vocab, B, T, s, seed=7).items()}
        grads = _grads(pcfg, state.params, batch)
        rstate, want = rstep(rstate, {k: jnp.asarray(v.numpy())
                                      for k, v in batch.items()})
        state, got = step(state, batch)
        for key in ("loss", "grad_norm", "lr", "ce", "z_loss", "aux"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {s + 1} {key}")
        assert int(state.step) == int(state.opt.step) == s + 1
        n = _assert_adamw_close(state.params, _np(rstate.params), grads,
                                before.opt, LR, f"{name} step {s + 1}")
        print(f"step {s + 1}: {n} elements held to the propagated gradient "
              "error")


def _grads(cfg, params, batch):
    """The gradients of the port's float32 loss at ``params``, as numpy
    arrays (zeros where the loss does not reach): the sizes ``_carried``
    propagates a gradient's float error through."""
    leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(cfg, leaves, batch, compute_dtype=torch.float32)
    flat = list(O.tree_leaves(leaves))
    found = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    return M._tree_map(
        lambda _, a: np.zeros(a.shape, np.float32) if (g := next(found)) is None
        else g.numpy(), leaves)


class _Parsed(Exception):
    pass


_PARSE = argparse.ArgumentParser.parse_args


def _defaults(main, monkeypatch):
    """The namespace ``main(["--arch", ...])`` parses, read before it runs
    anything else."""
    seen = {}

    def parse(self, args=None, namespace=None):
        seen.update(vars(_PARSE(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed):
        main(["--arch", GRANITE])
    return seen


def test_launch_train_defaults_match_the_reference_launcher(monkeypatch):
    """Every flag both launchers take has the same default: ``--batch 8
    --seq 128 --lr 3e-4 --warmup 20``, float32, no remat; the port adds
    only ``--device`` and ``--init-method``."""
    want = _defaults(ref_launcher.main, monkeypatch)
    got = _defaults(launcher.main, monkeypatch)
    assert set(got) - set(want) == {"device", "init_method"}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert (want["batch"], want["seq"], want["lr"], want["warmup"],
            want["dtype"], want["remat"]) == (8, 128, 3e-4, 20, "float32",
                                              False)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 21 on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def C():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("index", range(3), ids=["21a", "21b", "21c"])
def test_phase_21_rehearses_on_the_cpu(C, index):
    """Each arch's launcher run (8 AdamW steps of 2 x 32 tokens on the
    reduced config: finite losses that fall, no kernel launched) and its
    float32 cut (the "card" the CPU: loss and gradients equal), through
    ``phase_train_archs``."""
    spec = C.TRAIN_ARCHS[index]
    out = C.phase_train_archs(CPU, archs=(spec,), reduced=True, steps=8,
                              batch=2, seq=32)[spec.phase]
    assert out["arch"] == spec.arch
    assert out["depth"] == ARCHS[spec.arch].reduced().n_layers
    losses = out["losses"]
    assert len(losses) == 8 and (losses[-1] + losses[-2]) / 2 < losses[0]
    assert out["cut_worst"] == 0.0
    assert out["cut_flips"] == (0 if spec.arch == GRANITE else None)


def test_phase_21d_pins_the_cpu_routing_where_a_choice_flips(C, monkeypatch):
    """Where the two sides route a token differently (made here by the
    first run's router taking other experts), 21d counts the flips and
    holds loss and gradients with the CPU run's choices pinned on both."""
    from repro_torch.models import layers as L

    real, calls = L.route, []

    def route(cfg, p, x2d):
        gates_all, top_gates, top_ids = real(cfg, p, x2d)
        calls.append(len(calls))
        if len(calls) <= 2:  # the "card" run's two MoE layers
            top_ids = (top_ids + 1) % cfg.n_experts
        return gates_all, top_gates, top_ids

    monkeypatch.setattr(L, "route", route)
    cfg = ARCHS[GRANITE].reduced()
    worst, flips = C.phase_training_float32_cut(
        CPU, depth=2, seq=32, phase="21d", cfg=cfg)
    assert flips == 2 * 32
    assert worst == 0.0
    assert len(calls) == 8  # card, CPU, then both pinned


def test_phase_21_reckoning(C):
    """Phase 21's depths reckon under the card; Falcon-Mamba and
    RecurrentGemma at full depth do not (their state alone is 116 and 153
    GB), and Falcon-Mamba at 24 layers does not without remat."""
    for spec in C.TRAIN_ARCHS:
        cfg = C.card_arch_config(spec)
        got = C.train_bytes(spec.arch, cfg, 8, 128, spec.remat)
        assert got["total"] < C.CARD_BYTES, (spec.arch, got)
        assert got["state"] == 16 * got["parameters"]
        full = get_config(spec.arch)
        over = C.train_bytes(spec.arch, full, 8, 128, spec.remat)
        assert (over["total"] > C.CARD_BYTES) == (spec.arch != GRANITE)
    assert C.card_arch_config(C.TRAIN_ARCHS[0]).n_layers == 32
    mamba = C.card_arch_config(C.TRAIN_ARCHS[1])
    assert C.train_bytes(FMAMBA, mamba, 8, 128, False)["total"] > C.CARD_BYTES


def _kept(cfg, tokens=(8, 128)):
    """Bytes that the port's float32 forward leaves alive for the backward
    pass, beyond the parameters, traced on meta stand-ins."""
    from repro_torch.launch.dryrun import DeviceCounter, meta_params

    counter = DeviceCounter("meta")
    params = meta_params(cfg)
    batch = {k: torch.empty(tokens, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with counter:
        before = counter.arguments(params, batch)
        leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), params)
        loss, _ = M.loss_fn(cfg, leaves, batch, compute_dtype=torch.float32)
        kept = counter.live - before
    del loss
    return kept


@pytest.mark.parametrize("name", [GRANITE, FMAMBA, RGEMMA])
def test_train_kept_is_what_a_trace_keeps(C, name):
    """``TRAIN_KEPT``: a group's kept bytes a token are the difference the
    second group makes to a trace at full width and 8 x 128 tokens, the
    tail's what the tail adds to two groups, each rounded up to a whole
    byte a token."""
    full = get_config(name)
    one, two = (dataclasses.replace(full, n_layers=g * len(full.pattern),
                                    tail=()) for g in (1, 2))
    per_group, per_tail = C.TRAIN_KEPT[name]
    tokens = 8 * 128

    def rounded_up(traced):
        return 0 <= per_token * tokens - traced < tokens

    per_token = per_group
    assert rounded_up(_kept(two) - _kept(one))
    if full.tail:
        with_tail = dataclasses.replace(full, n_layers=2 * len(full.pattern)
                                        + len(full.tail))
        per_token = per_tail
        assert rounded_up(_kept(with_tail) - _kept(two))
    else:
        assert per_tail == 0


def test_rglru_scan_gradient_is_finite_where_a_gate_rounds_to_one():
    """A float32 RG-LRU gate ``sigmoid(z)`` rounds to 1 past z ≈ 16.6 (at
    RecurrentGemma's full width a few in a million: 21c's first step on
    the card had a NaN grad norm).  There ``sqrt(1 - a²)``'s gradient is
    infinite and the gate's own 0: the plain scan's gradient through the
    gate is 0, its limit, where the reference's is NaN, and the
    reference's wherever that is finite; the values are the reference's."""
    from repro.kernels.ref import rglru_scan_ref as ref_scan
    from repro_torch.kernels.ref import rglru_scan_ref

    rng = np.random.default_rng(0)
    z = np.tile(np.array([2.0, -3.0, 17.0, 20.0, 90.0, 120.0], np.float32),
                (2, 5, 1))
    x = rng.standard_normal(z.shape).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_()
    h, hT = rglru_scan_ref(torch.from_numpy(x), torch.sigmoid(zt))
    (h.sum() + hT.sum()).backward()

    def ref_loss(zz):
        out, last = ref_scan(jnp.asarray(x), jax.nn.sigmoid(zz))
        return out.sum() + last.sum()

    want_h = np.asarray(ref_scan(jnp.asarray(x), jax.nn.sigmoid(z))[0])
    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(z)))
    np.testing.assert_allclose(h.detach().numpy(), want_h, rtol=1e-6,
                               atol=1e-6)
    got = zt.grad.numpy()
    saturated = torch.sigmoid(torch.from_numpy(z)).numpy() == 1.0
    assert saturated[..., 2:].all() and not saturated[..., :2].any()
    assert np.isfinite(got).all()
    assert (got[saturated] == 0).all()
    assert np.isnan(want[saturated]).all()
    np.testing.assert_allclose(got[~saturated], want[~saturated], rtol=1e-5,
                               atol=1e-6)
