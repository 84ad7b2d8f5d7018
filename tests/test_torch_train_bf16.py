"""The port's bfloat16 training path against the reference's, on the CPU.

The card trains with ``compute_dtype=bfloat16`` and remat on: float32
master parameters cast to bfloat16 inside the graph, group by group, the
embedding and the tied unembedding in bfloat16, ``final_norm`` in float32.
This file holds that path to the reference's ``compute_dtype=bfloat16,
remat=True`` on the same parameters (the reference's ``init``, carried
across with ``repro_torch.convert``) and the same tokens (a numpy seed):
``loss_fn`` and every gradient leaf for the reduced qwen3 and the reduced
Granite-MoE, and one ``make_train_step`` for qwen3.

Bars, from bfloat16's rounding (``BF16_EPS`` = 2^-8 relative) and the
reduced models' 2 layers of about 6 rounded operations (``ROUNDED_OPS``),
as ``tests/test_torch_bf16.py`` derives them for the logits:

* the loss, a float32 mean of terms read from bfloat16 logits: rtol 2^-8;
* each gradient leaf: atol ``ROUNDED_OPS · 2^-8`` of the leaf's largest
  entry (a leaf's gradient is read from activations and cotangents that
  carry the same rounded operations); a leaf the port's loss does not
  reach is zero in the reference;
* a witness that the port's gradients are bfloat16's: nearer the
  reference's bfloat16 gradients than its float32 ones, over all leaves;
* the train step: loss rtol 2^-8, grad norm rtol ``ROUNDED_OPS · 2^-8``,
  lr equal; AdamW's first update is ``lr · g / (|g| + eps)``, the sign of
  the gradient, so a parameter is held to the float32 step's bar where
  its gradient is larger than that gradient bar, and within ``2 · lr``
  where it is not (such elements are counted).

Granite routes by bfloat16 router logits, and a routing choice that
differs between the packages changes its token's output, and through
attention every gradient, by far more than rounding.  Each case counts the
(token, layer) choices that differ (at most ``ROUTING_FLIPS_MAX``); where
one differs, the case holds the loss only.  Of ``GRANITE_SEEDS``, seeds 1
and 2 differ in 2 and 1 of 256 choices; seeds 0 and 3 in none.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import optim as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_bf16 import (BF16_EPS, ROUNDED_OPS,  # noqa: E402
                             ROUTING_FLIPS_MAX, _record_port_routes,
                             _record_reference_routes)

CPU = torch.device("cpu")
QWEN, GRANITE = "qwen3-1.7b", "granite-moe-3b-a800m"
QWEN_SEEDS, GRANITE_SEEDS = (0, 1, 2), (0, 1, 2, 3)
B, T = 4, 32
LR = 1e-2
GRAD_TOL = ROUNDED_OPS * BF16_EPS


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def _batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference cfg, port cfg, reference params, params as numpy, the
    reference's jitted bf16 ``value_and_grad`` with remat, its float32
    ``grad``, its bf16 forward and the list that forward's routes go to):
    one compile each per arch."""
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    bf16 = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(
        rcfg, p, b, compute_dtype=jnp.bfloat16, remat=True)[0]))
    f32 = jax.jit(jax.grad(lambda p, b: RM.loss_fn(rcfg, p, b)[0]))
    forward = jax.jit(lambda p, b: RM.forward(
        rcfg, p, b, mode="train", compute_dtype=jnp.bfloat16)[0])
    return (rcfg, pcfg, rparams, jax.tree.map(np.asarray, rparams), bf16,
            f32, forward, [])


def _routing_flips(name, batch_np):
    """(choices that differ, choices): each side's top-k expert ids in a
    bf16 forward, over every (token, MoE layer)."""
    _, pcfg, rparams, np_params, _, _, forward, rroutes = _setup(name)
    # the compiled forward's callback keeps the list it was traced with
    rroutes.clear()
    proutes = []
    unwrap = [_record_reference_routes(rroutes), _record_port_routes(proutes)]
    try:
        forward(rparams, {k: jnp.asarray(v) for k, v in batch_np.items()}
                ).block_until_ready()
        jax.effects_barrier()
        with torch.no_grad():
            M.forward(pcfg, lm_params_from_numpy(pcfg, np_params, device=CPU),
                      {k: torch.from_numpy(v) for k, v in batch_np.items()},
                      mode="train", compute_dtype=torch.bfloat16)
    finally:
        for fn in unwrap:
            fn()
    assert len(rroutes) == len(proutes) == pcfg.n_layers
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(rroutes, proutes)),
            sum(x.shape[0] for x in rroutes))


def _port_grads(pcfg, np_params, batch_np):
    """The port's bf16 ``loss_fn`` with remat, and its gradients by path
    (``None`` where the loss does not reach the leaf)."""
    params = lm_params_from_numpy(pcfg, np_params, device=CPU)
    paths = list(_paths(params))
    leaves = [O.tree_get(params, p).requires_grad_() for p in paths]
    loss, _ = M.loss_fn(pcfg, params,
                        {k: torch.from_numpy(v) for k, v in batch_np.items()},
                        compute_dtype=torch.bfloat16, remat=True)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip(paths, grads))


@pytest.mark.parametrize("name,seed", [(QWEN, s) for s in QWEN_SEEDS]
                         + [(GRANITE, s) for s in GRANITE_SEEDS])
def test_bf16_loss_and_every_gradient_leaf(name, seed):
    _, pcfg, rparams, np_params, bf16, f32, *_ = _setup(name)
    batch_np = _batch(pcfg.vocab, seed)
    rbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    want_loss, want_grads = bf16(rparams, rbatch)
    loss, grads = _port_grads(pcfg, np_params, batch_np)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=BF16_EPS)
    if pcfg.n_experts:
        flips, choices = _routing_flips(name, batch_np)
        assert flips <= ROUTING_FLIPS_MAX * choices, (flips, choices)
        if flips:
            return
    want_f32 = f32(rparams, rbatch)
    to_bf16 = to_f32 = norm = 0.0
    for path, g in grads.items():
        want = np.asarray(O.tree_get(want_grads, path))
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        assert got.shape == want.shape, path
        if g is None:  # unreached in the port: zero in the reference too
            assert not want.any(), path
        np.testing.assert_allclose(
            got, want, rtol=0, atol=GRAD_TOL * max(np.abs(want).max(), 1e-30),
            err_msg="/".join(path))
        to_bf16 += float(np.sum(np.square(got - want, dtype=np.float64)))
        to_f32 += float(np.sum(np.square(
            got - np.asarray(O.tree_get(want_f32, path)), dtype=np.float64)))
        norm += float(np.sum(np.square(want, dtype=np.float64)))
    assert to_bf16 < to_f32, (np.sqrt(to_bf16 / norm), np.sqrt(to_f32 / norm))


def test_bf16_train_step_matches_the_reference():
    """One ``make_train_step`` at bf16 compute with remat from one state.
    The first AdamW update is ``lr · g / (|g| + eps)`` of the clipped
    gradient, so each parameter is held to the float32 step's bar plus
    ``lr`` times the difference of that quotient between the two
    packages' gradients, and those gradients to the gradient bar."""
    rcfg, pcfg, rparams, np_params, bf16, *_ = _setup(QWEN)
    batch = _batch(rcfg.vocab, 7)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rstate = RT.init_state(rcfg, rparams, seed=5)
    state = train_state_from_numpy(pcfg, jax.tree.map(np.asarray, rstate),
                                   device=CPU)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        adamw=RO.AdamWConfig(lr=LR), compute_dtype=jnp.bfloat16, remat=True)))
    step = TS.make_train_step(pcfg, TS.TrainConfig(
        adamw=O.AdamWConfig(lr=LR), compute_dtype=torch.bfloat16, remat=True))
    want_state, want = rstep(rstate, rbatch)
    got_state, got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=BF16_EPS)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                               rtol=GRAD_TOL)
    assert np.float32(got["lr"]) == np.float32(want["lr"])
    _, want_grads = bf16(rparams, rbatch)
    _, grads = _port_grads(pcfg, np_params, batch)
    eps, clip = O.AdamWConfig().eps, O.AdamWConfig().grad_clip
    clip_got = min(1.0, clip / float(got["grad_norm"]))
    clip_want = min(1.0, clip / float(want["grad_norm"]))
    flipped, n = 0, 0
    for path, g in grads.items():
        gw = np.asarray(O.tree_get(want_grads, path), np.float64)
        gg = g.numpy().astype(np.float64)
        np.testing.assert_allclose(gg, gw, rtol=0,
                                   atol=GRAD_TOL * np.abs(gw).max())
        gw, gg = clip_want * gw, clip_got * gg
        du = np.abs(gg / (np.abs(gg) + eps) - gw / (np.abs(gw) + eps))
        w = np.asarray(O.tree_get(want_state.params, path))
        err = np.abs(O.tree_get(got_state.params, path).numpy() - w)
        ok = err <= 1e-6 * np.abs(w) + 1e-6 * LR + LR * du
        assert ok.all(), ("/".join(path), err[~ok].max())
        flipped += int((np.sign(gg) != np.sign(gw)).sum())
        n += gw.size
    print(f"{flipped} of {n} gradient entries differ in sign")
