"""The port's counterpart of ``tests/test_arch_smoke.py``: every assigned
arch's REDUCED config, forward, loss, gradients and one fixed SGD step,
held against the reference on the same parameters and batch.

Parameters are made once per arch by the reference's ``init`` and carried
across with ``repro_torch.convert.lm_params_from_numpy``; batches come from
a numpy seed.  Everything runs in float32 on the CPU, the reference on its
plain path under ``jax.jit``, the port on its plain versions under
autograd.  Bars: logits atol/rtol 1e-4 (float32 sums in another order over
a few layers, as in ``tests/test_torch_models.py``); the loss rtol 1e-5;
every gradient leaf atol 1e-4 × that leaf's largest entry (the archs
differ from the reference by at most 8e-6 of it); a leaf the loss never
reaches (the embedding of a stub-frontend arch, MoE plan tensors) is
``None`` in torch and zeros in jax, and both count as zero.

The SGD step is the reference test's: ``p - 0.5 · grad``, then the loss on
the same batch.  The port holds parity with the reference's two losses
for every arch, llama4 included: the reference's strict xfail there is
about the direction of that step (a top-1 routing boundary), which parity
does not assert.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optim import tree_get  # noqa: E402

ARCH_IDS = sorted(REF_ARCHS)
CPU = torch.device("cpu")
B, T = 2, 32
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SGD_LR, SGD_RTOL = 0.5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.frontend == "embed":
        out["embeds"] = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference cfg, port cfg, reference params, params as numpy, the
    reference's ``((loss, (logits, aux)), grads)`` jitted): one compile per
    arch, shared by the tests."""
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))

    def loss(p, batch):
        logits, _, aux = RM.forward(rcfg, p, batch)
        return RM.loss_fn(rcfg, p, batch)[0], (logits, aux)

    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return rcfg, pcfg, rparams, jax.tree.map(np.asarray, rparams), grad


def _port(name, batch_np):
    """(port cfg, fresh port params that require grad, torch batch)."""
    _, pcfg, _, np_params, _ = _setup(name)
    params = lm_params_from_numpy(pcfg, np_params, device=CPU)
    M._tree_map(lambda _, a: a.requires_grad_(), params)
    return pcfg, params, {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _port_grads(pcfg, params, batch, remat=False):
    loss, _ = M.loss_fn(pcfg, params, batch, remat=remat)
    leaves = [tree_get(params, p) for p in _paths(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip(_paths(params), grads))


def _zeros_if_none(g, like):
    return np.zeros(tuple(like.shape), np.float32) if g is None else g.numpy()


@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_shapes_finite_and_logits(name):
    rcfg, _, rparams, _, ref_grad = _setup(name)
    batch_np = _batch(rcfg, 1)
    pcfg, params, batch = _port(name, batch_np)
    with torch.no_grad():
        logits, cache, aux = M.forward(pcfg, params, batch)
    assert tuple(logits.shape) == (B, T, pcfg.vocab)
    assert cache is None
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    (_, (want, want_aux)), _ = ref_grad(
        rparams, {k: jnp.asarray(v) for k, v in batch_np.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **LOGITS_TOL)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_loss_and_every_gradient_leaf(name):
    rcfg, _, rparams, _, ref_grad = _setup(name)
    batch_np = _batch(rcfg, 2)
    (want_loss, _), want_grads = ref_grad(
        rparams, {k: jnp.asarray(v) for k, v in batch_np.items()})
    pcfg, params, batch = _port(name, batch_np)
    loss, grads = _port_grads(pcfg, params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert set(grads) == set(_paths(want_grads))
    for path, g in grads.items():
        want = np.asarray(tree_get(want_grads, path))
        got = _zeros_if_none(g, want)
        assert got.shape == want.shape, path
        np.testing.assert_allclose(
            got, want, rtol=0, atol=GRAD_TOL * max(np.abs(want).max(), 1e-30),
            err_msg="/".join(path))
        if g is None:  # unreached in the port: zero in the reference too
            assert not want.any(), path


@pytest.mark.parametrize("name", ARCH_IDS)
def test_fixed_sgd_step_matches_the_reference(name):
    """The reference test's step: l0, then l1 after ``p - 0.5 · grad``, on
    one batch; both losses equal the reference's."""
    rcfg, _, rparams, _, ref_grad = _setup(name)
    batch_np = _batch(rcfg, 3)
    rbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (want0, _), g = ref_grad(rparams, rbatch)
    (want1, _), _ = ref_grad(jax.tree.map(lambda a, b: a - SGD_LR * b, rparams, g),
                        rbatch)
    pcfg, params, batch = _port(name, batch_np)
    l0, grads = _port_grads(pcfg, params, batch)
    with torch.no_grad():
        stepped = M._tree_map(
            lambda path, p: p if grads[path] is None
            else p - SGD_LR * grads[path], params)
        l1, _ = M.loss_fn(pcfg, stepped, batch)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    np.testing.assert_allclose([float(l0), float(l1)],
                               [float(want0), float(want1)], rtol=SGD_RTOL)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_remat_matches_plain(name):
    """``remat=True`` recomputes each group in the backward pass: the same
    loss and the same gradients, bit for bit on the CPU."""
    rcfg = _setup(name)[0]
    batch_np = _batch(rcfg, 4)
    pcfg, params, batch = _port(name, batch_np)
    l_plain, g_plain = _port_grads(pcfg, params, batch, remat=False)
    l_remat, g_remat = _port_grads(pcfg, params, batch, remat=True)
    np.testing.assert_allclose(float(l_remat), float(l_plain), rtol=LOSS_RTOL)
    for path, g in g_plain.items():
        if g is None:
            assert g_remat[path] is None, path
        else:
            assert torch.equal(g_remat[path], g), path
