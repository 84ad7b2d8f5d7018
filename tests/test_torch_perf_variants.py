"""The port's inference levers against the reference's
(``tests/test_perf_variants.py``): the int8 KV decode cache and the
inference sharding rules.

The int8 cache is filled the way the reference's test fills it, by
replaying tokens through decode steps, in both packages from the same
parameters (the reference's ``init``, carried across by
``repro_torch.convert.lm_params_from_numpy``) and the same numpy tokens,
in float32 on the CPU.  Port against reference: atol 1e-4, rtol 1e-4 on
every step's logits (float32 sums in another order over a few layers), and
the same greedy tokens.  Port int8 against the port's float cache: the
reference's own bars (atol 0.15, rtol 0.1, the same argmax, fewer than
0.65× the bytes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import sharding as RS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 25


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(archs, name):
    cfg = archs[name].reduced()
    # token-in, as the reference's test serves musicgen: the frontend stub
    # replaced by tokens
    return dataclasses.replace(cfg, frontend=None) if cfg.frontend else cfg


@pytest.fixture(scope="module", params=["musicgen-large", "qwen3-1.7b"])
def pair(request):
    """(reference cfg, port cfg, reference params, port params, tokens)."""
    rcfg, pcfg = _cfg(REF_ARCHS, request.param), _cfg(ARCHS, request.param)
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    pparams = lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, rparams), device=CPU)
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab, size=(B, T + 4)).astype(np.int32)
    return rcfg, pcfg, rparams, pparams, toks


def _step_batch(toks, t):
    return (toks[:, t:t + 1], np.full((B, 1), t, np.int32))


def test_int8_decode_matches_the_reference(pair):
    """Replay T tokens into each package's int8 cache, then decode one
    more: every step's logits and greedy tokens agree."""
    rcfg, pcfg, rparams, pparams, toks = pair
    rcache = RM.init_cache(rcfg, B, T + 8, dtype=jnp.float32, kv_int8=True)
    ref_step = jax.jit(RM.decode_step, static_argnums=0)
    pcache = M.init_cache(pcfg, B, T + 8, dtype=torch.float32, kv_int8=True,
                          device=CPU)
    for t in range(T + 1):
        tok, pos = _step_batch(toks, t)
        rl, rcache, _ = ref_step(
            rcfg, rparams, {"tokens": jnp.asarray(tok),
                            "positions": jnp.asarray(pos)}, rcache)
        pl, pcache, _ = M.decode_step(
            pcfg, pparams, {"tokens": torch.from_numpy(tok),
                            "positions": torch.from_numpy(pos)}, pcache)
        want = np.asarray(rl, np.float32)
        np.testing.assert_allclose(pl.numpy(), want, **TOL)
        assert (pl[:, -1].argmax(-1).numpy() == want[:, -1].argmax(-1)).all()
    dtypes = set()
    M._tree_map(lambda _, x: dtypes.add(x.dtype), pcache)
    assert torch.int8 in dtypes


def test_int8_decode_matches_the_float_cache(pair):
    """The reference's bars, on the port: the int8 cache's next-token
    logits against the float cache's a prefill wrote."""
    _, pcfg, _, pparams, toks = pair
    _, cache_fp, _ = M.prefill(pcfg, pparams,
                               {"tokens": torch.from_numpy(toks[:, :T])},
                               max_cache_len=T + 8)
    cache_q = M.init_cache(pcfg, B, T + 8, dtype=torch.float32, kv_int8=True,
                           device=CPU)
    for t in range(T):
        tok, pos = _step_batch(toks, t)
        _, cache_q, _ = M.decode_step(
            pcfg, pparams, {"tokens": torch.from_numpy(tok),
                            "positions": torch.from_numpy(pos)}, cache_q)
    tok, pos = _step_batch(toks, T)
    batch = {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)}
    logits_fp, _, _ = M.decode_step(pcfg, pparams, batch, cache_fp)
    logits_q, _, _ = M.decode_step(pcfg, pparams, batch, cache_q)
    np.testing.assert_allclose(logits_q.numpy(), logits_fp.numpy(),
                               atol=0.15, rtol=0.1)
    assert (logits_q[:, -1].argmax(-1) == logits_fp[:, -1].argmax(-1)).all()


def test_int8_cache_layout_and_bytes(pair):
    """The port's int8 cache has the reference's leaves (shapes and
    dtypes), and fewer than 0.65× the float cache's bytes."""
    rcfg, pcfg = pair[0], pair[1]
    rq = RM.init_cache(rcfg, 4, 64, kv_int8=True)
    pq = M.init_cache(pcfg, 4, 64, kv_int8=True, device=CPU)
    pfp = M.init_cache(pcfg, 4, 64, device=CPU)
    got = {}
    M._tree_map(lambda path, x: got.__setitem__(
        path, (tuple(x.shape), str(x.dtype).replace("torch.", ""))), pq)
    want = {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(rq)}
    assert got == want

    def nbytes(tree):
        sizes = []
        M._tree_map(lambda _, x: sizes.append(x.numel() * x.element_size()),
                    tree)
        return sum(sizes)

    # int8 + per-position f32 scale ≈ (1 + 4/Dh) bytes vs 2 bytes
    assert nbytes(pq) < 0.65 * nbytes(pfp)


def test_inference_rules_equal_the_reference():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.INFERENCE_RULES == RS.INFERENCE_RULES
    assert S.INFERENCE_RULES["qkv_fsdp"] is None
    assert S.INFERENCE_RULES["ffn_fsdp"] is None
    assert S.DEFAULT_RULES["qkv_fsdp"] == "data"
    assert S.INFERENCE_RULES["heads"] == S.DEFAULT_RULES["heads"]
    assert S.INFERENCE_RULES["act_batch"] == S.DEFAULT_RULES["act_batch"]
