"""The port's LM layers and model against the reference on the same inputs.

Parameters are made by the reference's ``init`` and carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made from a seed
with numpy.  Everything runs in float32 on the CPU, where the reference
runs its plain path (``use_kernels=False``) and the port its plain
versions.  Tolerance: atol 1e-4, rtol 1e-4 — float32 sums taken in another
order by the two frameworks' CPU kernels, over a few layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import padded_for_tp as ref_padded_for_tp  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS, padded_for_tp  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")

#: RecurrentGemma (RG-LRU + local attention + tail), qwen3 (qk-norm, tied
#: embeddings, GQA), stablelm (layernorm, MHA), olmo (non-parametric LN),
#: Falcon-Mamba (Mamba-1 mixers only, untied embeddings), Granite-MoE
#: (GQA attention + capacity-dropped top-k MoE FFN, tied embeddings),
#: Mistral-NeMo (GQA, Dh 128 set apart from d_model / heads), Llama4-Scout
#: (iRoPE: windowed RoPE layers and a global NoPE layer, top-1 MoE),
#: Phi-3-vision and MusicGen (stub frontends fed ``embeds``; MusicGen's
#: GELU MLP and layernorm with bias)
ARCH_NAMES = ["recurrentgemma-9b", "qwen3-1.7b", "stablelm-1.6b", "olmo-1b",
              "falcon-mamba-7b", "granite-moe-3b-a800m", "mistral-nemo-12b",
              "llama4-scout-17b-a16e", "phi-3-vision-4.2b", "musicgen-large"]
GRANITE = "granite-moe-3b-a800m"
LLAMA4 = "llama4-scout-17b-a16e"


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _assert_tree_close(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k])
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            _assert_close(got[k], want[k])


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(reference cfg, port cfg, reference params, port params)."""
    name = request.param
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    pparams = lm_params_from_numpy(pcfg, _np_tree(rparams), device=CPU)
    return rcfg, pcfg, rparams, pparams


def _tokens(vocab, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(cfg, B, T, seed=0):
    """A seeded numpy batch: ``tokens`` (B, T), or for a stub-frontend arch
    ``embeds`` (B, T, d_model) drawn from N(0, 1)."""
    if cfg.frontend == "embed":
        return {"embeds": _x((B, T, cfg.d_model), seed=seed)}
    return {"tokens": _tokens(cfg.vocab, B, T, seed=seed)}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prefill_then_decode(rcfg, pcfg, rparams, pparams, B, T, max_len, steps,
                         seed):
    """Prefill ``B`` x ``T`` seeded inputs into caches of ``max_len``, then
    ``steps`` decode steps fed the reference's greedy tokens (or, for a
    stub-frontend arch, seeded embeds); the logits, the aux loss and the
    cache are held against the reference's after each call, the port's
    cache updated in place."""
    batch = _inputs(rcfg, B, T, seed=seed)
    rl, rcache, raux = RM.prefill(rcfg, rparams, _ref(batch),
                                  max_cache_len=max_len)
    pl, pcache, paux = M.prefill(pcfg, pparams, _port(batch),
                                 max_cache_len=max_len)
    _assert_close(pl, rl)
    _assert_close(paux, raux)
    _assert_tree_close(pcache, _np_tree(rcache))
    for step in range(steps):
        if rcfg.frontend == "embed":
            feed = {"embeds": _x((B, 1, rcfg.d_model), seed=seed + 1 + step)}
        else:
            feed = {"tokens": np.asarray(jnp.argmax(rl[:, -1], axis=-1))
                    .astype(np.int32)[:, None]}
        feed["positions"] = np.full((B, 1), T + step, np.int32)
        rl, rcache, raux = RM.decode_step(rcfg, rparams, _ref(feed), rcache)
        pl, same, paux = M.decode_step(pcfg, pparams, _port(feed), pcache)
        assert same is pcache  # updated in place
        _assert_close(pl, rl)
        _assert_close(paux, raux)
        _assert_tree_close(pcache, _np_tree(rcache))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def test_forward_logits_match(pair):
    """Logits and the aux loss (the MoE blocks' load-balance losses summed;
    0 without MoE)."""
    rcfg, pcfg, rparams, pparams = pair
    batch = _inputs(rcfg, 2, 12)
    want, _, want_aux = RM.forward(rcfg, rparams, _ref(batch))
    got, cache, aux = M.forward(pcfg, pparams, _port(batch))
    assert cache is None and aux.dtype == torch.float32 and aux.dim() == 0
    _assert_close(aux, want_aux)
    assert (float(aux) > 0.0) == (pcfg.n_experts > 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, rcfg.vocab)
    _assert_close(got, want)


def test_prefill_then_decode_match(pair):
    """Prefill logits and cache, then three decode steps (logits and the
    cache after each) from the port's own caches."""
    _prefill_then_decode(*pair, B=2, T=10, max_len=24, steps=3, seed=1)


def test_llama4_prefill_then_decode_crosses_the_window():
    """Llama4-Scout's reduced config keeps a 32-token window on its RoPE
    layers (the global NoPE layer has none): a 40-token prefill and six
    decode steps run past it, in the prefill's masks and in the decode
    step's masking of the cache."""
    rcfg, pcfg = REF_ARCHS[LLAMA4].reduced(), ARCHS[LLAMA4].reduced()
    assert [b.window for b in pcfg.pattern] == [32, 32, 32, None]
    assert [b.rope for b in pcfg.pattern] == [True, True, True, False]
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    pparams = lm_params_from_numpy(pcfg, _np_tree(rparams), device=CPU)
    _prefill_then_decode(rcfg, pcfg, rparams, pparams, B=2, T=40, max_len=56,
                         steps=6, seed=4)


def test_last_only_is_the_last_row(pair):
    rcfg, pcfg, rparams, pparams = pair
    batch = _inputs(rcfg, 1, 9, seed=2)
    full, _, _ = M.prefill(pcfg, pparams, _port(batch), max_cache_len=16)
    last, _, _ = M.prefill(pcfg, pparams, _port(batch), max_cache_len=16,
                           last_only=True)
    want, _, _ = RM.prefill(rcfg, rparams, _ref(batch), max_cache_len=16,
                            last_only=True)
    assert tuple(last.shape) == (1, 1, rcfg.vocab)
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=1e-5, rtol=1e-5)
    _assert_close(last, want)


def test_padded_vocab_rows_are_masked():
    """``vocab_real``: TP-padded vocab rows read -1e9, as in the reference."""
    rcfg = ref_padded_for_tp(REF_ARCHS["qwen3-1.7b"].reduced(), 3)
    pcfg = padded_for_tp(ARCHS["qwen3-1.7b"].reduced(), 3)
    assert pcfg.vocab_real == 256 and pcfg.vocab == 258
    rparams = RM.init(rcfg, jax.random.PRNGKey(1))
    pparams = lm_params_from_numpy(pcfg, _np_tree(rparams), device=CPU)
    toks = _tokens(256, 1, 6, seed=3)
    want, _, _ = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    got, _, _ = M.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks)})
    assert bool(torch.all(got[..., 256:] == -1e9))
    _assert_close(got, want)


def test_init_matches_the_reference_tree():
    """The port's ``init`` builds the reference's tree: same leaves, shapes
    and stacked group axis; the compute dtype is cast once, final_norm
    stays float32."""
    for name in ARCH_NAMES:
        rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
        want = jax.eval_shape(lambda c=rcfg: RM.init(c, jax.random.PRNGKey(0)))
        gen = torch.Generator(device="cpu").manual_seed(0)
        got = M.init(pcfg, gen, device=CPU, dtype=torch.bfloat16)
        flat_want = {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
                     for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_got = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                flat_got[path] = tuple(node.shape)
                assert node.dtype == (torch.float32 if path[0] == "final_norm"
                                      else torch.bfloat16), path

        walk(got)
        assert flat_got == {k: tuple(v) for k, v in flat_want.items()}, name


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rg_cfgs():
    return (REF_ARCHS["recurrentgemma-9b"].reduced(),
            ARCHS["recurrentgemma-9b"].reduced())


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_fwd_matches(with_state):
    rcfg, pcfg = _rg_cfgs()
    rp = RL.init_rglru(rcfg, jax.random.PRNGKey(3))
    pp = {k: _t(v) for k, v in _np_tree(rp).items()}
    x = _x((2, 7, rcfg.d_model), seed=4)
    rstate = pstate = None
    if with_state:
        h = _x((2, rcfg.rglru_width), seed=5)
        conv = _x((2, 3, rcfg.rglru_width), seed=6)
        rstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        pstate = {"h": _t(h), "conv": _t(conv)}
    want, wstate = RL.rglru_fwd(rcfg, rp, jnp.asarray(x), state=rstate)
    got, gstate = L.rglru_fwd(pcfg, pp, torch.from_numpy(x), state=pstate)
    _assert_close(got, want)
    if with_state:
        _assert_tree_close(gstate, _np_tree(wstate))
    else:
        assert gstate is None and wstate is None


def _fm_cfgs():
    return (REF_ARCHS["falcon-mamba-7b"].reduced(),
            ARCHS["falcon-mamba-7b"].reduced())


def test_prefill_matches_the_reference_kernel_path():
    """Falcon-Mamba's prefill against the reference's ``use_kernels=True``
    path, which at 80 tokens and d_inner 128 runs its Pallas ``mamba_scan``
    (interpret mode on the CPU); the port's CPU path is the plain version."""
    rcfg, pcfg = _fm_cfgs()
    rparams = RM.init(rcfg, jax.random.PRNGKey(4))
    pparams = lm_params_from_numpy(pcfg, _np_tree(rparams), device=CPU)
    toks = _tokens(rcfg.vocab, 1, 80, seed=5)
    rl, rcache, _ = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                               max_cache_len=96, use_kernels=True)
    pl, pcache, _ = M.prefill(pcfg, pparams, {"tokens": torch.from_numpy(toks)},
                              max_cache_len=96, use_kernels=True)
    _assert_close(pl, rl)
    _assert_tree_close(pcache, _np_tree(rcache))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_fwd_matches(with_state):
    """The Mamba-1 block, with a non-trivial dt_bias, A_log and D, without a
    state (training) and with a float32 carried state (decode)."""
    rcfg, pcfg = _fm_cfgs()
    rp = RL.init_mamba(rcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    rp = dict(rp, dt_bias=jnp.asarray(rng.normal(size=rp["dt_bias"].shape),
                                      jnp.float32),
              A_log=jnp.asarray(rng.normal(size=rp["A_log"].shape), jnp.float32),
              D=jnp.asarray(rng.normal(size=rp["D"].shape), jnp.float32))
    pp = {k: _t(v) for k, v in _np_tree(rp).items()}
    x = _x((2, 7, rcfg.d_model), seed=4)
    rstate = pstate = None
    if with_state:
        h = _x((2, rcfg.ssm_d_inner, rcfg.ssm_state), seed=5)
        conv = _x((2, rcfg.ssm_conv - 1, rcfg.ssm_d_inner), seed=6)
        rstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        pstate = {"h": _t(h), "conv": _t(conv)}
    want, wstate = RL.mamba_fwd(rcfg, rp, jnp.asarray(x), state=rstate)
    got, gstate = L.mamba_fwd(pcfg, pp, torch.from_numpy(x), state=pstate)
    _assert_close(got, want)
    if with_state:
        _assert_tree_close(gstate, _np_tree(wstate))
    else:
        assert gstate is None and wstate is None


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_state_owns_its_storage(with_prev):
    """The carried conv state is a copy of the last K-1 rows, not a view of
    the (B, T+K-1, C) concatenation: a view would keep every layer's conv
    input alive through a prefill (a jax slice is a copy).  The values are
    the reference's."""
    B, T, C, K = 2, 9, 6, 4
    x, w = _x((B, T, C), seed=7), _x((K, C), seed=8)
    prev = _x((B, K - 1, C), seed=9) if with_prev else None
    want_out, want_prev = RL._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if prev is None else jnp.asarray(prev))
    out, new_prev = L._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if prev is None else torch.from_numpy(prev))
    assert new_prev.is_contiguous()
    assert new_prev.untyped_storage().nbytes() == B * (K - 1) * C * 4
    _assert_close(out, want_out)
    _assert_close(new_prev, want_prev, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_matches_jax(dtype):
    """``F.softplus``, which ``mamba_fwd`` takes for Δ, returns x above 20
    where jax takes logaddexp(x, 0): above the switch the two are equal,
    and everywhere they agree to two units in the last place of the dtype
    (the two libraries' exp and log1p round differently): 2^-22 relative
    in float32, 2^-7 in bfloat16."""
    x = np.concatenate([np.linspace(-60.0, 60.0, 4001),
                        np.linspace(19.0, 21.0, 2001)]).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(x, getattr(jnp, dtype)))
    got = F.softplus(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    above = x > 20.0
    np.testing.assert_array_equal(got[above], want[above])
    two_ulps = 2.0 ** -22 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=0.0, rtol=two_ulps)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_mlp_and_norms_match(name):
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rp = RL.init_mlp(rcfg, jax.random.PRNGKey(7))
    pp = {k: _t(v) for k, v in _np_tree(rp).items()}
    x = _x((2, 5, rcfg.d_model), seed=8)
    _assert_close(L.mlp_fwd(pcfg, pp, torch.from_numpy(x)),
                  RL.mlp_fwd(rcfg, rp, jnp.asarray(x)))
    rn = RL.init_norm(rcfg, None)
    rng = np.random.default_rng(9)
    rn = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
          for k, v in rn.items()}  # non-trivial scale and bias
    pn = {k: _t(v) for k, v in _np_tree(rn).items()}
    _assert_close(L.apply_norm(pcfg, pn, torch.from_numpy(x)),
                  RL.apply_norm(rcfg, rn, jnp.asarray(x)))


def test_rope_matches():
    x = _x((2, 3, 6, 16), seed=10)
    pos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 9, 100, 4000]], np.int32)
    _assert_close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
                  RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                  atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "qwen3-1.7b", GRANITE])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "decode_int8"])
def test_attention_fwd_matches(name, mode):
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    blk_r = next(b for b in rcfg.pattern if b.mixer == "attn")
    blk_p = next(b for b in pcfg.pattern if b.mixer == "attn")
    rp = RL.init_attention(rcfg, jax.random.PRNGKey(11))
    pp = {k: _t(v) for k, v in _np_tree(rp).items()}
    B, S = 2, 40
    T = 1 if mode.startswith("decode") else 9
    x = _x((B, T, rcfg.d_model), seed=12)
    if mode.startswith("decode"):
        pos = np.array([[5], [37]], np.int32)
        int8 = mode == "decode_int8"
        cache = RM._attn_zero_cache(rcfg, B, S, jnp.int8 if int8 else jnp.float32)
        rng = np.random.default_rng(13)
        cache = {k: np.asarray(
            rng.integers(-127, 128, size=v.shape) if v.dtype == jnp.int8
            else rng.uniform(0.01, 0.05, size=v.shape) if k.endswith("scale")
            else rng.normal(size=v.shape), v.dtype) for k, v in cache.items()}
        rcache = {k: jnp.asarray(v) for k, v in cache.items()}
        pcache = {k: _t(v) for k, v in cache.items()}
        kw = dict(mode="decode")
    else:
        pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        rcache = pcache = None
        kw = dict(mode=mode, max_cache_len=S if mode == "prefill" else None)
    want, wcache = RL.attention_fwd(rcfg, blk_r, rp, jnp.asarray(x),
                                    jnp.asarray(pos), cache=rcache, **kw)
    got, gcache = L.attention_fwd(pcfg, blk_p, pp, torch.from_numpy(x),
                                  torch.from_numpy(pos), cache=pcache, **kw)
    _assert_close(got, want)
    if wcache is None:
        assert gcache is None
    else:
        _assert_tree_close(gcache, _np_tree(wcache))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 12, 0), (False, None, 0), (True, 8, 5)])
def test_chunked_attention_matches(causal, window, q_offset):
    """The plain block loop against the reference's double scan, with
    ragged blocks (T=S=37 in blocks of 8 and 16)."""
    q = _x((1, 4, 37, 16), seed=14)
    k = _x((1, 2, 37 + q_offset, 16), seed=15)
    v = _x((1, 2, 37 + q_offset, 16), seed=16)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal, window, q_offset, block_q=8, block_k=16)
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, window, q_offset,
                              block_q=8, block_k=16)
    _assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_long_prefill_takes_the_chunked_path(monkeypatch):
    """Above ``_DENSE_LOGITS_LIMIT`` the plain path is ``chunked_attention``
    and agrees with the dense one."""
    _, pcfg = _rg_cfgs()
    blk = next(b for b in pcfg.pattern if b.mixer == "attn")
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = L.init_attention(pcfg, gen)
    x = torch.from_numpy(_x((1, 50, pcfg.d_model), seed=17))
    pos = torch.arange(50)[None]
    dense, _ = L.attention_fwd(pcfg, blk, p, x, pos)
    calls = []
    real = L.chunked_attention
    monkeypatch.setattr(L, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(L, "_DENSE_LOGITS_LIMIT", 100)
    chunked, _ = L.attention_fwd(pcfg, blk, p, x, pos)
    assert calls == [1]
    torch.testing.assert_close(chunked, dense, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE (Granite)
# ---------------------------------------------------------------------------

def _granite_cfgs():
    return REF_ARCHS[GRANITE].reduced(), ARCHS[GRANITE].reduced()


def _moe_params(rcfg, seed, plan_capacity=1.0):
    rp = RL.init_moe(rcfg, jax.random.PRNGKey(seed))
    rp = dict(rp, plan_capacity=jnp.full_like(rp["plan_capacity"], plan_capacity))
    return rp, {k: _t(v) for k, v in _np_tree(rp).items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("plan_capacity", [1.0, 0.5, 1.5])
def test_moe_local_matches(plan_capacity, use_kernel):
    """``_moe_local`` output and aux loss against the reference's.  At 24
    tokens C = 8: plan_capacity 0.5 drops every token past slot 3 of its
    expert; 1.5 keeps up to 12 a expert and adds slots 8-11 into slot 7.
    On the CPU ``use_kernel=True`` takes the plain version."""
    rcfg, pcfg = _granite_cfgs()
    rp, pp = _moe_params(rcfg, 20, plan_capacity)
    x = _x((24, rcfg.d_model), seed=21)
    want, want_aux = RL._moe_local(rcfg, rp, jnp.asarray(x))
    got, aux = L._moe_local(pcfg, pp, torch.from_numpy(x), use_kernel=use_kernel)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, rcfg.d_model)
    _assert_close(got, want)
    _assert_close(aux, want_aux)


def test_moe_local_capacities_drop_and_repeat_pairs(monkeypatch):
    """The slots that reach the dispatch: at plan_capacity 0.5 some tokens
    are dropped (slot C), at 1.5 some kept ones share slot C-1."""
    rcfg, pcfg = _granite_cfgs()
    x = torch.from_numpy(_x((24, rcfg.d_model), seed=21))
    seen = {}
    real = L.kops.dispatch_at_slots

    def spy(tokens, ids, slots, E, C, use_kernel=True):
        seen["slots"], seen["C"] = slots.clone(), C
        return real(tokens, ids, slots, E, C, use_kernel=use_kernel)

    monkeypatch.setattr(L.kops, "dispatch_at_slots", spy)
    for cap, dropped, repeated in ((0.5, True, False), (1.5, False, True)):
        _, pp = _moe_params(rcfg, 20, cap)
        L._moe_local(pcfg, pp, x)
        _, _, top_ids = L.route(pcfg, pp, x)
        slots, C = seen["slots"], seen["C"]
        assert C == 8
        assert bool((slots == C).any()) == dropped
        pairs = top_ids.reshape(-1)[slots < C] * C + slots[slots < C]
        assert (pairs.unique().numel() < pairs.numel()) == repeated


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [2, 3])
def test_router_ties_follow_jax_top_k(dtype, top_k):
    """Exactly tied gates go to the lower expert id, as ``jax.lax.top_k``
    sends them: gates [.1, .3, .3, .2, .3, .1, .3, .05] pick experts [1, 2]
    (k 2) and [1, 2, 4] (k 3), where ``torch.topk`` may pick others."""
    rcfg, pcfg = _granite_cfgs()
    rcfg = dataclasses.replace(rcfg, top_k=top_k)
    pcfg = dataclasses.replace(pcfg, top_k=top_k)
    rp, _ = _moe_params(rcfg, 22)
    row = np.log(np.array([.1, .3, .3, .2, .3, .1, .3, .05], np.float32))
    router = np.zeros((rcfg.d_model, rcfg.n_experts), np.float32)
    router[0] = row
    x = np.zeros((5, rcfg.d_model), np.float32)
    x[:, 0] = 1.0  # every token's logits are exactly `row`
    rp = dict(rp, router=jnp.asarray(router))
    jd = getattr(jnp, dtype)
    rp_d = jax.tree.map(lambda a: a.astype(jd), rp)
    logits = jnp.asarray(x, jd) @ rp_d["router"] + rp_d["plan_bias"]
    gates = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, want_ids = jax.lax.top_k(gates, top_k)
    pp = {k: _t(v).to(getattr(torch, dtype)) for k, v in _np_tree(rp).items()}
    _, _, got_ids = L.route(pcfg, pp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_ids.tolist() == np.asarray(want_ids).tolist()
    assert got_ids[0].tolist() == [1, 2, 4][:top_k]
    if dtype == "float32":
        want, want_aux = RL._moe_local(rcfg, rp, jnp.asarray(x))
        pp32 = {k: _t(v) for k, v in _np_tree(rp).items()}
        got, aux = L._moe_local(pcfg, pp32, torch.from_numpy(x))
        _assert_close(got, want)
        _assert_close(aux, want_aux)


def test_moe_fwd_with_a_mesh_raises():
    """A mesh without a ``"model"`` dim takes the one-device path, as the
    reference's does; one with it runs expert parallel, whose collectives
    need the process group the mesh was built on, and raise without one
    (``tests/test_torch_multidevice.py`` runs the path on gloo worlds)."""
    import types

    rcfg, pcfg = _granite_cfgs()
    _, pp = _moe_params(rcfg, 23)
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (1, 4, pcfg.d_model)).astype(np.float32))
    want = L.moe_fwd(pcfg, pp, x)
    got = L.moe_fwd(pcfg, pp, x, mesh=types.SimpleNamespace(
        mesh_dim_names=("data",)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    no_group = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), size=lambda dim: 1,
        get_local_rank=lambda axis: 0, get_group=lambda axis: None)
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        L.moe_fwd(pcfg, pp, x, mesh=no_group)


def test_lm_params_from_numpy_takes_granites_tree():
    """The reference's Granite tree maps leaf for leaf: router, experts and
    the plan leaves stacked over the groups, cast to the compute dtype
    (final_norm stays float32)."""
    rcfg, pcfg = _granite_cfgs()
    rparams = _np_tree(RM.init(rcfg, jax.random.PRNGKey(5)))
    got = lm_params_from_numpy(pcfg, rparams, dtype=torch.bfloat16, device=CPU)
    ffn = got["groups"]["blk0"]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down", "plan_bias",
                        "plan_capacity"}
    G, E, d, f = pcfg.n_groups, pcfg.n_experts, pcfg.d_model, pcfg.expert_d_ff_
    assert tuple(ffn["w_gate"].shape) == (G, E, d, f)
    assert tuple(ffn["w_down"].shape) == (G, E, f, d)
    assert tuple(ffn["router"].shape) == (G, d, E)
    assert all(a.dtype == torch.bfloat16 for a in ffn.values())
    assert got["final_norm"]["scale"].dtype == torch.float32
    for k, v in rparams["groups"]["blk0"]["ffn"].items():
        torch.testing.assert_close(ffn[k], torch.from_numpy(np.array(v))
                                   .to(torch.bfloat16), atol=0.0, rtol=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_capacity_rounds_in_the_parameters_dtype(dtype, monkeypatch):
    """``plan_capacity · C`` is rounded in the parameters' dtype, as the
    reference rounds it: at C = 750 a bfloat16 capacity of 1.0 keeps 752
    tokens an expert (bf16(750) = 752), and the last three add into slot
    749; float32 keeps 750."""
    rcfg, pcfg = _granite_cfgs()
    _, pp = _moe_params(rcfg, 24)
    pp = {k: v.to(getattr(torch, dtype)) for k, v in pp.items()}
    pp["plan_bias"][0] = 50.0  # every token's top choice is expert 0
    N = 2400  # C = ceil(2400 · 2 / 8 · 1.25) = 750
    x = torch.from_numpy(_x((N, rcfg.d_model), seed=25)).to(pp["router"].dtype)
    seen = {}
    real = L.kops.dispatch_at_slots

    def spy(tokens, ids, slots, E, C, use_kernel=True):
        seen.update(ids=ids.clone(), slots=slots.clone(), C=C)
        return real(tokens, ids, slots, E, C, use_kernel=use_kernel)

    monkeypatch.setattr(L.kops, "dispatch_at_slots", spy)
    L._moe_local(pcfg, pp, x)
    C = seen["C"]
    want_cap = int(jnp.round(jnp.ones((), getattr(jnp, dtype)) * C))
    assert C == 750 and want_cap == (752 if dtype == "bfloat16" else 750)
    kept0 = seen["slots"][(seen["ids"] == 0) & (seen["slots"] < C)]
    assert kept0.numel() == want_cap
    assert int((kept0 == C - 1).sum()) == want_cap - C + 1
