"""The port's bfloat16 model against the reference's on the CPU.

The other parity tests run in float32; this file holds the port's bf16
path, the one the card serves, to the reference's.  Parameters are made by
the reference's ``init``, carried across with
``repro_torch.convert.lm_params_from_numpy`` and cast to bfloat16 on both
sides (the port once with ``cast_params``, the reference on every call
with ``compute_dtype=bfloat16``; ``final_norm`` stays float32 on both).
Tokens come from a numpy seed.  Both sides run their plain path: a prefill
of B prompts of T tokens, then three decode steps fed the reference's
greedy tokens, from each side's own cache.  Every case of ``CASES`` runs:
the float32 tests' prompt length (10) up to 64 tokens, three seeds each.

Tolerance: each logit is rounded to bfloat16 on both sides (2^-8 relative
at most), and the hidden state it is read from carries the rounding of
every bfloat16 operation before it: 2^-8 relative each, over the reduced
models' 2 layers of about 6 rounded operations (projections, attention,
expert or MLP products, residual adds).  So logits are held to
``atol = 12 · 2^-8 · max |logit|`` plus ``rtol = 2^-8``.

Granite-MoE routes each token to its top-k experts by bfloat16 router
logits, which tie or nearly tie often, so one bfloat16 ulp in a router's
input can flip a choice, and a flipped choice changes that token's output
by far more than rounding.  Two places where the port once rounded
otherwise than the reference flipped choices in most of ``CASES``, more
than ``ROUTING_FLIPS_MAX`` of them in some; the witness tests below pin
both: the reference's compiled block normalizes the residual sum before
it rounds it, and its silu rounds after each step of
``1 / (1 + exp(-x))``.  What is left is a
float32 matrix product's order of summation, which rounds to another
bfloat16 value now and then.  The test counts the (token, layer) routing
choices that differ, at most ``ROUTING_FLIPS_MAX`` of them in every case
(the bar of the card's float32 check), and holds the logits only at the
positions that no difference of routing reaches (``_flipped``).

RecurrentGemma and Falcon-Mamba are held on their prefill only, at
qwen3's bar: the reference cannot decode them in bfloat16 (its float32
conv state promotes the residual stream, which breaks the ``lax.scan``
carry type), and the port decodes them in float32 after the first
recurrent layer, by jax's promotion rule.  Their recurrent blocks round as
the reference does: sigmoid, gelu, softplus and silu after every step, and
the last step of an op whose bfloat16 result is only cast to float32 (the
sigmoid's division and the gated input into the RG-LRU scan, the silu's
product into the Mamba scan) not at all, as XLA fuses it; the witnesses
below pin each op and both mixers bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CPU = torch.device("cpu")
QWEN, GRANITE = "qwen3-1.7b", "granite-moe-3b-a800m"
RGEMMA, MAMBA = "recurrentgemma-9b", "falcon-mamba-7b"
#: (prompts B, prompt length T, seed)
CASES = [(b, t, seed) for b, t in ((2, 10), (8, 16), (8, 32), (4, 64))
         for seed in (0, 1, 2)]
STEPS = 3
#: bfloat16's relative rounding, and the rounded operations the reduced
#: depth compounds (2 layers of about 6)
BF16_EPS, ROUNDED_OPS = 2.0 ** -8, 12
#: chip_smoke.py's bar for routing choices that differ
ROUTING_FLIPS_MAX = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(case):
    return "B{}-T{}-seed{}".format(*case)


def _record_reference_routes(calls):
    """Wrap the reference's ``_moe_local`` so that each call records the
    top-k expert ids its router picks on its own input (the router
    recomputed as the reference computes it, read out with a callback);
    returns a function that unwraps."""
    real = RL._moe_local

    def recording(cfg, p, x2d):
        logits = x2d @ p["router"] + p["plan_bias"]
        gates = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        _, ids = jax.lax.top_k(gates, cfg.top_k)
        jax.debug.callback(lambda a: calls.append(np.sort(np.asarray(a), -1)),
                           ids, ordered=True)
        return real(cfg, p, x2d)

    RL._moe_local = recording
    return lambda: setattr(RL, "_moe_local", real)


def _record_port_routes(calls):
    real = L.route

    def recording(cfg, p, x2d):
        out = real(cfg, p, x2d)
        calls.append(np.sort(out[2].numpy(), -1))
        return out

    L.route = recording
    return lambda: setattr(L, "route", real)


def _params(name):
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rparams = RM.init(rcfg, jax.random.PRNGKey(0))
    pparams = M.cast_params(
        lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rparams),
                             device=CPU), torch.bfloat16)
    return rcfg, pcfg, rparams, pparams


def _run(name, case):
    """Prefill and STEPS decode steps on both sides in bfloat16: (reference
    logits, port logits, reference routes, port routes), logits as float32
    numpy arrays, one per forward; routes one (N, k) array per MoE call."""
    b, t, seed = case
    rcfg, pcfg, rparams, pparams = _params(name)
    toks = np.random.default_rng(seed).integers(0, rcfg.vocab,
                                                size=(b, t)).astype(np.int32)
    want, got, rroutes, proutes = [], [], [], []
    unwrap = [_record_reference_routes(rroutes), _record_port_routes(proutes)]
    try:
        rl, rcache, _ = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                                   max_cache_len=t + STEPS,
                                   compute_dtype=jnp.bfloat16)
        pl, pcache, _ = M.prefill(pcfg, pparams,
                                  {"tokens": torch.from_numpy(toks)},
                                  max_cache_len=t + STEPS)
        want.append(np.asarray(rl, np.float32))
        got.append(pl.float().numpy())
        for step in range(STEPS):
            nxt = np.asarray(jnp.argmax(rl[:, -1], axis=-1)).astype(np.int32)[:, None]
            pos = np.full((b, 1), t + step, np.int32)
            rl, rcache, _ = RM.decode_step(
                rcfg, rparams, {"tokens": jnp.asarray(nxt),
                                "positions": jnp.asarray(pos)}, rcache,
                compute_dtype=jnp.bfloat16)
            pl, pcache, _ = M.decode_step(
                pcfg, pparams, {"tokens": torch.from_numpy(nxt),
                                "positions": torch.from_numpy(pos)}, pcache)
            want.append(np.asarray(rl, np.float32))
            got.append(pl.float().numpy())
        jax.effects_barrier()
    finally:
        for fn in unwrap:
            fn()
    return want, got, rroutes, proutes


@pytest.fixture(scope="module")
def runs():
    """Each (arch, case)'s run, made once per module."""
    made = {}

    def get(name, case):
        if (name, case) not in made:
            made[name, case] = _run(name, case)
        return made[name, case]
    return get


def _kept(ids, cfg):
    """(N, k): whether each of N tokens' routing choices fits its expert's
    capacity C, both sides' rule: fewer than C earlier tokens chose the
    same expert."""
    n, k = ids.shape
    c = max(int(np.ceil(n * k / cfg.n_experts * cfg.capacity_factor)), k)
    onehot = np.zeros((n, cfg.n_experts), np.int64)
    np.put_along_axis(onehot, ids, 1, axis=1)
    before = np.cumsum(onehot, axis=0) - onehot
    return np.take_along_axis(before, ids, axis=1) < c


def _flipped(rroutes, proutes, b):
    """(per forward, a (B, T') mask of the positions that a difference of
    routing reaches; the flips; the choices), over every MoE call.

    A flip changes its token's output, and moves the capacity slots of
    the tokens after it, so that one side may drop a token the other keeps;
    a token with either difference in a layer reaches every later position
    of its row from the next layer on, in this forward and, through the
    cache, in every later one."""
    cfg = ARCHS[GRANITE].reduced()
    n_layers = cfg.n_layers
    forwards = len(rroutes) // n_layers
    reached = [np.zeros((b, len(rroutes[f * n_layers]) // b), bool)
               for f in range(forwards)]
    flips = 0
    for i, (x, y) in enumerate(zip(rroutes, proutes)):
        f, layer = divmod(i, n_layers)
        flipped = (x != y).any(-1)
        flips += int(flipped.sum())
        differ = (flipped | (_kept(x, cfg) != _kept(y, cfg)).any(-1))
        differ = differ.reshape(b, -1)
        reached[f] |= differ
        if layer < n_layers - 1:
            for row in np.nonzero(differ.any(-1))[0]:
                reached[f][row, np.argmax(differ[row]):] = True
                for later in reached[f + 1:]:
                    later[row] = True
    return reached, flips, sum(x.shape[0] for x in rroutes)


def _assert_bf16_close(got, want, where):
    atol = ROUNDED_OPS * BF16_EPS * float(np.abs(want).max())
    np.testing.assert_allclose(got[where], want[where], atol=atol,
                               rtol=BF16_EPS)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_qwen3_bf16_logits_match_the_reference(runs, case):
    b, t, _ = case
    want, got, rroutes, proutes = runs(QWEN, case)
    assert rroutes == [] and proutes == []  # no MoE layer
    assert [w.shape for w in want] == [(b, t, 256)] + [(b, 1, 256)] * STEPS
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        _assert_bf16_close(g, w, np.ones(w.shape[:2], bool))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_granite_bf16_routing_flips_are_rare(runs, case):
    """Every MoE call of the prefill and the decode steps is recorded on
    both sides, and at most ROUTING_FLIPS_MAX of the (token, layer)
    choices differ (a token's k choices are one choice)."""
    b, t, _ = case
    want, got, rroutes, proutes = runs(GRANITE, case)
    n_layers = ARCHS[GRANITE].reduced().n_layers
    assert len(rroutes) == len(proutes) == n_layers * (1 + STEPS)
    assert [r.shape for r in rroutes] == [p.shape for p in proutes]
    _, flips, choices = _flipped(rroutes, proutes, b)
    assert choices == n_layers * (b * t + STEPS * b)
    assert flips <= ROUTING_FLIPS_MAX * choices, (flips, choices)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_granite_bf16_logits_match_where_routing_agreed(runs, case):
    want, got, rroutes, proutes = runs(GRANITE, case)
    masks, _, _ = _flipped(rroutes, proutes, case[0])
    for g, w, reached in zip(got, want, masks):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (~reached).sum() >= reached.size // 2
        _assert_bf16_close(g, w, ~reached)


def _bf16_pair(shape, seed):
    """The same bfloat16 values as a jax and a torch array."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("name", [QWEN, GRANITE])
def test_norm_reads_the_residual_sum_before_it_is_rounded(name):
    """Witness: the reference's compiled ``apply_norm(x + y)`` in bfloat16
    is the norm of the float32 sum, which XLA keeps unrounded inside the
    fusion; the port's block passes that sum to its norm, and gives the
    same bits, where the norm of the rounded sum differs."""
    rcfg, pcfg, rparams, pparams = _params(name)
    rscale = rparams["groups"]["blk0"]["norm2"]["scale"][0].astype(jnp.bfloat16)
    pscale = pparams["groups"]["blk0"]["norm2"]["scale"][0]
    (xj, xt), (yj, yt) = (_bf16_pair((2, 32, rcfg.d_model), s) for s in (3, 4))
    want = jax.jit(lambda x, y, s: RL.apply_norm(rcfg, {"scale": s}, x + y))(
        xj, yj, rscale)
    got = L.apply_norm(pcfg, {"scale": pscale},
                       xt.float() + yt.float()).to(torch.bfloat16)
    rounded_first = L.apply_norm(pcfg, {"scale": pscale}, xt + yt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(rounded_first) != _bits(want)).mean() > 0.01


@pytest.mark.parametrize("jit", [False, True])
def test_silu_rounds_as_the_reference(jit):
    """Witness: ``jax.nn.silu(g) * u`` in bfloat16, eager or compiled, is
    the port's activation times u bit for bit (1 / (1 + exp(-g)) rounded
    after every step), where the once-rounded ``F.silu`` differs."""
    cfg = ARCHS[GRANITE].reduced()
    (gj, gt), (uj, ut) = (_bf16_pair((8, 20, 32), s) for s in (5, 6))
    fn = lambda g, u: jax.nn.silu(g) * u  # noqa: E731
    want = (jax.jit(fn) if jit else fn)(gj * 2, uj)
    got = L._act(cfg, gt * 2) * ut
    once = F.silu(gt * 2) * ut
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(once) != _bits(want)).mean() > 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_backpropagates(dtype):
    """Training reaches ``_silu`` under autograd: its gradient is the
    analytic ``σ(x)(1 + x(1 − σ(x)))``, and its forward keeps the
    reference's values (the bits in bfloat16, where the witness above pins
    the rounding; float32 within 2^-21, an ulp or two of XLA's logistic).
    Gradient bars: float32 rtol 1e-6; bfloat16, whose backward rounds after
    each of about four steps, rtol 2^-6 (four roundings of 2^-8) and atol
    2^-9."""
    tdtype = getattr(torch, dtype)
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32) * 4
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    y = L._silu(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    x64 = xt.detach().double()
    sig = torch.sigmoid(x64)
    want = (sig * (1 + x64 * (1 - sig))).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g.double().numpy(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            y.detach().numpy(), np.asarray(jax.nn.silu(jnp.asarray(x))),
            rtol=2.0 ** -21, atol=0)
    else:
        np.testing.assert_allclose(g.double().numpy(), want, rtol=2.0 ** -6,
                                   atol=2.0 ** -9)
        xj = jnp.asarray(xt.detach().float().numpy(), jnp.bfloat16)
        np.testing.assert_array_equal(_bits(y.detach()), _bits(jax.nn.silu(xj)))


@pytest.mark.parametrize("name", [RGEMMA, MAMBA])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_recurrent_bf16_prefill_matches_the_reference(name, case):
    """RecurrentGemma's and Falcon-Mamba's bfloat16 prefill logits against
    the reference's at qwen3's bar (no decode: see the module docstring)."""
    b, t, seed = case
    rcfg, pcfg, rparams, pparams = _params(name)
    toks = np.random.default_rng(seed).integers(0, rcfg.vocab,
                                                size=(b, t)).astype(np.int32)
    rl, _, _ = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                          max_cache_len=t + STEPS, compute_dtype=jnp.bfloat16)
    pl, _, _ = M.prefill(pcfg, pparams, {"tokens": torch.from_numpy(toks)},
                         max_cache_len=t + STEPS)
    want, got = np.asarray(rl, np.float32), pl.float().numpy()
    assert got.shape == want.shape == (b, t, 256) and np.isfinite(got).all()
    _assert_bf16_close(got, want, np.ones((b, t), bool))


#: (the port's op, jax's) for each elementwise op of the recurrent blocks
_OPS = {
    "sigmoid": (lambda x: L._sigmoid(x), jax.nn.sigmoid),
    "gelu": (lambda x: L._gelu(x), jax.nn.gelu),
    "softplus": (lambda x: L._softplus(x), jax.nn.softplus),
    "silu": (lambda x: L._silu(x), jax.nn.silu),
}


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("op", sorted(_OPS))
def test_elementwise_op_rounds_as_the_reference(op, jit):
    """Witness: on 4,001 evenly spaced points of [-8, 8] in bfloat16, the
    port's op gives jax's bits, eager and compiled (torch's own op, rounded
    once, differs on 13-35% of them)."""
    x = np.linspace(-8.0, 8.0, 4001).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    port, ref = _OPS[op]
    got = port(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits((jax.jit(ref) if jit
                                                     else ref)(xj)))


@pytest.mark.parametrize("name", [RGEMMA, MAMBA])
def test_recurrent_mixer_rounds_as_the_reference(name):
    """Witness: the RG-LRU and Mamba mixers of the first group, compiled by
    the reference on the same bfloat16 input and weights, give the port's
    bits, but where a matrix product sums in another order and rounds to a
    neighbouring bfloat16 value (at most 1% of the outputs, each within
    2^-8 of the largest output: the scan carries an ulp of its input
    onwards); eager jax, which rounds the value that reaches the scan,
    differs on more than 5%."""
    rcfg, pcfg, rparams, pparams = _params(name)
    b, t = 4, 32
    xj, xt = _bf16_pair((b, t, rcfg.d_model), 8)
    rp = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a[0],
                      rparams["groups"]["blk0"]["mixer"])
    pp = {k: v[0] for k, v in pparams["groups"]["blk0"]["mixer"].items()}
    if name == RGEMMA:
        rstate = RM._rglru_zero_state(rcfg, b, jnp.bfloat16)
        pstate = M._rglru_zero_state(pcfg, b, torch.bfloat16, CPU)
        rfwd, pfwd = RL.rglru_fwd, L.rglru_fwd
    else:
        rstate = RM._ssm_zero_state(rcfg, b, jnp.bfloat16)
        pstate = M._ssm_zero_state(pcfg, b, torch.bfloat16, CPU)
        rfwd, pfwd = RL.mamba_fwd, L.mamba_fwd
    want = jax.jit(lambda x, p, s: rfwd(rcfg, p, x, state=s)[0])(xj, rp, rstate)
    got = pfwd(pcfg, pp, xt, state=pstate)[0]
    assert got.dtype == torch.bfloat16
    differ = _bits(got) != _bits(want)
    assert differ.mean() <= 0.01, differ.mean()
    np.testing.assert_allclose(_bits(got), _bits(want), rtol=0,
                               atol=BF16_EPS * np.abs(_bits(want)).max())
    assert (_bits(rfwd(rcfg, rp, xj, state=rstate)[0]) != _bits(want)).mean() > 0.05
