"""The reference's long shapes through the port, against the reference.

At reduced width (d_model 64, head dim 16, one or two pattern groups) on
the CPU, where the reference runs its plain path and the port its plain
versions, float32:

* a 4,200-token prefill of RecurrentGemma (its 2048-token local-attention
  window kept: the prompt crosses it twice), Falcon-Mamba and
  Granite-MoE: logits and caches;
* ``long_500k`` as the reference's dry run lowers it: eight decode steps
  at positions 524,280-524,287 from a zeroed cache of 524,288 positions,
  RecurrentGemma and Falcon-Mamba (the two sub-quadratic archs): logits
  after each step and the cache after the last.  The reference's decode
  step is compiled once with XLA's algebraic simplifier off: the pass
  rewrites RoPE's ``1 / theta ** (i / half)`` and moves a frequency by one
  float32 ulp, which at position 524,287 moves the rotated keys by up to
  2.7e-3 from the reference's own op-by-op result (the port's, to 1e-7);
  op by op, a step takes a second to run;
* ``rglru_scan``'s chunking at T of 32,768 and 524,288 (the wrapper's
  arithmetic; the kernels run only on the card);
* ``chip_smoke.py`` phase 19 rehearsed at a tiny size, its kernels'
  plain versions counting launches.

Tolerance: atol 1e-4, rtol 1e-4, as ``tests/test_torch_models.py``: float32
sums taken in another order by the two frameworks' CPU kernels.
"""
import dataclasses
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cache_specs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.rglru_scan import MAX_CHUNKS, chunking  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
RGEMMA, FMAMBA, GRANITE = ("recurrentgemma-9b", "falcon-mamba-7b",
                           "granite-moe-3b-a800m")
#: past two of RecurrentGemma's 2048-token windows
PREFILL_T = 4200
LONG_STEPS = 8


def _cut(cfg, full):
    """``cfg`` (reduced) at one pattern group plus the tail, with the full
    config's attention windows: the reduced config cuts them to 32."""
    return dataclasses.replace(
        cfg, n_layers=len(cfg.pattern) + len(cfg.tail),
        pattern=tuple(dataclasses.replace(b, window=f.window)
                      for b, f in zip(cfg.pattern, full.pattern)))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference cfg, port cfg, reference params, port params) at reduced
    width and one pattern group (RecurrentGemma's with its 2048-token
    window), made once per worker: the port's seeded ``init`` (held to the
    reference's tree by ``tests/test_torch_models.py``; the reference's
    own draws compile for seconds here), the same numbers given to both
    through ``lm_params_from_numpy``'s one-to-one layout."""
    rcfg = _cut(REF_ARCHS[name].reduced(), REF_ARCHS[name])
    pcfg = _cut(ARCHS[name].reduced(), ARCHS[name])
    tree = M._tree_map(lambda _, a: a.numpy(), M.init(
        pcfg, torch.Generator().manual_seed(0), device=CPU))
    pparams = lm_params_from_numpy(pcfg, tree, device=CPU)
    return rcfg, pcfg, jax.tree.map(jnp.asarray, tree), pparams


def _assert_close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _assert_tree_close(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k])
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            _assert_close(got[k], want[k])


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, as the suite's other workers run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_recurrentgemma_cut_keeps_the_window():
    for cfg in (_cut(REF_ARCHS[RGEMMA].reduced(), REF_ARCHS[RGEMMA]),
                _cut(ARCHS[RGEMMA].reduced(), ARCHS[RGEMMA])):
        assert cfg.n_groups == 1 and len(cfg.tail) == 2
        assert [b.window for b in cfg.pattern] == [None, None, 2048]
        assert 2 * 2048 < PREFILL_T


@pytest.mark.parametrize("name", [RGEMMA, FMAMBA, GRANITE])
def test_long_prefill_matches_the_reference(name):
    """A 4,200-token B=1 prefill into a cache of 4,208: every row's logits
    and the whole cache."""
    rcfg, pcfg, rparams, pparams = _pair(name)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(1, PREFILL_T)).astype(np.int32)
    max_len = PREFILL_T + LONG_STEPS
    want, rcache, _ = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tokens)},
                                 max_cache_len=max_len)
    got, pcache, _ = M.prefill(pcfg, pparams, {"tokens": torch.from_numpy(tokens)},
                               max_cache_len=max_len)
    assert tuple(got.shape) == (1, PREFILL_T, rcfg.vocab)
    _assert_close(got, want)
    _assert_tree_close(pcache, jax.tree.map(np.asarray, rcache))


@pytest.mark.parametrize("name", [RGEMMA, FMAMBA])
def test_long_500k_decode_matches_the_reference(name):
    """Eight decode steps at the last positions of a zeroed long_500k cache
    (B = 1, 524,288 positions), fed the reference's greedy tokens: the
    port's cache holds cache_specs' bytes, the logits of every step and
    the cache after the last match the reference's."""
    rcfg, pcfg, rparams, pparams = _pair(name)
    spec = SHAPES["long_500k"]
    assert (spec.seq_len, spec.global_batch) == (524_288, 1)
    assert pcfg.subquadratic
    rcache = RM.init_cache(rcfg, 1, spec.seq_len, jnp.float32)
    pcache = M.init_cache(pcfg, 1, spec.seq_len, torch.float32, device=CPU)
    stand_in = cache_specs(pcfg, "long_500k", torch.float32)
    assert (M._tree_map(lambda _, a: (tuple(a.shape), a.dtype), pcache)
            == M._tree_map(lambda _, a: (tuple(a.shape), a.dtype), stand_in))
    token = np.array([[7]], np.int32)
    decode = None
    for pos in range(spec.seq_len - LONG_STEPS, spec.seq_len):
        feed = {"tokens": token, "positions": np.array([[pos]], np.int32)}
        rfeed = {k: jnp.asarray(v) for k, v in feed.items()}
        if decode is None:  # compiled once, as the module docstring says
            decode = jax.jit(functools.partial(RM.decode_step, rcfg)).lower(
                rparams, rfeed, rcache).compile(
                compiler_options={"xla_disable_hlo_passes": "algsimp"})
        want, rcache, _ = decode(rparams, rfeed, rcache)
        got, same, _ = M.decode_step(pcfg, pparams, {
            k: torch.from_numpy(v) for k, v in feed.items()}, pcache)
        assert same is pcache
        _assert_close(got, want)
        token = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(
            np.int32)[:, None]
    _assert_tree_close(pcache, jax.tree.map(np.asarray, rcache))


#: rglru_scan's geometry on an H100 as ``csrc/rglru_scan.cu`` sets it: 128
#: channels a block, 8 steps loaded together, 8 blocks an SM, 132 SMs
TILE, GROUP, BLOCKS_PER_SM, SMS = 128, 8, 8, 132


@pytest.mark.parametrize("t", [32_768, 524_288])
@pytest.mark.parametrize("b, d", [(1, 4096), (4, 4096), (1, 2048), (3, 130)])
@pytest.mark.parametrize("blocks", [BLOCKS_PER_SM * SMS, SMS, 1,
                                    64 * BLOCKS_PER_SM * SMS])
def test_rglru_chunking_at_long_lengths(t, b, d, blocks):
    """At most MAX_CHUNKS chunks (and at most the C entry's 65,535), of a
    length that is a multiple of the two-group step, covering T with every
    chunk but the last whole and the last not empty."""
    chunk, k = chunking(b, t, d, TILE, GROUP, blocks)
    assert 1 <= k <= MAX_CHUNKS
    assert chunk % (2 * GROUP) == 0
    assert chunk * k >= t > chunk * (k - 1)
    # no more chunks than fill the card with blocks
    assert k <= -(-blocks // (b * -(-d // TILE)))


def test_rglru_chunking_at_recurrentgemmas_32k_prefill():
    """The served shape on an H100: 32 tiles of 128 channels, 33 chunks of
    1,008 steps (the last 512), 1,056 blocks in flight."""
    assert chunking(1, 32_768, 4096, TILE, GROUP, BLOCKS_PER_SM * SMS) == (1008, 33)


# ---------------------------------------------------------------------------
# a rehearsal of chip_smoke.py phase 19 on the CPU
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def rehearsal(monkeypatch):
    """chip_smoke on the CPU at a tiny size: the default device the CPU,
    the reference's long shapes cut to 200 positions (long_500k to 4,096),
    the three archs reduced, the card's clocks stubbed, and the four LM
    kernels replaced where the model calls them by plain versions that
    count a launch (a CPU tensor never launches a kernel)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(ROOT))
    previous = repro_torch._device.default_device()
    repro_torch.set_default_device("cpu")
    for name, t in (("prefill_32k", 200), ("decode_32k", 200),
                    ("long_500k", 4096)):
        monkeypatch.setitem(SHAPES, name, dataclasses.replace(SHAPES[name],
                                                              seq_len=t))
    for name in (RGEMMA, FMAMBA, GRANITE):
        monkeypatch.setitem(ARCHS, name, ARCHS[name].reduced())
    monkeypatch.setattr(C, "LONG_NEIGHBOURS", (5, 33, 40))
    monkeypatch.setattr(C, "LONG_ROWS", 16)
    monkeypatch.setattr(C, "card_name_and_limit", lambda: "the CPU")
    monkeypatch.setattr(C, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "time_queued_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "kernel_device_ms", lambda fn, names, **kw: None)
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.rglru_scan"), "_geometry",
        lambda index: (TILE, GROUP, BLOCKS_PER_SM * SMS))
    wrappers = C._lm_kernels()

    def counting(name, plain):
        def run(*args, **kwargs):
            wrappers[name].launches += 1
            return plain(*args, **kwargs)
        return run

    for name, op, plain in (
            ("flash_attention", "flash_attention", kref.attention_ref),
            ("rglru_scan", "rglru_scan", kref.rglru_scan_ref),
            ("mamba_scan", "mamba_scan", kref.mamba_scan_ref),
            ("moe_dispatch", "moe_dispatch", kref.moe_dispatch_ref)):
        monkeypatch.setattr(kops, op, counting(name, plain))
    yield C
    repro_torch.set_default_device(previous)


@pytest.mark.parametrize("index", range(3), ids=["19a", "19b", "19c"])
def test_phase_19_rehearses_on_the_cpu(rehearsal, index):
    """Each sub-phase serves 4 requests of 32 tokens (4 admissions, 31
    decode steps), holds each kernel its layers launch at the cut 32k
    shape, and for the sub-quadratic archs runs long_500k's 8 steps: the
    launches it counts are expected_launches' for those calls."""
    C = rehearsal
    phase, arch, cut_depth = C.LONG_ARCHS[index]
    out = C.phase_long_context(CPU, phase, arch, cut_depth)
    cfg = ARCHS[arch]
    steps = C.SERVE_NEW - 1 + (C.LONG_STEPS if cut_depth else 0)
    for name, (per_admission, per_step) in C.expected_launches(cfg).items():
        assert out["launches"][name] == 4 * per_admission + steps * per_step
    held = {"recurrentgemma-9b": {"flash_attention", "rglru_scan"},
            "falcon-mamba-7b": {"mamba_scan"},
            "granite-moe-3b-a800m": {"flash_attention", "moe_dispatch"}}
    assert set(out["kernels"]) == held[arch]
    # the plain versions against themselves, mamba_scan's on a channel
    # slice (its sums of a slice and of all channels round alike only
    # nearly)
    assert all(0.0 <= k["max_abs_err"] <= 1e-5 for k in out["kernels"].values())
