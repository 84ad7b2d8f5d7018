"""The reference's default serving dtype, float32, through the port.

On the CPU, where the reference runs its plain path and the port its
plain versions, float32:

* the four archs ``chip_smoke.py`` phase 20 serves (RecurrentGemma-9B,
  Falcon-Mamba-7B, Granite-MoE-3B-A800M, Qwen3-1.7B) at their real depth
  (38, 64, 32, 28 layers: the group loop and RecurrentGemma's tail at
  full length) and reduced width (d_model 64): a 40-token prefill and
  three decode steps against the reference's ``model.prefill`` and
  ``decode_step``, logits and the final cache;
* the serving launcher at its defaults (8 requests, 4 slots, ``max_len``
  256, 16 new tokens, seed 0) against the reference's launcher on the same
  weights: the request stream, every request's tokens and ``ttft_steps``,
  and the decode steps.  RecurrentGemma is left out: the reference's
  engine drops its tail blocks' recurrent state (ROADMAP.md §3);
* the float32 init cast to bfloat16 equals a bfloat16 init bit for bit,
  which lets phase 20's float32 weights serve the bf16 phases after it;
* ``chip_smoke.trace_complete``, the rule that keeps a device time from
  being read off a profiler trace that dropped launches, on made-up
  counts;
* phase 20 rehearsed on the reduced configs, its kernels' plain versions
  counting launches and resolving their float32 C entries.

Tolerance: atol 1e-4, rtol 1e-4, as ``tests/test_torch_models.py``: float32
sums taken in another order by the two frameworks' CPU kernels.
"""
import contextlib
import dataclasses
import functools
import importlib
import signal
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as ref_launcher  # noqa: E402
import repro_torch  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
RGEMMA, FMAMBA, GRANITE, QWEN = ("recurrentgemma-9b", "falcon-mamba-7b",
                                 "granite-moe-3b-a800m", "qwen3-1.7b")
FOUR = (RGEMMA, FMAMBA, GRANITE, QWEN)
PROMPT_T, STEPS = 40, 3
ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _time_limit(seconds):
    """Fail the test where it runs past ``seconds`` (SIGALRM: tests run in
    their process's main thread), as the whole suite has a limit of its
    own."""
    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, as the suite's other workers run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _full_depth(cfg, full):
    """``cfg`` (reduced) at the full config's depth."""
    return dataclasses.replace(cfg, n_layers=full.n_layers)


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


@pytest.mark.parametrize("name", FOUR)
def test_full_depth_float32_matches_the_reference(name):
    """Reduced width at the real depth: the port's seeded float32 init
    given to both packages, a 40-token prefill and three decode steps fed
    the reference's greedy tokens; every logit and the cache after the
    last step."""
    with _time_limit(120):
        _full_depth_against_the_reference(name)


def _full_depth_against_the_reference(name):
    rcfg = _full_depth(REF_ARCHS[name].reduced(), REF_ARCHS[name])
    pcfg = _full_depth(ARCHS[name].reduced(), ARCHS[name])
    assert pcfg.n_layers == {RGEMMA: 38, FMAMBA: 64, GRANITE: 32,
                             QWEN: 28}[name]
    tree = M._tree_map(lambda _, a: a.numpy(), M.init(
        pcfg, torch.Generator().manual_seed(0), device=CPU))
    pparams = lm_params_from_numpy(pcfg, tree, device=CPU)
    rparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(1, PROMPT_T)).astype(np.int32)
    max_len = PROMPT_T + STEPS
    want, rcache, _ = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tokens)},
                                 max_cache_len=max_len)
    got, pcache, _ = M.prefill(pcfg, pparams,
                               {"tokens": torch.from_numpy(tokens)},
                               max_cache_len=max_len)
    _assert_close(got, want)
    decode = jax.jit(functools.partial(RM.decode_step, rcfg))
    token = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    for pos in range(PROMPT_T, PROMPT_T + STEPS):
        feed = {"tokens": token[:, None], "positions": np.array([[pos]],
                                                                np.int32)}
        want, rcache, _ = decode(rparams, {k: jnp.asarray(v)
                                           for k, v in feed.items()}, rcache)
        got, same, _ = M.decode_step(pcfg, pparams, {
            k: torch.from_numpy(v) for k, v in feed.items()}, pcache)
        assert same is pcache
        _assert_close(got, want)
        token = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    _assert_tree_close(pcache, jax.tree.map(np.asarray, rcache))


def _reference_launcher(arch, monkeypatch):
    """The reference launcher's ``main(["--arch", arch, "--reduced"])``:
    (its weights, the requests it submitted, those it finished, its
    engine's decode steps), read through a subclass of its engine."""
    seen = {}

    class Engine(ref_launcher.ServeEngine):
        def __init__(self, cfg, params, scfg):
            super().__init__(cfg, params, scfg)
            seen.update(params=params, engine=self, submitted=[])

        def submit(self, req):
            seen["submitted"].append(req)
            super().submit(req)

        def run(self, *args, **kwargs):
            seen["done"] = super().run(*args, **kwargs)
            return seen["done"]

    monkeypatch.setattr(ref_launcher, "ServeEngine", Engine)
    ref_launcher.main(["--arch", arch, "--reduced"])
    return (jax.tree.map(np.asarray, seen["params"]), seen["submitted"],
            seen["done"], seen["engine"].step_count)


@pytest.mark.parametrize("arch", [QWEN, FMAMBA])
def test_launch_serve_defaults_match_the_reference_launcher(arch, monkeypatch,
                                                            capsys):
    """Both launchers at their shared defaults on the same weights (the
    reference's ``M.init(cfg, PRNGKey(0))``, given to the port's launcher
    through its module's ``M.init``): the same request stream, and every
    request's tokens, ``ttft_steps`` and the decode steps equal."""
    with _time_limit(120):
        tree, submitted, want, steps = _reference_launcher(arch, monkeypatch)
    drawn = []

    def init(cfg, gen, device=None, dtype=torch.float32):
        drawn.append((cfg.name, dtype))
        return lm_params_from_numpy(cfg, tree, device=device)

    monkeypatch.setattr(launcher.M, "init", init)
    engines = []
    real_engine = launcher.ServeEngine

    def engine(*args, **kwargs):
        engines.append(real_engine(*args, **kwargs))
        return engines[-1]

    monkeypatch.setattr(launcher, "ServeEngine", engine)
    got = launcher.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert drawn == [(ARCHS[arch].reduced().name, torch.float32)]
    assert engines[0].scfg.compute_dtype == torch.float32
    out = capsys.readouterr().out
    assert (f"{ARCHS[arch].reduced().name} on cpu: {len(want)} requests, "
            f"{len(want) * 16} tokens") in out
    assert len(submitted) == len(got) == len(want) == 8
    by_rid = {r.rid: r for r in got}
    for ref_req in submitted:
        req = by_rid[ref_req.rid]
        np.testing.assert_array_equal(req.prompt, ref_req.prompt)
        assert req.max_new_tokens == ref_req.max_new_tokens == 16
    assert [r.rid for r in got] == [r.rid for r in want]
    for mine, theirs in zip(got, want):
        assert mine.output == [int(t) for t in theirs.output], mine.rid
        assert mine.ttft_steps == theirs.ttft_steps
    assert engines[0].step_count == steps


@pytest.mark.parametrize("name", FOUR)
def test_float32_init_casts_to_the_bf16_weights(name):
    """``cast_params(init(float32), bfloat16)`` is ``init(bfloat16)`` bit
    for bit, leaf by leaf (``final_norm`` float32 in both): every random
    leaf is drawn in float32 and cast, and every constant leaf rounds
    alike."""
    cfg = ARCHS[name].reduced()
    f32 = M.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    bf16 = M.init(cfg, torch.Generator().manual_seed(0), device=CPU,
                  dtype=torch.bfloat16)
    cast = M.cast_params(f32, torch.bfloat16)
    leaves = []

    def same(path, a):
        b = M._at(cast, path)
        leaves.append(path)
        assert a.dtype == b.dtype and torch.equal(a, b), path

    M._tree_map(same, bf16)
    assert ("final_norm", "scale") in leaves
    assert M._at(bf16, ("final_norm", "scale")).dtype == torch.float32


@pytest.fixture(scope="module")
def C():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("recorded, counted, complete", [
    ({"flash_attention_kernel_tf32x3": 12}, 12, True),
    ({"flash_attention_kernel_tf32x3": 11}, 12, False),  # one launch dropped
    ({"flash_attention_kernel_tf32x3": 0}, 12, False),   # none recorded
    ({"flash_attention_kernel_tf32x3": 0}, 0, False),    # nothing launched
    # rglru_scan at a prefill (both kernels a call) and at a decode step
    # (the rescan alone)
    ({"rglru_scan_summary_kernel": 26, "rglru_scan_output_kernel": 26}, 26,
     True),
    ({"rglru_scan_summary_kernel": 0, "rglru_scan_output_kernel": 5}, 5, True),
    ({"rglru_scan_summary_kernel": 25, "rglru_scan_output_kernel": 26}, 26,
     False),
    ({"rglru_scan_summary_kernel": 26, "rglru_scan_output_kernel": 25}, 26,
     False),
    # moe_dispatch: two passes at a prefill, the small path at decode
    ({"moe_dispatch_index_kernel": 32, "moe_dispatch_gather_kernel": 32,
      "moe_dispatch_small_kernel": 0}, 32, True),
    ({"moe_dispatch_index_kernel": 0, "moe_dispatch_gather_kernel": 0,
      "moe_dispatch_small_kernel": 32}, 32, True),
    ({"moe_dispatch_index_kernel": 32, "moe_dispatch_gather_kernel": 31,
      "moe_dispatch_small_kernel": 0}, 32, False),
    # more recorded than counted: the trace holds launches no wrapper made
    ({"mamba_scan_kernel": 130}, 128, False),
])
def test_trace_complete_reads_no_partial_trace(C, recorded, counted, complete):
    assert C.trace_complete(recorded, counted) is complete


# ---------------------------------------------------------------------------
# a rehearsal of chip_smoke.py phase 20 on the CPU
# ---------------------------------------------------------------------------

#: the kernels' modules, which the package's functions of the same names
#: shadow
MODULES = {name: importlib.import_module(f"repro_torch.kernels.{name}")
           for name in ("flash_attention", "rglru_scan", "mamba_scan",
                        "moe_dispatch")}


@pytest.fixture
def rehearsal(C, monkeypatch):
    """chip_smoke on the CPU: the default device the CPU, the four archs
    reduced (the holds' prompts 40 tokens), and the four LM kernels
    replaced where the model calls them by plain versions that count a
    launch and resolve their C entry through their module's ``_kernel``,
    as a launch does (``_kernel`` itself stubbed: it builds)."""
    previous = repro_torch._device.default_device()
    repro_torch.set_default_device("cpu")
    for name in FOUR:
        monkeypatch.setitem(ARCHS, name, ARCHS[name].reduced())
    monkeypatch.setattr(C, "FLOAT32_ARCHS", tuple(
        (phase, arch, PROMPT_T) for phase, arch, _ in C.FLOAT32_ARCHS))
    wrappers = C._lm_kernels()
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "_kernel", lambda key: None)

    def counting(name, plain, key):
        def run(*args, **kwargs):
            MODULES[name]._kernel(key(*args))
            wrappers[name].launches += 1
            return plain(*args, **kwargs)
        return run

    fa = MODULES["flash_attention"]
    for name, plain, key in (
            ("flash_attention", kref.attention_ref,
             lambda q, *a: fa._entry(q.dtype, q.shape[-1])),
            ("rglru_scan", kref.rglru_scan_ref, lambda x, *a: x.dtype),
            ("mamba_scan", kref.mamba_scan_ref, lambda x, *a: x.dtype),
            ("moe_dispatch", kref.moe_dispatch_ref, lambda t, *a: t.dtype)):
        monkeypatch.setattr(kops, name, counting(name, plain, key))
    yield C
    repro_torch.set_default_device(previous)


@pytest.mark.parametrize("index", range(4), ids=["20a", "20b", "20c", "20d"])
def test_phase_20_rehearses_on_the_cpu(rehearsal, index):
    """Each sub-phase serves the launcher's 8 requests of 16 tokens in
    float32 (every launch on its float32 C entry, the launches
    ``expected_launches``' for 8 admissions and the decode steps), then
    holds the kernels' plain versions against the plain path at the arch's
    depth; 20a also hands on its weights' bf16 cast, a bf16 init's bit for
    bit."""
    C = rehearsal
    phase, arch, prompt_len = C.FLOAT32_ARCHS[index]
    with _time_limit(60):
        out = C.phase_float32_serving(CPU, phase, arch, prompt_len,
                                      hand_on=index == 0)
    cfg = ARCHS[arch]
    steps = out["numbers"]["decode_steps"]
    assert steps >= C.LAUNCHER_NEW - 1
    assert out["launches"] == {
        name: C.LAUNCHER_REQUESTS * per_admission + steps * per_step
        for name, (per_admission, per_step)
        in C.expected_launches(cfg).items()}
    if index == 0:
        bf16 = M.init(cfg, torch.Generator().manual_seed(0), device=CPU,
                      dtype=torch.bfloat16)
        M._tree_map(lambda path, a: torch.equal(a, M._at(out["bf16"], path))
                    or pytest.fail(f"{path} differs"), bf16)
    else:
        assert out["bf16"] is None
