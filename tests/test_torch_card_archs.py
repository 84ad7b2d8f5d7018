"""A rehearsal of ``chip_smoke.py`` phase 18 on the CPU.

Phase 18 runs the six model families that no earlier phase takes to the
card (OLMo-1B, StableLM-1.6B, Mistral-NeMo-12B, Llama4-Scout-17B-A16E,
Phi-3-vision-4.2B, MusicGen-large).  Here each sub-phase runs on the
reduced config, in float32 on the CPU, with the kernel wrappers replaced
by counting plain versions (a CPU tensor never launches a kernel) and the
card's clocks stubbed: the serving path, the checks of the kernels at the
served shapes, the float32 cut, training and the float32 training cut
all run, and the launches the phase counts are the ones
``expected_launches`` gives.  The sizes phase 18 states for the card are
held to one card's 80 GB from the configs' parameter counts.
"""
import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the modules, which the package's functions of the same names shadow
FA = importlib.import_module("repro_torch.kernels.flash_attention")
MD = importlib.import_module("repro_torch.kernels.moe_dispatch")

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def C():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.fixture
def rehearsal(C, monkeypatch):
    """chip_smoke on the CPU: the default device the CPU, the card's clocks
    and build logs stubbed, and flash_attention and moe_dispatch replaced
    where the model calls them by plain versions that count a launch (the
    attention's also resolving its C entry, as a launch does)."""
    previous = repro_torch._device.default_device()
    repro_torch.set_default_device("cpu")

    def attention(q, k, v, causal=True, window=None, q_offset=0):
        FA._entry(q.dtype, q.shape[-1])
        FA.flash_attention.launches += 1
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    def dispatch(tokens, ids, slots, n_experts, capacity):
        MD.moe_dispatch.launches += 1
        return ref.moe_dispatch_ref(tokens, ids, slots, n_experts, capacity)

    monkeypatch.setattr(ops, "flash_attention", attention)
    monkeypatch.setattr(ops, "moe_dispatch", dispatch)
    monkeypatch.setattr(C, "card_name_and_limit", lambda: "the CPU")
    monkeypatch.setattr(C, "print_ptxas", lambda name: None)
    monkeypatch.setattr(C, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "time_alone_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "time_queued_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(C, "time_pair_ms",
                        lambda a, b, **kw: (a(), b(), (0.0, 0.0))[2])
    monkeypatch.setattr(C, "kernel_device_ms", lambda fn, names, **kw: None)
    monkeypatch.setattr(C, "cuda_core_attention", ref.attention_ref)
    monkeypatch.setattr(C, "_three_pass", lambda *a: ref.moe_dispatch_ref(*a))
    yield C
    repro_torch.set_default_device(previous)


@pytest.mark.parametrize("index", range(6), ids=lambda i: f"18{'abcdef'[i]}")
def test_phase_18_rehearses_on_the_cpu(rehearsal, index):
    C = rehearsal
    spec = C.CARD_ARCHS[index]
    cfg = C.card_arch_config(spec, reduced=True)
    traffic = C.REDUCED_TRAFFIC
    out = C.phase_card_arch(CPU, spec, reduced=True)
    per_admission = {k: v[0] for k, v in C.expected_launches(cfg).items()}
    per_step = {k: v[1] for k, v in C.expected_launches(cfg).items()}
    # the token-in archs: every prompt admitted at once into the 4 slots,
    # then one decode step a new token after the first; the stub-frontend
    # archs: one prefill, then a decode step a new token
    if cfg.frontend is None:
        admissions, steps = len(traffic["prompts"]), traffic["new_tokens"] - 1
    else:
        admissions, steps = 1, traffic["new_tokens"]
    want = {k: per_admission[k] * admissions + per_step[k] * steps
            for k in per_admission}
    assert {k: out["launches"][k] for k in want} == want
    assert out["launches"]["flash_attention"] == cfg.n_layers * admissions
    assert out["launches"]["segment_sum"] == 0
    assert out["launches"]["moe_dispatch"] == (
        cfg.n_layers * (admissions + steps) if cfg.n_experts else 0)
    assert out["flash_err"] == 0.0  # the plain version against itself
    assert ("moe" in out) == bool(cfg.n_experts)
    # every bf16 launch resolved the tensor-core kernel (the reduced
    # widths, as the full ones, are multiples of 8)
    assert out["entry"] == "flash_attention_bf16_wgmma"


def test_phase_18_served_widths_take_the_tensor_core_kernel(C):
    """At full width every family of phase 18 serves bf16 attention on the
    ``wgmma`` kernel, which phase 18 checks of each launch: Phi-3-vision's
    Dh 96 (padded to 128) as the others' 64 and 128."""
    widths = {s.arch: get_config(s.arch).head_dim_ for s in C.CARD_ARCHS}
    assert widths["phi-3-vision-4.2b"] == 96
    assert {a: FA._entry(torch.bfloat16, dh) for a, dh in widths.items()} == \
        dict.fromkeys(widths, "flash_attention_bf16_wgmma")


#: the full-width parameter counts phase 18 states, in billions, at the
#: depth it serves (Llama4-Scout: 8 of 48 layers)
SERVED_PARAMS = {"olmo-1b": 1.177, "stablelm-1.6b": 1.644,
                 "mistral-nemo-12b": 12.247, "llama4-scout-17b-a16e": 18.679,
                 "phi-3-vision-4.2b": 3.821, "musicgen-large": 3.230}


def test_phase_18_reckons_under_one_card(C):
    """Each arch's stated depth and traffic at full width: the bf16
    weights with the longest prefill's logits and the float32 serving
    cache, the float32 cut with two sets of its logits, and training's 16
    bytes a parameter, each under the card's 80 GB; what does not fit is
    not run (NeMo's and Llama4-Scout's training, Llama4-Scout's 48
    layers)."""
    assert [s.arch for s in C.CARD_ARCHS] == list(SERVED_PARAMS)
    for spec in C.CARD_ARCHS:
        cfg = C.card_arch_config(spec)
        assert round(cfg.n_params() / 1e9, 3) == SERVED_PARAMS[spec.arch]
        assert cfg.d_model == get_config(spec.arch).d_model
        reckoned = C.card_arch_bytes(spec)
        assert set(reckoned) == ({"serving", "float32 cut", "training"}
                                 if spec.train else {"serving", "float32 cut"})
        assert all(0 < v < C.CARD_BYTES for v in reckoned.values()), spec.arch
        assert max(spec.prompts) + C.SERVE_NEW <= spec.max_len
    # what is not run does not fit: training NeMo or Llama4-Scout (16 bytes
    # a parameter), and Llama4-Scout's 48 layers in bf16
    for spec in C.CARD_ARCHS:
        if spec.arch in ("mistral-nemo-12b", "llama4-scout-17b-a16e"):
            assert not spec.train and not spec.train_cut
            assert 16 * get_config(spec.arch).n_params() > C.CARD_BYTES
    llama4 = C.CARD_ARCHS[3]
    cfg = C.card_arch_config(llama4)
    assert cfg.n_groups == 2 and [b.window for b in cfg.pattern] == [
        8192, 8192, 8192, None]
    assert [b.rope for b in cfg.pattern] == [True, True, True, False]
    assert max(llama4.prompts) > 8192
    assert 2 * get_config(llama4.arch).n_params() > C.CARD_BYTES


def test_moe_cut_pins_routing_after_a_flip(rehearsal, monkeypatch, capsys):
    """The float32 MoE cut (phases 10b and 18d) where the kernels' run
    flips a routing choice: here token 5's choice in the first layer of
    every prefill that runs the attention kernel.  The flip moves other
    tokens' capacity slots, so the phase holds the logits on a further run
    with the plain run's choices pinned, at every position: on the CPU
    they equal the plain run's."""
    C = rehearsal
    from repro_torch.models import layers as L

    real_route, real_attention = L.route, ops.flash_attention
    state = {"layers": 0}

    def attention(q, k, v, **kwargs):
        state["pending"] = True  # this layer's MoE follows the kernel
        return real_attention(q, k, v, **kwargs)

    def route(cfg, p, x2d):
        gates_all, top_gates, top_ids = real_route(cfg, p, x2d)
        if state.pop("pending", False):
            state["layers"] += 1
            if state["layers"] % 4 == 1:  # the first of the cut's 4 layers
                top_ids = top_ids.clone()
                top_ids[5, 0] = (top_ids[5, 0] + 1) % cfg.n_experts
        return gates_all, top_gates, top_ids

    monkeypatch.setattr(ops, "flash_attention", attention)
    monkeypatch.setattr(L, "route", route)
    # token 5's changed state may flip its own later choices too: the bar
    # on the share of flips is not what this test holds
    monkeypatch.setattr(C, "ROUTING_FLIPS_MAX", 1.0)
    spec = C.CARD_ARCHS[3]
    cfg = C.card_arch_config(spec, reduced=True)
    C.phase_moe_model(CPU, cfg=cfg, depth=spec.cut_depth, prompt_len=40,
                      max_len=64, walls=False, phase="18d float32")
    out = capsys.readouterr().out
    assert "flipped at positions [5" in out
    assert "routing: 0 of" not in out
    for label in ("prefill", "decode step 1", "decode step 2", "decode step 3"):
        assert (f"{label} logits" in out and "(with the plain run's routing "
                "pinned): kernels vs plain max |err| 0.0 " in out)


def test_phase_18w_rehearses_on_the_cpu(C, monkeypatch):
    """The width check of phase 18 on the CPU, its wrapper a plain version
    that resolves the C entry and counts a launch as the kernel's does:
    every case passes, Dh 40, 80, 96 and 192 on the ``wgmma`` entry and Dh
    36 on the CUDA-core one, and the plain version against itself is
    exact."""
    resolved = []

    def attention(q, k, v, causal=True, window=None, q_offset=0):
        resolved.append((q.shape[-1], FA._entry(q.dtype, q.shape[-1])))
        attention.launches += 1
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    attention.launches = 0
    monkeypatch.setattr(FA, "flash_attention", attention)
    errs = C.phase_flash_widths(CPU)
    assert errs == {40: 0.0, 80: 0.0, 96: 0.0, 192: 0.0, 36: 0.0}
    assert attention.launches == len(C.FLASH_WIDTH_CASES) == len(resolved)
    assert {dh: e for dh, e in resolved} == {
        40: "flash_attention_bf16_wgmma", 80: "flash_attention_bf16_wgmma",
        96: "flash_attention_bf16_wgmma", 192: "flash_attention_bf16_wgmma",
        36: "flash_attention_bf16"}
