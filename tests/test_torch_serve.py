"""The port's serving engine and launcher against the reference.

* On the reduced RecurrentGemma the port's engine gives exactly the greedy
  tokens of re-running the reference's ``forward`` — the case where the
  reference engine loses the tail blocks' recurrent state.
* On the reduced qwen3 (no tail) it gives exactly the reference engine's
  tokens, and on the reduced Falcon-Mamba (every cache leaf a recurrent
  state stacked over groups) both the reference engine's tokens and those
  of greedy re-running of the port's own ``forward``.
* On the reduced Granite-MoE it gives exactly the reference engine's
  tokens, and so on the reduced OLMo, StableLM, Mistral-NeMo and
  Llama4-Scout (a prompt past its 32-token window).  Expert capacity couples the tokens routed together, so a
  decode step (every slot's token routed at once, empty slots' included)
  differs by design from re-running ``forward`` on the whole sequence:
  the reference engine, which has no tail to lose, is the oracle.
* Continuous batching, sampling, and the entry points' refusal to fall
  back to the CPU quietly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine  # noqa: E402

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


def _pair(name, seed=0):
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    rparams = RM.init(rcfg, jax.random.PRNGKey(seed))
    pparams = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, rparams),
                                   device=CPU)
    return rcfg, pcfg, rparams, pparams


@pytest.fixture(scope="module")
def rgemma():
    return _pair("recurrentgemma-9b")


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen3-1.7b")


@pytest.fixture(scope="module")
def falcon():
    return _pair("falcon-mamba-7b")


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-moe-3b-a800m")


#: reference greedy tokens by (config, prompt, n), shared by the tests of
#: one worker: each forward of a new length compiles anew
_GREEDY = {}


def _greedy(rcfg, rparams, prompt, n):
    """Reference greedy decoding by re-running the whole forward per token."""
    key = (rcfg, tuple(int(t) for t in prompt), n)
    if key not in _GREEDY:
        toks, out = list(key[1]), []
        for _ in range(n):
            logits, _, _ = RM.forward(
                rcfg, rparams, {"tokens": jnp.asarray(np.asarray(toks)[None])})
            nxt = int(np.argmax(np.asarray(logits[0, -1])))
            out.append(nxt)
            toks.append(nxt)
        _GREEDY[key] = out
    return list(_GREEDY[key])


def test_recurrentgemma_engine_matches_greedy_forward(rgemma):
    """One request into 2 slots: the tail blocks' state must reach decode."""
    rcfg, pcfg, rparams, pparams = rgemma
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = ServeEngine(pcfg, pparams, ServeConfig(slots=2, max_len=64), device=CPU)
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert req.output == _greedy(rcfg, rparams, prompt, 6)


def test_engine_prefill_unembeds_the_last_row_only(rgemma, monkeypatch):
    """Each admission's ``M.prefill`` asks for the last row alone and
    returns (1, 1, V) logits, not (1, T, V); the tokens stay the greedy
    reference's."""
    rcfg, pcfg, rparams, pparams = rgemma
    real, seen = M.prefill, []

    def prefill(*args, **kwargs):
        logits, cache, aux = real(*args, **kwargs)
        seen.append((kwargs.get("last_only"), tuple(logits.shape)))
        return logits, cache, aux

    monkeypatch.setattr(M, "prefill", prefill)
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = ServeEngine(pcfg, pparams, ServeConfig(slots=2, max_len=64), device=CPU)
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=6),
            Request(rid=1, prompt=np.arange(3, 20, dtype=np.int32),
                    max_new_tokens=2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert seen == [(True, (1, 1, rcfg.vocab))] * 2
    assert reqs[0].output == _greedy(rcfg, rparams, prompt, 6)


@pytest.mark.parametrize("slots", [2, 3])
def test_recurrentgemma_concurrent_requests_stay_apart(rgemma, slots):
    """Several requests sharing the decode grid (slots == 3 is where the
    reference would merge a tail leaf on the wrong axis): each gives its
    own greedy tokens."""
    rcfg, pcfg, rparams, pparams = rgemma
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
               for n in (5, 11, 3, 8)]
    eng = ServeEngine(pcfg, pparams, ServeConfig(slots=slots, max_len=48),
                      device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == 4
    for r in reqs:
        assert r.output == _greedy(rcfg, rparams, r.prompt, r.max_new_tokens), r.rid


def test_qwen3_engine_matches_reference_engine(qwen):
    rcfg, pcfg, rparams, pparams = qwen
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 3, 7, 12)]
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(slots=2, max_len=64))
    port = ServeEngine(pcfg, pparams, ServeConfig(slots=2, max_len=64), device=CPU)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=3 + i)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i)
                 for i, p in enumerate(prompts)]
    for r in ref_reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    ref_done, port_done = ref.run(), port.run()
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(ref_reqs, port_reqs):
        assert b.output == a.output and b.ttft_steps == a.ttft_steps
    assert port.step_count == ref.step_count


@pytest.mark.parametrize("name,lengths", [
    ("olmo-1b", (5, 9, 3, 7)), ("stablelm-1.6b", (5, 9, 3, 7)),
    ("mistral-nemo-12b", (5, 9, 3, 7)),
    # one prompt past the reduced 32-token window of the RoPE layers
    ("llama4-scout-17b-a16e", (35, 9, 3, 7))])
def test_token_in_engine_matches_reference_engine(name, lengths):
    """The token-in archs that serve on the card beside qwen3: tokens, time
    to first token and step count equal the reference engine's, at 2
    slots.  Llama4-Scout's top-1 MoE routes every slot's token in a decode
    step together, as the reference's does."""
    rcfg, pcfg, rparams, pparams = _pair(name)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
               for n in lengths]
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(slots=2, max_len=48))
    port = ServeEngine(pcfg, pparams, ServeConfig(slots=2, max_len=48),
                       device=CPU)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=3 + i)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i)
                 for i, p in enumerate(prompts)]
    for r in ref_reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    ref_done, port_done = ref.run(), port.run()
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(ref_reqs, port_reqs):
        assert b.output == a.output and b.ttft_steps == a.ttft_steps, b.rid
    assert port.step_count == ref.step_count


def _port_greedy(cfg, params, prompt, n):
    """Greedy decoding by re-running the port's whole forward per token."""
    toks, out = [int(t) for t in prompt], []
    for _ in range(n):
        logits, _, _ = M.forward(cfg, params,
                                 {"tokens": torch.tensor([toks])})
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("slots", [2, 3])
def test_falcon_mamba_engine_matches_reference_engine(falcon, slots):
    """Each slot's conv and SSM state are merged on axis 1 of the
    group-stacked leaves and carried through decode: the tokens, the time
    to first token and the step count equal the reference engine's, and
    each request's tokens equal greedy re-running of ``M.forward``."""
    rcfg, pcfg, rparams, pparams = falcon
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
               for n in (6, 1, 13, 4, 9)]
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(slots=slots, max_len=48))
    port = ServeEngine(pcfg, pparams, ServeConfig(slots=slots, max_len=48),
                       device=CPU)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=2 + i)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new_tokens=2 + i)
                 for i, p in enumerate(prompts)]
    for r in ref_reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    ref_done, port_done = ref.run(), port.run()
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(ref_reqs, port_reqs):
        assert b.output == a.output and b.ttft_steps == a.ttft_steps, b.rid
        assert b.output == _port_greedy(pcfg, pparams, b.prompt,
                                        b.max_new_tokens), b.rid
    assert port.step_count == ref.step_count


@pytest.mark.parametrize("slots", [2, 3])
def test_granite_engine_matches_reference_engine(granite, slots):
    """Tokens, time to first token and step count equal the reference
    engine's.  At 3 slots a decode step routes 3 tokens × top-2 into 8
    experts of capacity C = 2, so an empty slot's dummy token can take an
    active slot's place, as in the reference."""
    rcfg, pcfg, rparams, pparams = granite
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
               for n in (7, 1, 12, 4, 9)]
    ref = RefServeEngine(rcfg, rparams, RefServeConfig(slots=slots, max_len=48))
    port = ServeEngine(pcfg, pparams, ServeConfig(slots=slots, max_len=48),
                       device=CPU)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=3 + i)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i)
                 for i, p in enumerate(prompts)]
    for r in ref_reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    ref_done, port_done = ref.run(), port.run()
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(ref_reqs, port_reqs):
        assert b.output == a.output and b.ttft_steps == a.ttft_steps, b.rid
    assert port.step_count == ref.step_count


def test_continuous_batching_serves_all(qwen):
    """tests/test_substrate.py's continuous-batching test, on the port."""
    _, cfg, _, params = qwen
    eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=64), device=CPU)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                max_new_tokens=4 + i)
        for i, n in enumerate([5, 9, 3, 7])
    ]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 4
    for r in reqs:
        assert r.done and len(r.output) == r.max_new_tokens
        assert r.ttft_steps is not None


def test_sampling_is_seeded_and_in_range(qwen):
    _, cfg, _, params = qwen

    def run(seed):
        eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=32, seed=seed),
                          device=CPU)
        reqs = [Request(rid=i, prompt=np.arange(1, 6, dtype=np.int32) + i,
                        max_new_tokens=8, temperature=1.5) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    a, b = run(3), run(3)
    assert a == b
    assert all(0 <= t < cfg.vocab for out in a for t in out)


def test_prompt_too_long_raises(qwen):
    _, cfg, _, params = qwen
    eng = ServeEngine(cfg, params, ServeConfig(slots=1, max_len=8), device=CPU)
    eng.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(ValueError, match="max_len"):
        eng.run()


def test_launch_serve_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                              "--device", "cpu", "--requests", "3",
                              "--slots", "2", "--max-new", "4", "--max-len", "64"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "recurrentgemma-9b-smoke on cpu" in capsys.readouterr().out


def test_launch_serve_falcon_mamba_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                              "--device", "cpu"])
    assert len(done) == 8 and all(len(r.output) == 16 for r in done)
    assert "falcon-mamba-7b-smoke on cpu" in capsys.readouterr().out


def test_launch_serve_granite_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                              "--device", "cpu", "--requests", "5",
                              "--slots", "3", "--max-new", "6"])
    assert len(done) == 5 and all(len(r.output) == 6 for r in done)
    assert "granite-moe-3b-a800m-smoke on cpu" in capsys.readouterr().out


@pytest.fixture
def no_cuda(monkeypatch):
    """The process default device is the card, and there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = repro_torch.default_device()
    repro_torch.set_default_device("cuda")
    yield
    repro_torch.set_default_device(before)


def test_entry_points_raise_without_cuda(no_cuda, qwen):
    _, cfg, _, params = qwen
    gen = torch.Generator(device="cpu").manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, ServeConfig(slots=1, max_len=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--requests", "1"])
    # asking for the CPU is the fix the message names
    assert M.init(cfg, gen, device="cpu")["embed"].device.type == "cpu"
    ServeEngine(cfg, params, ServeConfig(slots=1, max_len=16), device="cpu")
