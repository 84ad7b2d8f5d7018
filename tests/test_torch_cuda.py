"""The port's Hopper kernels on a CUDA card, against their plain versions.

Every test here is marked ``cuda`` and skips where no card is present: a
CUDA kernel has no CPU mode.  The file needs neither ``jax`` nor the
reference package, so it also runs on a machine with only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import _entry as flash_entry  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.moe_dispatch import compute_slots, moe_dispatch  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, mamba_scan_ref,  # noqa: E402
                                     moe_dispatch_ref, rglru_scan_ref,
                                     segment_sum_ref)
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_sum  # noqa: E402
from repro_torch.mapreduce.apps import word_count  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

#: float32 atomics sum in an order that changes from run to run: sums of
#: N(0,1) rows agree to atol 1e-4 (the reference's kernel tolerance); a
#: bfloat16 output may round to the neighbouring bf16 value (2^-8
#: relative).
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}


#: the reference's kernel tolerances (tests/test_kernels.py:19-20): the
#: kernels sum in another order than the plain versions, in float32.
KTOL = {"float32": dict(atol=2e-5, rtol=1e-2),
        "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, s, ids_kind, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, d)).astype(np.float32)
    if ids_kind == "out_of_range":
        ids = rng.integers(-2, s + 3, size=n)
    else:
        ids = rng.integers(0, s, size=n)
        if ids_kind == "sorted":
            ids = np.sort(ids)
    return values, ids.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,s,ids_kind", [
    (44_000, 1, 21_000, "sorted"),
    (44_000, 1, 21_000, "out_of_range"),
    (65_536, 128, 4_096, "sorted"),
    (1_000, 33, 17, "unsorted"),
])
def test_kernel_matches_plain_version(card, n, d, s, ids_kind, dtype):
    values, ids = _inputs(n, d, s, ids_kind)
    v = torch.from_numpy(values).to(card, getattr(torch, dtype))
    i = torch.from_numpy(ids).to(card)
    before = segment_sum.launches
    got = segment_sum(v, i, s)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    want = segment_sum_ref(v, i, s)
    assert got.dtype == v.dtype and tuple(got.shape) == (s, d)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    v = torch.ones(64, 2, device=card)
    i = torch.zeros(64, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        segment_sum(v, i.long(), 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        segment_sum(v.double(), i, 3)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum(v[::2], i[::2], 3)
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        segment_sum(v[:, 0], i, 3)
    with pytest.raises(ValueError, match="segment_ids on cpu"):
        segment_sum(v, i.cpu(), 3)


def test_word_count_reduce_runs_the_kernel(card):
    """Word count's reduce on the card: one launch, and the integer counts
    of the CPU path exactly (float32 sums below 2^24)."""
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 5_000, size=40_000)).astype(np.int64)
    counts = rng.integers(1, 50, size=keys.shape[0]).astype(np.int64)
    before = segment_sum.launches
    uniq, sums = word_count(device=card).reduce_fn(keys, counts)
    assert segment_sum.launches == before + 1
    want_uniq, want_sums = word_count(device="cpu").reduce_fn(keys, counts)
    np.testing.assert_array_equal(uniq, want_uniq)
    np.testing.assert_array_equal(sums, want_sums)
    # the plain version on the card, selected explicitly, launches nothing
    plain = ops.sorted_segment_sum(torch.ones(4, 1, device=card),
                                   torch.zeros(4, dtype=torch.int32, device=card),
                                   1, use_kernel=False)
    assert float(plain[0, 0]) == 4.0
    assert segment_sum.launches == before + 1


# (B, Hq, Hkv, T, S, Dh, causal, window, q_offset): the reference kernel
# tests' table, then RecurrentGemma's shapes (MQA, Dh 256, window) with a
# ragged last tile, and a prompt shorter than one tile
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 100, 100, 32, True, None, 0),
    (1, 4, 1, 64, 256, 64, True, None, 192),
    (2, 4, 2, 128, 128, 64, True, 48, 0),
    (1, 2, 2, 96, 200, 128, False, None, 0),
    (1, 16, 4, 256, 256, 64, True, 128, 0),
    (1, 16, 1, 300, 300, 256, True, 64, 0),
    (1, 16, 1, 17, 17, 256, True, 2048, 0),
    (2, 4, 1, 33, 33, 16, True, 32, 0),
    (1, 4, 1, 8, 40, 80, True, 16, 32),
]
# the two served bf16 shapes at reduced T, T and S no multiple of any tile
# (Granite: GQA 24/8, Dh 64, causal; RecurrentGemma: MQA, Dh 256, window),
# and a decode-like offset with S > T at Dh 256 with a window
SERVED_ATTN_CASES = [
    (1, 24, 8, 520, 520, 64, True, None, 0),
    (1, 16, 1, 700, 700, 256, True, 256, 0),
    (1, 4, 1, 100, 1300, 256, True, 256, 1200),
]


def _normal(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,Dh,causal,window,qoff",
                         ATTN_CASES + SERVED_ATTN_CASES)
def test_flash_attention_matches_plain_version(card, dtype, B, Hq, Hkv, T, S,
                                               Dh, causal, window, qoff):
    q = _normal((B, Hq, T, Dh), 0, card, dtype)
    k = _normal((B, Hkv, S, Dh), 1, card, dtype)
    v = _normal((B, Hkv, S, Dh), 2, card, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, q_offset=qoff)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, q_offset=qoff)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **KTOL[dtype])


@pytest.mark.parametrize("Dh,entry", [
    (64, "flash_attention_bf16_wgmma"), (128, "flash_attention_bf16_wgmma"),
    (256, "flash_attention_bf16_wgmma"), (48, "flash_attention_bf16"),
    (96, "flash_attention_bf16"), (200, "flash_attention_bf16"),
])
def test_flash_attention_bf16_width_rule(card, Dh, entry):
    """Both sides of the head-width rule in bf16: the tensor-core kernel at
    64, 128 and 256, the CUDA-core kernel elsewhere; both match the plain
    version."""
    assert flash_entry(torch.bfloat16, Dh) == entry
    q = _normal((1, 4, 150, Dh), 0, card, "bfloat16")
    k = _normal((1, 2, 150, Dh), 1, card, "bfloat16")
    v = _normal((1, 2, 150, Dh), 2, card, "bfloat16")
    got = flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True, window=100)
    torch.testing.assert_close(got.float(), want.float(), **KTOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,Dh,causal", [(4, 2, 64, True),
                                              (4, 1, 256, False)])
def test_flash_attention_reads_no_keys_past_s(card, dtype, Hq, Hkv, Dh,
                                              causal):
    """S = 77 is no multiple of a kv tile, so batch row 0's last tile runs
    past its keys: those rows must be zeros, not batch row 1's, whose V is
    inf.  Row 0's output equals the plain version's and is finite."""
    q = _normal((2, Hq, 40, Dh), 0, card, dtype)
    k = _normal((2, Hkv, 77, Dh), 1, card, dtype)
    v = _normal((2, Hkv, 77, Dh), 2, card, dtype)
    v[1] = float("inf")
    got = flash_attention(q, k, v, causal=causal, q_offset=37)
    torch.cuda.synchronize()
    want = attention_ref(q[:1], k[:1], v[:1], causal=causal, q_offset=37)
    assert bool(torch.isfinite(got[0]).all())
    torch.testing.assert_close(got[:1].float(), want.float(), **KTOL[dtype])


def test_flash_attention_fully_masked_rows_give_zero(card):
    """Queries whose window lies wholly past the keys see nothing: 0."""
    q = _normal((1, 2, 8, 32), 0, card, "float32")
    k = _normal((1, 1, 4, 32), 1, card, "float32")
    out = flash_attention(q, k, k, causal=True, window=2, q_offset=10)
    torch.cuda.synchronize()
    assert bool(torch.all(out == 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D,with_h0", [
    (2, 64, 32, False), (1, 100, 64, True), (1, 50, 16, False),
    (1, 3000, 4096, True), (4, 1, 4096, True), (3, 7, 33, True),
])
def test_rglru_scan_matches_plain_version(card, dtype, B, T, D, with_h0):
    x = _normal((B, T, D), 0, card, dtype)
    a = torch.sigmoid(_normal((B, T, D), 1, card, dtype))
    h0 = _normal((B, D), 2, card, "float32") if with_h0 else None
    before = rglru_scan.launches
    y, h_t = rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    y_ref, h_ref = rglru_scan_ref(x, a, h0)
    assert y.dtype == x.dtype and h_t.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **KTOL[dtype])
    torch.testing.assert_close(h_t, h_ref, **KTOL[dtype])


def test_rglru_scan_carries_state(card):
    """Two halves with the carried state == the whole sequence."""
    x = _normal((1, 48, 32), 0, card, "float32")
    a = torch.sigmoid(_normal((1, 48, 32), 1, card, "float32"))
    y_full, h_full = rglru_scan(x, a)
    y1, s = rglru_scan(x[:, :24].contiguous(), a[:, :24].contiguous())
    y2, s2 = rglru_scan(x[:, 24:].contiguous(), a[:, 24:].contiguous(), h0=s)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-5, rtol=0)
    torch.testing.assert_close(s2, h_full, atol=1e-5, rtol=0)


def test_attention_and_scan_wrappers_raise(card):
    q = torch.zeros(1, 4, 8, 16, device=card)
    k = torch.zeros(1, 2, 8, 16, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="k dtype"):
        flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3))
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention(q, torch.zeros(1, 3, 8, 16, device=card),
                        torch.zeros(1, 3, 8, 16, device=card))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 4, 512, device=card)
        flash_attention(big, big, big)
    x = torch.zeros(2, 5, 8, device=card)
    with pytest.raises(TypeError, match="h0 dtype"):
        rglru_scan(x, x, torch.zeros(2, 8, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="h0 must be"):
        rglru_scan(x, x, torch.zeros(2, 5, device=card))
    with pytest.raises(TypeError, match="a dtype"):
        rglru_scan(x, x.bfloat16())
    with pytest.raises(ValueError, match="a on cpu"):
        rglru_scan(x, x.cpu())


def test_recurrentgemma_path_runs_the_kernels(card):
    """The reduced RecurrentGemma in float32: prefill and three decode steps
    launch the kernels (2 attention and 6 RG-LRU layers) and agree with the
    plain versions to atol/rtol 1e-4 (float32 sums in another order, over 8
    layers)."""
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    gen = torch.Generator(device=card).manual_seed(0)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40))).to(card)
    runs = {}
    for use_kernels in (True, False):
        before = (flash_attention.launches, rglru_scan.launches)
        logits, cache, _ = M.prefill(cfg, params, {"tokens": toks},
                                     max_cache_len=64, use_kernels=use_kernels)
        outs = [logits]
        for i in range(3):
            batch = {"tokens": toks[:, i:i + 1],
                     "positions": torch.full((2, 1), 40 + i, device=card)}
            outs.append(M.decode_step(cfg, params, batch, cache,
                                      use_kernels=use_kernels)[0])
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    rglru_scan.launches - before[1])
        assert launched == ((2, 6 * 4) if use_kernels else (0, 0))
        runs[use_kernels] = outs
    for got, want in zip(runs[True], runs[False]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_serve_engine_on_the_card_matches_the_plain_versions(card):
    cfg = ARCHS["recurrentgemma-9b"].reduced()
    gen = torch.Generator(device=card).manual_seed(1)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 40, 17)]
    outputs = {}
    for use_kernels in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=64,
                                                   use_kernels=use_kernels))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outputs[use_kernels] = [r.output for r in reqs]
    assert outputs[True] == outputs[False]


def _mamba_inputs(B, T, Di, Ds, dtype, device, param_dtype="float32", seed=0):
    """x, Δ = softplus(N), A = -softplus(N), B, C, D as the model gives
    them: activations in ``dtype``, A and D in ``param_dtype``."""
    x = _normal((B, T, Di), seed, device, dtype)
    delta = torch.nn.functional.softplus(_normal((B, T, Di), seed + 1, device,
                                                 "float32")).to(x.dtype)
    A = -torch.nn.functional.softplus(_normal((Di, Ds), seed + 2, device,
                                              "float32"))
    Bc = _normal((B, T, Ds), seed + 3, device, dtype)
    Cc = _normal((B, T, Ds), seed + 4, device, dtype)
    D = _normal((Di,), seed + 5, device, "float32")
    pd = getattr(torch, param_dtype)
    return x, delta, A.to(pd), Bc, Cc, D.to(pd)


#: the reference's bar for this kernel (tests/test_kernels.py:81-87)
MAMBA_TOL = {"float32": dict(atol=5 * 2e-5, rtol=3e-2),
             "bfloat16": dict(atol=5 * 2e-2, rtol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Di,Ds,with_h0", [
    (2, 64, 32, 8, False), (1, 100, 64, 16, True), (1, 33, 16, 4, False),
    (2, 70, 40, 32, True), (3, 9, 20, 5, True), (1, 1, 128, 16, False),
    (4, 1, 8192, 16, True), (1, 3000, 8192, 16, True),
])
def test_mamba_scan_matches_plain_version(card, dtype, B, T, Di, Ds, with_h0):
    x, delta, A, Bc, Cc, D = _mamba_inputs(B, T, Di, Ds, dtype, card,
                                           param_dtype="bfloat16")
    h0 = _normal((B, Di, Ds), 6, card, "float32") if with_h0 else None
    before = mamba_scan.launches
    y, h_t = mamba_scan(x, delta, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    y_ref, h_ref = mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)
    assert y.dtype == x.dtype and h_t.dtype == torch.float32
    assert y.shape == x.shape and h_t.shape == (B, Di, Ds)
    torch.testing.assert_close(y.float(), y_ref.float(), **MAMBA_TOL[dtype])
    torch.testing.assert_close(h_t, h_ref, **MAMBA_TOL[dtype])


def test_mamba_scan_takes_strided_b_and_c(card):
    """B and C as views of one (B, T, r + 2·Ds) projection, as mamba_fwd
    splits them."""
    x, delta, A, _, _, D = _mamba_inputs(2, 40, 64, 16, "float32", card)
    proj = _normal((2, 40, 8 + 32), 7, card, "float32")
    _, Bc, Cc = torch.split(proj, [8, 16, 16], dim=-1)
    assert not Bc.is_contiguous()
    y, h_t = mamba_scan(x, delta, A, Bc, Cc, D)
    y_ref, h_ref = mamba_scan_ref(x, delta, A, Bc.contiguous(),
                                  Cc.contiguous(), D)
    torch.testing.assert_close(y, y_ref, **MAMBA_TOL["float32"])
    torch.testing.assert_close(h_t, h_ref, **MAMBA_TOL["float32"])


def test_mamba_scan_carries_state(card):
    """Two halves with the carried state == the whole sequence."""
    x, delta, A, Bc, Cc, D = _mamba_inputs(1, 64, 32, 8, "float32", card)
    y_full, h_full = mamba_scan(x, delta, A, Bc, Cc, D)
    halves = [t[:, :32].contiguous() for t in (x, delta, Bc, Cc)]
    y1, s = mamba_scan(halves[0], halves[1], A, halves[2], halves[3], D)
    rest = [t[:, 32:].contiguous() for t in (x, delta, Bc, Cc)]
    y2, s2 = mamba_scan(rest[0], rest[1], A, rest[2], rest[3], D, h0=s)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, h_full, atol=1e-5, rtol=1e-5)


def test_mamba_scan_wrapper_raises(card):
    x, delta, A, Bc, Cc, D = _mamba_inputs(2, 5, 8, 4, "float32", card)
    with pytest.raises(ValueError, match="delta on cpu"):
        mamba_scan(x, delta.cpu(), A, Bc, Cc, D)
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan(x, delta, A, Bc, Cc, D, torch.zeros(2, 8, 3, device=card))
    with pytest.raises(TypeError, match="h0 dtype"):
        mamba_scan(x, delta, A, Bc, Cc, D,
                   torch.zeros(2, 8, 4, device=card, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="Bc dtype"):
        mamba_scan(x, delta, A, Bc.bfloat16(), Cc, D)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mamba_scan(x.double(), delta.double(), A, Bc.double(), Cc.double(), D)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(0, 1).contiguous().transpose(0, 1)
        mamba_scan(xt, delta, A, Bc, Cc, D)
    big = torch.zeros(8, 33, device=card)
    with pytest.raises(ValueError, match="d_state 33"):
        mamba_scan(x, delta, big, torch.zeros(2, 5, 33, device=card),
                   torch.zeros(2, 5, 33, device=card), D)


def test_falcon_mamba_path_runs_the_kernel(card):
    """The reduced Falcon-Mamba in float32: prefill and three decode steps
    launch the kernel once per layer and call (2 layers × 4) and agree
    with the plain versions to atol/rtol 1e-4."""
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    gen = torch.Generator(device=card).manual_seed(0)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40))).to(card)
    runs = {}
    for use_kernels in (True, False):
        before = mamba_scan.launches
        logits, cache, _ = M.prefill(cfg, params, {"tokens": toks},
                                     max_cache_len=64, use_kernels=use_kernels)
        outs = [logits]
        for i in range(3):
            batch = {"tokens": toks[:, i:i + 1],
                     "positions": torch.full((2, 1), 40 + i, device=card)}
            outs.append(M.decode_step(cfg, params, batch, cache,
                                      use_kernels=use_kernels)[0])
        torch.cuda.synchronize()
        assert mamba_scan.launches - before == (2 * 4 if use_kernels else 0)
        runs[use_kernels] = outs
    for got, want in zip(runs[True], runs[False]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_falcon_mamba_engine_on_the_card_matches_the_plain_versions(card):
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    gen = torch.Generator(device=card).manual_seed(1)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (1, 40, 17)]
    outputs = {}
    for use_kernels in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(slots=2, max_len=64,
                                                   use_kernels=use_kernels))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outputs[use_kernels] = [r.output for r in reqs]
    assert outputs[True] == outputs[False]


# ---------------------------------------------------------------------------
# moe_dispatch and the Granite-MoE path
# ---------------------------------------------------------------------------

def _moe_inputs(T, D, E, C, pairs, dtype, device, seed=0):
    """Tokens, expert ids and slots.  ``unique``: slots from compute_slots,
    rows past C given slot C (dropped), so every kept pair is unique;
    ``repeated``: the MoE layer's rule where its capacity exceeds C by 2,
    as the bfloat16 plan capacity of 1.0 makes it at Granite's prefill
    (bf16(750) = 752), so up to 3 rows share slot C-1; ``out_of_range``:
    ids and slots on both sides of their ranges."""
    rng = np.random.default_rng(seed)
    tokens = _normal((T, D), seed, device, dtype)
    load = rng.dirichlet(np.full(E, 2.0))  # skewed: some experts overflow
    ids = torch.from_numpy(rng.choice(E, size=T, p=load).astype(np.int32))
    slots = compute_slots(ids, E)
    if pairs == "unique":
        slots = torch.where(slots < C, slots, C)
    elif pairs == "repeated":
        slots = torch.where(slots < C + 2, slots.clamp(max=C - 1), C)
    else:
        ids = torch.from_numpy(rng.integers(-2, E + 2, size=T).astype(np.int32))
        slots = torch.from_numpy(rng.integers(-2, C + 2, size=T).astype(np.int32))
    return tokens, ids.int().to(device), slots.int().to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,C,pairs", [
    (24_000, 1536, 40, 750, "unique"),  # Granite's 3000-token prefill
    (32, 1536, 40, 8, "unique"),  # its 4-slot decode step
    (24_000, 1536, 40, 750, "repeated"),
    (200, 64, 8, 16, "unique"),
    (333, 33, 5, 20, "repeated"),  # D no multiple of the vector width
    (500, 24, 6, 30, "out_of_range"),
])
def test_moe_dispatch_matches_plain_version(card, dtype, T, D, E, C, pairs):
    """Unique pairs: one float32 add onto zero per element, so the kernel
    equals the plain version bit for bit.  Repeated pairs: float32 atomics
    add a pair's rows in an order that changes from run to run, so the sums
    differ in their last float32 bits and a bfloat16 output may round to
    the neighbouring value (TOL)."""
    tokens, ids, slots = _moe_inputs(T, D, E, C, pairs, dtype, card)
    before = moe_dispatch.launches
    got = moe_dispatch(tokens, ids, slots, E, C)
    torch.cuda.synchronize()
    assert moe_dispatch.launches == before + 1
    want = moe_dispatch_ref(tokens, ids, slots, E, C)
    assert got.dtype == tokens.dtype and tuple(got.shape) == (E, C, D)
    if pairs == "unique":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_moe_dispatch_wrapper_raises(card):
    t = torch.zeros(8, 16, device=card)
    i = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="expert_ids dtype"):
        moe_dispatch(t, i.long(), i, 2, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_dispatch(t.double(), i, i, 2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch(t[::2], i[::2], i[::2], 2, 4)
    with pytest.raises(ValueError, match=r"\(T, D\)"):
        moe_dispatch(t[:, 0], i, i, 2, 4)
    with pytest.raises(ValueError, match="slot_ids on cpu"):
        moe_dispatch(t, i, i.cpu(), 2, 4)
    with pytest.raises(ValueError, match="slot_ids must be"):
        moe_dispatch(t, i, i[:4], 2, 4)


def _granite_runs(card, params, cfg, toks, use_kernels):
    """Prefill and three decode steps of the reduced Granite: logits, and
    the (flash_attention, moe_dispatch) launches."""
    before = (flash_attention.launches, moe_dispatch.launches)
    logits, cache, _ = M.prefill(cfg, params, {"tokens": toks},
                                 max_cache_len=64, use_kernels=use_kernels)
    outs = [logits]
    for i in range(3):
        batch = {"tokens": toks[:, i:i + 1],
                 "positions": torch.full((2, 1), 40 + i, device=card)}
        outs.append(M.decode_step(cfg, params, batch, cache,
                                  use_kernels=use_kernels)[0])
    torch.cuda.synchronize()
    return outs, (flash_attention.launches - before[0],
                  moe_dispatch.launches - before[1])


def test_granite_path_runs_the_kernels(card, monkeypatch):
    """The reduced Granite-MoE in float32: prefill and three decode steps
    launch flash_attention once per layer in prefill and moe_dispatch once
    per layer and call (2 layers × 4).  With the same attention, the plain
    dispatch gives the same logits bit for bit (unique pairs: C = 2·T·k/E
    rounds up, plan_capacity is 1); kernels against plain versions agree
    to atol/rtol 1e-4 (float32 attention sums in another order)."""
    cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    gen = torch.Generator(device=card).manual_seed(0)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40))).to(card)
    kernels, launched = _granite_runs(card, params, cfg, toks, True)
    assert launched == (2, 2 * 4)
    plain, launched = _granite_runs(card, params, cfg, toks, False)
    assert launched == (0, 0)
    for got, want in zip(kernels, plain):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    monkeypatch.setattr(ops, "moe_dispatch", ref.moe_dispatch_ref)
    same_attention, launched = _granite_runs(card, params, cfg, toks, True)
    assert launched == (2, 0)
    for got, want in zip(kernels, same_attention):
        assert torch.equal(got, want)


def test_granite_engine_on_the_card_matches_the_plain_versions(card):
    cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    gen = torch.Generator(device=card).manual_seed(1)
    params = M.init(cfg, gen, device=card)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (1, 40, 17, 5)]
    outputs = {}
    for use_kernels in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(slots=3, max_len=64,
                                                   use_kernels=use_kernels))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outputs[use_kernels] = [r.output for r in reqs]
    assert outputs[True] == outputs[False]
