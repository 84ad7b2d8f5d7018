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


def _exact_segment_sum(values, ids, s):
    """float64 sums of integer-valued rows by id on the host, ids outside
    [0, s) dropped: the exact answer below 2^24."""
    keep = (ids >= 0) & (ids < s)
    out = np.zeros((s, values.shape[1]))
    np.add.at(out, ids[keep], values[keep])
    return out


def test_segment_sum_hot_id_is_exact(card):
    """A reducer without in-mapper combining: ~1M sorted Zipf(1.4) ids
    whose hottest id holds about a third of the rows, float32 ones.  The
    kernel adds a run's sum once where it ends, across lanes and warps;
    integer sums below 2^24 are exact in any order."""
    rng = np.random.default_rng(2)
    n, s = 1_000_000, 65_536
    ids = (np.sort(np.minimum(rng.zipf(1.4, size=n), s) - 1)).astype(np.int32)
    assert np.bincount(ids).max() > n // 4
    got = segment_sum(torch.ones(n, 1, device=card),
                      torch.from_numpy(ids).to(card), s)
    np.testing.assert_array_equal(
        got.cpu().numpy(), _exact_segment_sum(np.ones((n, 1)), ids, s))


@pytest.mark.parametrize("d", [1, 8, 33])
@pytest.mark.parametrize("n", [257, 300_001])
def test_segment_sum_one_id_for_every_row(card, n, d):
    """One run over every row: it crosses every lane, warp and block."""
    values = np.random.default_rng(3).integers(-3, 4, size=(n, d))
    ids = np.zeros(n, np.int32)
    got = segment_sum(torch.from_numpy(values.astype(np.float32)).to(card),
                      torch.from_numpy(ids).to(card), 1)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _exact_segment_sum(values, ids, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(10_007, 1), (10_007, 4), (600_011, 1)])
@pytest.mark.parametrize("ids_offset,values_offset", [
    (1, 0), (2, 2), (3, 1), (3, 3), (0, 1)])
def test_segment_sum_unaligned_storage(card, ids_offset, values_offset, n, d,
                                       dtype):
    """ids and values whose storage offsets are not 16-byte aligned (views
    into larger tensors): the kernel reads a ragged head and tail with
    scalar loads and the rest with vector loads where both line up (4 rows
    a lane at 10,007 rows, 8 at 600,011)."""
    rng = np.random.default_rng(4)
    s = 300
    ids = np.sort(rng.integers(-1, s + 1, size=n + ids_offset)).astype(np.int32)
    values = rng.integers(-8, 9, size=(n + values_offset, d))
    i = torch.from_numpy(ids).to(card)[ids_offset:]
    v = torch.from_numpy(values.astype(np.float32)).to(
        card, getattr(torch, dtype))[values_offset:]
    assert i.storage_offset() == ids_offset and i.is_contiguous()
    got = segment_sum(v, i, s)
    want = _exact_segment_sum(values[values_offset:], ids[ids_offset:], s)
    # bfloat16 holds integers up to 256 exactly; larger sums round once
    np.testing.assert_allclose(got.float().cpu().numpy(), want,
                               rtol=0 if dtype == "float32" else 2 ** -8,
                               atol=0)


@pytest.mark.parametrize("d", [1, 16])
def test_segment_sum_out_of_range_ids_break_runs(card, d):
    """-1 and S+3 in the middle of runs of a valid id: they are dropped and
    the valid rows on both sides still count, as separate runs."""
    n, s = 50_000, 40
    ids = np.repeat(np.arange(s, dtype=np.int32), n // s)
    ids[5::97] = -1
    ids[11::89] = s + 3
    values = np.random.default_rng(5).integers(1, 6, size=(ids.size, d))
    got = segment_sum(torch.from_numpy(values.astype(np.float32)).to(card),
                      torch.from_numpy(ids).to(card), s)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _exact_segment_sum(values, ids, s))
    plain = segment_sum_ref(torch.from_numpy(values.astype(np.float32)),
                            torch.from_numpy(ids), s)
    np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())


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


def _gate(shape, seed, kind, device, dtype):
    """a in (0, 1): a sigmoid of N(0, 1), or near 1, or near 0 (where a
    chunk's product of a underflows to 0 in float32)."""
    if kind == "sigmoid":
        return torch.sigmoid(_normal(shape, seed, device, dtype))
    u = np.random.default_rng(seed).uniform(0.5, 1.0, size=shape)
    a = 1.0 - 1e-4 * u if kind == "near_one" else 1e-4 * u
    return torch.from_numpy(a.astype(np.float32)).to(device, getattr(torch, dtype))


#: T at and around the chunk lengths the wrapper picks (16 steps and more)
#: and D off the 128-channel tile, B = 3; a near 1 and near 0, near 1 also
#: at 33 and 32 chunks, where pass 2 folds pairs past its groups of 8 while
#: the carry survives
RGLRU_EDGES = [
    (1, 1, 130, "sigmoid"), (3, 1, 33, "near_zero"), (1, 15, 256, "sigmoid"),
    (1, 16, 256, "near_one"), (1, 17, 256, "sigmoid"), (3, 33, 130, "near_zero"),
    (2, 100, 200, "near_one"), (1, 1025, 256, "sigmoid"),
    (1, 1025, 256, "near_one"), (3, 3000, 4096, "sigmoid"),
    (1, 3000, 4096, "near_one"), (1, 2049, 4096, "near_zero"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,D,kind", RGLRU_EDGES)
def test_rglru_scan_chunk_edges(card, dtype, with_h0, B, T, D, kind):
    x = _normal((B, T, D), 0, card, dtype)
    a = _gate((B, T, D), 1, kind, card, dtype)
    h0 = _normal((B, D), 2, card, "float32") if with_h0 else None
    y, h_t = rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = rglru_scan_ref(x, a, h0)
    torch.testing.assert_close(y.float(), y_ref.float(), **KTOL[dtype])
    torch.testing.assert_close(h_t, h_ref, **KTOL[dtype])


def test_rglru_scan_geometry_is_the_sources(card):
    """The chunking's geometry comes from the C entry: 128 channels a
    block, 8 steps loaded together, 8 blocks an SM, and the card's SMs."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.rglru_scan")
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    assert mod._geometry(index) == (128, 8, 8 * sms)
    assert mod.chunking(1, 3000, 4096, 128, 8, 8 * 132) == (96, 32)


@pytest.mark.parametrize("T", [0, 1, 300])
def test_rglru_scan_repeats_bits_and_leaves_h0(card, T):
    """Two calls give the same bits; h0 is read, never written, and h_T is
    a tensor of its own, also where nothing is scanned."""
    x = _normal((2, T, 160), 0, card, "bfloat16")
    a = torch.sigmoid(_normal((2, T, 160), 1, card, "bfloat16"))
    h0 = _normal((2, 160), 2, card, "float32")
    keep = h0.clone()
    y1, h1 = rglru_scan(x, a, h0)
    y2, h2 = rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(h0, keep)
    assert h1.data_ptr() != h0.data_ptr() and h2.data_ptr() != h0.data_ptr()
    if T == 0:
        assert torch.equal(h1, h0)


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


#: T inside, at and around the 64-step time tile and past the 3-stage ring,
#: d_inner off the 32-channel tile, d_state 1, 5, 16 and 32, B = 3
MAMBA_EDGES = [
    (1, 31, 64, 16), (1, 63, 64, 16), (1, 64, 64, 16), (1, 65, 64, 16),
    (2, 128, 96, 16), (1, 129, 32, 16), (3, 193, 100, 5), (3, 200, 33, 1),
    (2, 130, 20, 32), (1, 1, 33, 32), (3, 1, 40, 5), (1, 2049, 8192, 16),
]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Di,Ds", MAMBA_EDGES)
def test_mamba_scan_tiling_edges(card, dtype, param_dtype, B, T, Di, Ds):
    """A and D in float32 and in bfloat16, read as they are."""
    x, delta, A, Bc, Cc, D = _mamba_inputs(B, T, Di, Ds, dtype, card,
                                           param_dtype=param_dtype)
    h0 = _normal((B, Di, Ds), 6, card, "float32")
    y, h_t = mamba_scan(x, delta, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)
    torch.testing.assert_close(y.float(), y_ref.float(), **MAMBA_TOL[dtype])
    torch.testing.assert_close(h_t, h_ref, **MAMBA_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_unaligned_rows(card, dtype):
    """x and delta at a storage offset of one element and B and C views of a
    13-wide projection: rows that do not start on 16 bytes take the kernel's
    plain-load staging, with the same result."""
    B, T, Di, Ds = 2, 70, 36, 5
    x, delta, A, _, _, D = _mamba_inputs(B, T, Di, Ds, dtype, card,
                                         param_dtype="bfloat16")
    flat = torch.empty(2 * x.numel() + 1, device=card, dtype=x.dtype)
    xs = flat[1:1 + x.numel()].view(x.shape)
    ds = flat[1 + x.numel():].view(x.shape)
    xs.copy_(x)
    ds.copy_(delta)
    proj = _normal((B, T, 3 + 2 * Ds), 7, card, dtype)
    _, Bc, Cc = torch.split(proj, [3, Ds, Ds], dim=-1)
    assert xs.data_ptr() % 16 and Bc.stride(1) * proj.element_size() % 16
    y, h_t = mamba_scan(xs, ds, A, Bc, Cc, D)
    torch.cuda.synchronize()
    y_ref, h_ref = mamba_scan_ref(x, delta, A, Bc, Cc, D)
    torch.testing.assert_close(y.float(), y_ref.float(), **MAMBA_TOL[dtype])
    torch.testing.assert_close(h_t, h_ref, **MAMBA_TOL[dtype])


@pytest.mark.parametrize("T", [0, 1, 300])
def test_mamba_scan_repeats_bits_and_leaves_h0(card, T):
    """Two calls give the same bits; h0 is read, never written, and h_T is
    a tensor of its own, also where nothing is scanned."""
    x, delta, A, Bc, Cc, D = _mamba_inputs(2, T, 96, 16, "bfloat16", card,
                                           param_dtype="bfloat16")
    h0 = _normal((2, 96, 16), 6, card, "float32")
    keep = h0.clone()
    y1, h1 = mamba_scan(x, delta, A, Bc, Cc, D, h0)
    y2, h2 = mamba_scan(x, delta, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(h0, keep)
    assert h1.data_ptr() != h0.data_ptr() and h2.data_ptr() != h0.data_ptr()
    if T == 0:
        assert torch.equal(h1, h0)


def test_scan_wrappers_raise_off_the_current_device(card, monkeypatch):
    """mamba_scan and rglru_scan enter no device context: where their
    tensors lie on another device than the current one, they raise."""
    x, delta, A, Bc, Cc, D = _mamba_inputs(1, 4, 32, 4, "float32", card)
    r = torch.ones(1, 4, 32, device=card)
    other = x.get_device() + 1
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: other)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: other)
    with pytest.raises(ValueError, match="current device is cuda:"):
        mamba_scan(x, delta, A, Bc, Cc, D)
    with pytest.raises(ValueError, match="current device is cuda:"):
        rglru_scan(r, r * 0.5)


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


def test_reduce_wrappers_raise_off_the_current_device(card, monkeypatch):
    """segment_sum and moe_dispatch enter no device context: where their
    tensors lie on another device than the current one, the launch would
    go to the current device with the other's pointers, so they raise.
    On one card the current device is made to read as another."""
    v = torch.ones(64, 8, device=card)
    i = torch.zeros(64, dtype=torch.int32, device=card)
    other = v.get_device() + 1
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: other)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: other)
    with pytest.raises(ValueError, match="current device is cuda:"):
        segment_sum(v, i, 3)
    with pytest.raises(ValueError, match="current device is cuda:"):
        moe_dispatch(v, i, i, 2, 4)


def test_reduce_wrappers_on_a_second_card(card):
    """On a card that is not the current device the two wrappers raise;
    under its device context they launch there and equal the plain
    versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    second = torch.device("cuda", 1)
    v = _normal((300, 24), 0, second, "float32")
    i = torch.from_numpy(np.random.default_rng(1).integers(
        0, 7, size=300).astype(np.int32)).to(second)
    slots = compute_slots(i, 7).clamp(max=99).int()
    with pytest.raises(ValueError, match="current device is cuda:0"):
        segment_sum(v, i, 7)
    with pytest.raises(ValueError, match="current device is cuda:0"):
        moe_dispatch(v, i, slots, 7, 100)
    with torch.cuda.device(second):
        got = segment_sum(v, i, 7)
        buf = moe_dispatch(v, i, slots, 7, 100)
        torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), segment_sum_ref(v.cpu(), i.cpu(), 7),
                               **TOL["float32"])
    assert torch.equal(buf.cpu(), moe_dispatch_ref(v.cpu(), i.cpu(),
                                                   slots.cpu(), 7, 100))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,C", [
    (24_000, 1536, 40, 750),  # Granite's prefill, the served capacity rule
    (333, 33, 5, 20),  # D no multiple of the vector width
    (500, 24, 6, 30),
])
def test_moe_dispatch_repeated_pairs_are_row_order_sums(card, dtype, T, D, E,
                                                       C):
    """Rows that share a pair are summed in float32 in row order, as the
    plain version sums them on the CPU: equal to it computed on a CPU copy
    bit for bit, and the same from call to call."""
    tokens, ids, slots = _moe_inputs(T, D, E, C, "repeated", dtype, card)
    kept = slots < C
    pairs = ids[kept].long() * C + slots[kept].long()
    assert int(kept.sum()) > pairs.unique().numel()  # some pairs repeat
    got = moe_dispatch(tokens, ids, slots, E, C)
    again = moe_dispatch(tokens, ids, slots, E, C)
    torch.cuda.synchronize()
    want = moe_dispatch_ref(tokens.cpu(), ids.cpu(), slots.cpu(), E, C)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_pairs_far_apart(card, dtype):
    """A pair's rows at the first row, the middle and the last of 20,000,
    and a pair of 70 rows (more than a warp's scan step), against the plain
    version on a CPU copy, bit for bit."""
    T, D, E, C = 20_000, 264, 4, 8
    tokens = _normal((T, D), 6, card, dtype)
    ids = torch.full((T,), -1, dtype=torch.int32)
    slots = torch.zeros((T,), dtype=torch.int32)
    ids[[0, T // 2, T - 1]] = 2
    slots[[0, T // 2, T - 1]] = 5
    many = torch.arange(100, 20_000, 283)[:70]
    ids[many], slots[many] = 1, 0
    ids[7], slots[7] = 3, 7  # a pair of one row
    ids, slots = ids.to(card), slots.to(card)
    got = moe_dispatch(tokens, ids, slots, E, C)
    want = moe_dispatch_ref(tokens.cpu(), ids.cpu(), slots.cpu(), E, C)
    assert torch.equal(got.cpu(), want)
    assert not bool(got[0].any()) and bool(got[2, 5].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,C", [
    (32, 1536, 40, 8),  # Granite's decode step
    (2048, 64, 64, 64),  # at both of the one-launch path's limits
    (333, 33, 5, 20),
])
def test_moe_dispatch_one_launch_path_equals_the_three_pass_path(
        card, dtype, T, D, E, C):
    """A small dispatch runs both passes in one launch with its index in
    shared memory; given a workspace, the C entry runs the memset, index
    and gather passes instead.  The two agree bit for bit, repeated pairs
    included."""
    from repro_torch.kernels.moe_dispatch import _kernel

    tokens, ids, slots = _moe_inputs(T, D, E, C, "repeated", dtype, card)
    got = moe_dispatch(tokens, ids, slots, E, C)
    out = torch.empty_like(got)
    tables = torch.empty(2 * E * C, dtype=torch.int32, device=card)
    rc = _kernel(tokens.dtype)(
        tokens.data_ptr(), ids.data_ptr(), slots.data_ptr(), out.data_ptr(),
        tables.data_ptr(), T, D, E, C, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(got, out)
    assert torch.equal(got.cpu(), moe_dispatch_ref(tokens.cpu(), ids.cpu(),
                                                   slots.cpu(), E, C))


@pytest.mark.parametrize("T,E,C", [(0, 4, 8), (16, 0, 8), (16, 4, 0)])
def test_moe_dispatch_empty_shapes(card, T, E, C):
    """No rows gives zero buffers (the kernel writes them); no experts or
    no slots gives an empty result and launches nothing."""
    tokens = _normal((T, 16), 7, card, "bfloat16")
    ids = torch.zeros(T, dtype=torch.int32, device=card)
    before = moe_dispatch.launches
    got = moe_dispatch(tokens, ids, ids, E, C)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (E, C, 16) and got.dtype == torch.bfloat16
    assert not bool(got.any())
    assert moe_dispatch.launches == before + (1 if E * C else 0)


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


def _kernel_calls(device, seed=0):
    """Each LM and reduce kernel's wrapper on small CUDA inputs whose float
    tensors require grad: name → (wrapper, a call)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).requires_grad_()

    def u(*shape):
        return torch.rand(shape, generator=g, device=device).requires_grad_()

    ids = torch.tensor([0, 2, 2, 1, 5], dtype=torch.int32, device=device)
    slots = torch.tensor([0, 0, 1, 3, 1], dtype=torch.int32, device=device)
    return {
        "segment_sum": (segment_sum, lambda: segment_sum(r(5, 3), ids, 4)),
        "flash_attention": (flash_attention, lambda: flash_attention(
            r(1, 4, 64, 64), r(1, 2, 64, 64), r(1, 2, 64, 64))),
        "mamba_scan": (mamba_scan, lambda: mamba_scan(
            r(2, 5, 32), u(2, 5, 32), -u(32, 4).detach().requires_grad_(),
            r(2, 5, 4), r(2, 5, 4), r(32), r(2, 32, 4))),
        "rglru_scan": (rglru_scan, lambda: rglru_scan(r(2, 5, 128),
                                                      u(2, 5, 128), r(2, 128))),
        "moe_dispatch": (moe_dispatch,
                         lambda: moe_dispatch(r(5, 64), ids, slots, 4, 2)),
    }


@pytest.mark.parametrize("name", ["segment_sum", "flash_attention",
                                  "mamba_scan", "rglru_scan", "moe_dispatch"])
def test_wrappers_refuse_inputs_that_require_grad(card, name):
    """A kernel's output carries no ``grad_fn``: under autograd, an input
    that requires grad raises instead of cutting the graph; under
    ``no_grad`` the kernel launches."""
    wrapper, call = _kernel_calls(card)[name]
    before = wrapper.launches
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        call()
    assert wrapper.launches == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1


def test_loss_with_kernels_fails_loudly_on_the_card(card):
    cfg = ARCHS["qwen3-1.7b"].reduced()
    params = M.init(cfg, torch.Generator(device=card).manual_seed(0),
                    device=card)
    M._tree_map(lambda _, a: a.requires_grad_(), params)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=card)
    batch = {"tokens": tokens, "labels": tokens}
    with pytest.raises(RuntimeError, match="flash_attention: the kernel has "
                       "no backward"):
        M.loss_fn(cfg, params, batch, use_kernels=True)
    loss, _ = M.loss_fn(cfg, params, batch)
    loss.backward()
    assert torch.isfinite(params["embed"].grad).all()


# ---------------------------------------------------------------------------
# multi-job schedules and online control: the solves on the card
# ---------------------------------------------------------------------------

def _schedule_views(n_jobs=3):
    """``n_jobs`` job views of the 8-node PlanetLab substrate, each with
    most of its input at two sources of its own."""
    from repro_torch.core import Substrate, planetlab_platform

    sub = Substrate.of(planetlab_platform(8, alpha=1.0, seed=0))
    views = []
    for g in range(n_jobs):
        D = np.full(sub.nS, 100.0)
        D[g] = D[g + 4] = 700.0
        views.append(sub.view(D, 1.0, name=f"job{g}"))
    return sub, views


@pytest.mark.parametrize("objective", ["makespan", "min_max_slowdown"])
def test_joint_schedule_on_the_card_matches_the_cpu(card, objective):
    """``optimize_schedule("joint")`` at 25 steps: the card's float32
    anneal (TF32 off) and the CPU's agree, so their float64-priced
    per-job makespans do to 1e-4."""
    from repro_torch.core import optimize_schedule

    _, views = _schedule_views()
    kw = dict(policy="joint", n_restarts=6, steps=25, objective=objective)
    on_card = optimize_schedule(views, device=card, **kw)
    on_cpu = optimize_schedule(views, device="cpu", **kw)
    assert on_card.makespan == pytest.approx(on_cpu.makespan, rel=1e-4)
    for a, b in zip(on_card.results, on_cpu.results):
        assert a.makespan == pytest.approx(b.makespan, rel=1e-4)
        np.testing.assert_allclose(a.plan.x, b.plan.x, atol=1e-4)


@pytest.mark.parametrize("incremental", [False, True])
def test_replan_schedule_on_the_card_matches_the_cpu(card, incremental):
    from repro_torch.core import (SimConfig, open_schedule, replan_schedule,
                                  uniform_plan)

    sub, views = _schedule_views()
    plans = [uniform_plan(v) for v in views]
    eng = open_schedule([(v, p, SimConfig()) for v, p in zip(views, plans)],
                        substrate=sub)
    eng.run_until(1.0)
    snap = eng.snapshot()
    kw = dict(n_restarts=4, steps=25, seed=3, incremental=incremental)
    on_card = replan_schedule(sub, plans, snap, device=card, **kw)
    on_cpu = replan_schedule(sub, plans, snap, device="cpu", **kw)
    assert on_card.before == on_cpu.before
    assert on_card.makespan == pytest.approx(on_cpu.makespan, rel=1e-4)
    for a, b, inc in zip(on_card.plans, on_cpu.plans, plans):
        assert (a is inc) == (b is inc)


def test_run_online_times_its_solves_on_the_card(card, monkeypatch):
    """Every timed solve sits between two synchronizations of the card,
    and a second run's solves (their keys seen) are warm samples of the
    charge's moving average."""
    from repro_torch import api
    from repro_torch.api import Arrival, GeoJob, GeoSchedule
    from repro_torch.core import CapacityTrace

    emas, syncs = [], []

    class Recording(api.SolveTimeEMA):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            emas.append(self)

    real_sync = api.synchronize
    monkeypatch.setattr(api, "SolveTimeEMA", Recording)
    monkeypatch.setattr(api, "synchronize",
                        lambda dev: (syncs.append(dev), real_sync(dev)))
    sub, views = _schedule_views(2)
    sub = sub.with_traces({"shuffle[m0->r0]": CapacityTrace.step(
        sub.B_mr[0, 0], sub.B_mr[0, 0] / 250.0, 20.0)})
    views = [sub.view(v.D, v.alpha, name=v.name) for v in views]
    for _ in range(2):
        sched = GeoSchedule([GeoJob(views[0])], device=card).plan(
            "independent", n_restarts=4, steps=50)
        report = sched.run_online(
            "reactive_incremental", arrivals=[Arrival(GeoJob(views[1]), 5.0)],
            n_restarts=4, steps=50)
        assert all(np.isfinite(d.modeled_after) for d in report.decisions)
    first, second = emas
    observed = first.samples + first.excluded
    assert observed >= 1 and second.samples >= 1
    assert len(syncs) == 2 * (observed + second.samples + second.excluded)
    assert all(torch.device(d).type == "cuda" for d in syncs)
    assert second.ema > 0.0 and second.charge_s() == 10.0 ** (
        round(np.log10(second.ema) * 2.0) / 2.0)
