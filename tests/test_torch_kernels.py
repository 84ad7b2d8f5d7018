"""The port's kernels' plain PyTorch versions (``segment_sum``,
``flash_attention``, ``mamba_scan``, ``rglru_scan``, ``moe_dispatch`` with
``compute_slots`` and the combine) against the reference's Pallas
kernels (interpret mode on the CPU) and jnp oracles, and the CPU dispatch
of the wrappers and the ops layer.  The Hopper kernels themselves are held
against the plain versions in ``test_torch_cuda.py``."""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_attention  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba  # noqa: E402
from repro.kernels.moe_dispatch import compute_slots as ref_compute_slots  # noqa: E402
from repro.kernels.moe_dispatch import moe_dispatch as pallas_moe  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa: E402
from repro.kernels.segment_reduce import segment_sum as pallas_segment_sum  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import _entry as _flash_entry  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.moe_dispatch import compute_slots, moe_dispatch  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, mamba_scan_ref,  # noqa: E402
                                     moe_combine_ref, moe_dispatch_ref,
                                     rglru_scan_ref, segment_sum_ref)
from repro_torch.kernels.rglru_scan import MAX_CHUNKS, chunking  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_sum  # noqa: E402

#: float32 sums of a few dozen N(0,1) terms taken in another order (the
#: reference's tolerance, tests/test_kernels.py); bfloat16 outputs of
#: float32 sums that differ in the last float32 bits may round to the
#: neighbouring bfloat16 value (2^-8 relative).
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}

# (n, d, s, block, ids): the reference kernel tests' ranges, sorted and
# unsorted, and ids outside [0, s) (the reference's padding id is s)
CASES = [
    (4, 4, 2, 16, "sorted"),
    (37, 16, 5, 16, "sorted"),
    (128, 8, 7, 32, "unsorted"),
    (300, 33, 20, 64, "sorted"),
    (257, 4, 11, 512, "unsorted"),
    (200, 16, 9, 64, "out_of_range"),
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
@pytest.mark.parametrize("n,d,s,block,ids_kind", CASES,
                         ids=[f"{c[0]}x{c[1]}-S{c[2]}-{c[4]}" for c in CASES])
def test_plain_version_matches_reference(n, d, s, block, ids_kind, dtype):
    values, ids = _inputs(n, d, s, ids_kind)
    jv = jnp.asarray(values, dtype=getattr(jnp, dtype))
    pallas = np.asarray(pallas_segment_sum(jv, jnp.asarray(ids), s,
                                           block_n=block).astype(jnp.float32))
    oracle = np.asarray(rref.segment_sum_ref(jv, jnp.asarray(ids), s)
                        .astype(jnp.float32))
    tv = torch.from_numpy(values).to(getattr(torch, dtype))
    got = segment_sum_ref(tv, torch.from_numpy(ids), s)
    assert got.dtype == tv.dtype and tuple(got.shape) == (s, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    values, ids = _inputs(100, 3, 6, "unsorted")
    v, i = torch.from_numpy(values), torch.from_numpy(ids)
    before = segment_sum.launches
    want = segment_sum_ref(v, i, 6)
    for out in (segment_sum(v, i, 6), ops.sorted_segment_sum(v, i, 6),
                ops.sorted_segment_sum(v, i, 6, use_kernel=False)):
        torch.testing.assert_close(out, want, atol=0.0, rtol=0.0)
    assert segment_sum.launches == before  # no kernel ran


def test_word_count_sums_stay_exact():
    """Word count's integer counts go through float32: exact below 2^24."""
    counts = torch.tensor([[2.0 ** 23], [2.0 ** 23 - 1], [1.0], [5.0]])
    ids = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    out = ops.sorted_segment_sum(counts, ids, 2)
    assert out[:, 0].tolist() == [2.0 ** 24 - 1, 6.0]



#: the reference's kernel tolerances (tests/test_kernels.py:19-20)
KTOL = {"float32": dict(atol=2e-5, rtol=1e-2),
        "bfloat16": dict(atol=2e-2, rtol=1e-2)}

# (B, Hq, Hkv, T, S, Dh, causal, window, q_offset): rows of the reference
# kernel tests' table at sizes interpret mode runs quickly — GQA, a sliding
# window over a T that is no multiple of the 32-row block, a decode offset,
# non-causal — and Phi-3-vision's Dh 96 (as many kv heads as query heads)
# and a GQA Dh 80 with a window and an offset, widths off the 64-column grid
ATTN_CASES = [
    (1, 4, 2, 64, 64, 32, True, None, 0),
    (1, 4, 1, 40, 40, 16, True, 16, 0),
    (1, 2, 1, 16, 64, 32, True, None, 48),
    (1, 2, 2, 24, 40, 16, False, None, 0),
    (1, 4, 4, 40, 40, 96, True, None, 0),
    (1, 4, 2, 20, 52, 80, True, 24, 32),
]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,Dh,causal,window,qoff", ATTN_CASES)
def test_attention_plain_version_matches_reference(dtype, B, Hq, Hkv, T, S, Dh,
                                                   causal, window, qoff):
    q = _normal((B, Hq, T, Dh), 0)
    k = _normal((B, Hkv, S, Dh), 1)
    v = _normal((B, Hkv, S, Dh), 2)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    pallas = pallas_attention(jq, jk, jv, causal=causal, window=window,
                              q_offset=qoff, block_q=32, block_k=32)
    oracle = rref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                q_offset=qoff)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window, q_offset=qoff)
    assert got.dtype == td and tuple(got.shape) == (B, Hq, T, Dh)
    got = got.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   **KTOL[dtype])


def test_attention_fully_masked_rows_are_zero():
    q = torch.from_numpy(_normal((1, 2, 4, 8), 0))
    k = torch.from_numpy(_normal((1, 1, 3, 8), 1))
    out = attention_ref(q, k, k, causal=True, window=2, q_offset=10)
    assert bool(torch.all(out == 0)) and not bool(torch.isnan(out).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D,chunk,with_h0", [
    (2, 64, 32, 16, False),
    (1, 50, 16, 16, True),  # T no multiple of the chunk
    (3, 1, 32, 16, True),  # one decode step
])
def test_rglru_plain_version_matches_reference(dtype, B, T, D, chunk, with_h0):
    x = _normal((B, T, D), 3)
    a = 1.0 / (1.0 + np.exp(-_normal((B, T, D), 4)))
    h0 = _normal((B, D), 5) if with_h0 else None
    jd = getattr(jnp, dtype)
    jx, ja = jnp.asarray(x, jd), jnp.asarray(a, jd)
    jh0 = None if h0 is None else jnp.asarray(h0)
    pallas = pallas_rglru(jx, ja, jh0, chunk=chunk, block_d=D)
    oracle = rref.rglru_scan_ref(jx, ja, jh0)
    td = getattr(torch, dtype)
    y, h_t = rglru_scan_ref(torch.from_numpy(x).to(td),
                            torch.from_numpy(a).to(td),
                            None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == td and h_t.dtype == torch.float32
    for want_y, want_h in (pallas, oracle):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y.astype(jnp.float32)),
                                   **KTOL[dtype])
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h),
                                   **KTOL[dtype])


def _rglru_geometry(sms=132):
    """``chunking``'s (tile, group, blocks) as ``rglru_scan_geometry``
    gives them, read from the kernels' source, on an H100 SXM's 132 SMs."""
    src = (_build.CSRC / "rglru_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    return const("kThreads"), const("kUnroll"), const("kMinBlocks") * sms


def _rglru_two_pass(x, a, h0):
    """The CUDA kernels' chunked scan in their order, in float32 torch, at
    the wrapper's chunks: pass 1 gives every chunk but the last its (A_c,
    H_c) = (product of a, state from 0); pass 2 folds the pairs of the
    chunks before its own into h_in from h0 (h = A_j h + H_j, in chunk
    order), then rescans its chunk from h_in.  Returns (y, h_T, pairs)."""
    B, T, D = x.shape
    chunk, k = chunking(B, T, D, *_rglru_geometry())
    xf, af = x.float(), a.float()
    inject = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * xf
    pairs = []
    for c in range(k - 1):
        prod, h = torch.ones(B, D), torch.zeros(B, D)
        for t in range(c * chunk, (c + 1) * chunk):
            h = af[:, t] * h + inject[:, t]
            prod = prod * af[:, t]
        pairs.append((prod, h))
    y = torch.empty(B, T, D)
    for c in range(k):
        h = torch.zeros(B, D) if h0 is None else h0.float().clone()
        for prod, h_c in pairs[:c]:
            h = prod * h + h_c
        for t in range(c * chunk, min((c + 1) * chunk, T)):
            h = af[:, t] * h + inject[:, t]
            y[:, t] = h
    return y.to(x.dtype), h, pairs


def _gate(shape, seed, kind):
    """a in (0, 1): a sigmoid of N(0, 1), or near 1, or near 0 (where a
    chunk's product of a underflows to 0 in float32)."""
    u = np.random.default_rng(seed).uniform(0.5, 1.0, size=shape)
    if kind == "near_one":
        return (1.0 - 1e-4 * u).astype(np.float32)
    if kind == "near_zero":
        return (1e-4 * u).astype(np.float32)
    return (1.0 / (1.0 + np.exp(-_normal(shape, seed)))).astype(np.float32)


#: T around the chunk length the wrapper picks at (2, T, 32), 16 steps up
#: to T = 1024: one chunk, one and two, four, and 18, where pass 2 of the
#: last chunk folds 17 pairs, past the kernel's groups of 8
_RGLRU_T = [1, 15, 16, 17, 3 * 16 + 5, 17 * 16 + 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("kind", ["sigmoid", "near_one", "near_zero"])
@pytest.mark.parametrize("T", _RGLRU_T)
def test_rglru_two_pass_composition_matches_reference(T, kind, with_h0, dtype):
    """The kernels' two-pass composition (pass 1's pairs, pass 2's fold and
    rescan) against the plain version and the reference's interpret-mode
    Pallas kernel, at T around the chunk length, a near 1 and near 0."""
    B, D = 2, 32
    x = _normal((B, T, D), 3)
    a = _gate((B, T, D), 4, kind)
    h0 = _normal((B, D), 5) if with_h0 else None
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    tx, ta = torch.from_numpy(x).to(td), torch.from_numpy(a).to(td)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h_t, pairs = _rglru_two_pass(tx, ta, th0)
    chunk, k = chunking(B, T, D, *_rglru_geometry())
    assert len(pairs) == k - 1 == -(-T // 16) - 1  # 16-step chunks
    if kind == "near_zero" and k > 1 and chunk >= 12:  # a < 1e-4: 1e-48
        assert all(bool((prod == 0).all()) for prod, _ in pairs)
    assert y.dtype == td and h_t.dtype == torch.float32
    jh0 = None if h0 is None else jnp.asarray(h0)
    wy, wh = pallas_rglru(jnp.asarray(x, jd), jnp.asarray(a, jd), jh0,
                          chunk=16, block_d=D)
    pallas = (torch.from_numpy(np.array(wy.astype(jnp.float32))),
              torch.from_numpy(np.array(wh)))
    for want_y, want_h in (rglru_scan_ref(tx, ta, th0), pallas):
        np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                                   **KTOL[dtype])
        np.testing.assert_allclose(h_t.numpy(), want_h.numpy(), **KTOL[dtype])


@pytest.mark.parametrize("b,t,d", [
    (1, 1, 4096), (4, 1, 4096), (1, 2, 4096), (1, 17, 4096), (1, 2047, 4096),
    (1, 3000, 4096), (1, 3000, 2560), (3, 100, 33), (1, 100_000, 128),
    (64, 3000, 4096), (2, 53, 32),
])
def test_rglru_chunking(b, t, d):
    """K ≥ 1 chunks that cover T, every chunk but the last whole and none
    empty, each a whole number of the kernels' load groups; K = 1 at T = 1
    (a decode step is one launch); at most MAX_CHUNKS; at the served
    prefill, blocks enough for 32 warps on each of the 132 SMs."""
    tile, group, blocks = _rglru_geometry()
    chunk, k = chunking(b, t, d, tile, group, blocks)
    assert k >= 1 and chunk >= 1 and (k - 1) * chunk < t <= k * chunk
    assert k <= MAX_CHUNKS and (k == 1 or chunk % (2 * group) == 0)
    if t == 1:
        assert k == 1
    if (b, t, d) == (1, 3000, 4096):
        assert b * -(-d // tile) * k * tile >= 132 * 30 * 32
        assert k >= 30 and chunk >= 16


@pytest.mark.parametrize("name,module", [
    ("mamba_scan", "repro_torch.kernels.mamba_scan"),
    ("rglru_scan", "repro_torch.kernels.rglru_scan"),
])
def test_scan_wrappers_match_their_c_entries(name, module):
    """Each C entry the scan wrapper names takes the arguments its ctypes
    signature passes (a pointer where the C side has one, a 64-bit integer
    elsewhere), and the wrapper makes one ctypes call, enters no
    ``torch.cuda.device`` context and zero-fills nothing on its launch
    path."""
    import importlib
    import inspect

    mod = importlib.import_module(module)
    src = (_build.CSRC / f"{name}.cu").read_text()
    if name == "rglru_scan":  # the geometry chunking reads, in its order
        assert re.search(r"out\[0\] = kThreads;\s+out\[1\] = kUnroll;\s+"
                         r"out\[2\] = kMinBlocks;", src)
    for entry in mod._ENTRY.values():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert m, entry
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int64
                 for p in params]
        assert all("*" in p or p.startswith("int64_t ") for p in params)
        assert kinds == mod._ARGTYPES
    wrapper = inspect.getsource(getattr(mod, name))
    assert wrapper.count("_kernel(") == 1
    assert "torch.cuda.device(" not in wrapper
    launch_path = wrapper.split("return y, h_t", 1)[1]  # past the empty path
    assert "torch.zeros" not in launch_path and ".clone()" not in launch_path


def test_lm_kernels_on_cpu_take_the_plain_versions():
    q = torch.from_numpy(_normal((1, 4, 9, 16), 0))
    k = torch.from_numpy(_normal((1, 2, 9, 16), 1))
    x = torch.from_numpy(_normal((2, 5, 8), 2))
    a = torch.sigmoid(torch.from_numpy(_normal((2, 5, 8), 3)))
    h0 = torch.from_numpy(_normal((2, 8), 4))
    before = (flash_attention.launches, rglru_scan.launches)
    want = attention_ref(q, k, k, window=4)
    for out in (flash_attention(q, k, k, window=4),
                ops.attention(q, k, k, window=4),
                ops.attention(q, k, k, window=4, use_kernel=False)):
        torch.testing.assert_close(out, want, atol=0.0, rtol=0.0)
    wy, wh = rglru_scan_ref(x, a, h0)
    for y, h in (rglru_scan(x, a, h0), ops.gated_linear_recurrence(x, a, h0),
                 ops.gated_linear_recurrence(x, a, h0, use_kernel=False)):
        torch.testing.assert_close(y, wy, atol=0.0, rtol=0.0)
        torch.testing.assert_close(h, wh, atol=0.0, rtol=0.0)
    assert (flash_attention.launches, rglru_scan.launches) == before


@pytest.mark.parametrize("dh,entry", [
    (64, "flash_attention_bf16_wgmma"), (128, "flash_attention_bf16_wgmma"),
    (256, "flash_attention_bf16_wgmma"), (16, "flash_attention_bf16_wgmma"),
    (32, "flash_attention_bf16_wgmma"), (80, "flash_attention_bf16_wgmma"),
    (192, "flash_attention_bf16_wgmma"), (255, "flash_attention_bf16"),
    (36, "flash_attention_bf16"),
])
def test_flash_attention_bf16_entry_rule(dh, entry):
    """bf16 takes the tensor-core kernel at every width whose rows are
    whole 16 bytes (Dh % 8 == 0, as TMA needs; the head zero-padded to
    64, 128 or 256 there): every served width, Phi-3's 96 among them; the
    CUDA-core kernel at the others."""
    assert _flash_entry(torch.bfloat16, dh) == entry


@pytest.mark.parametrize("dh", [16, 64, 80, 128, 256])
def test_flash_attention_float32_takes_the_split_tf32_kernel(dh):
    """float32 at every width takes the tensor-core kernel that sums three
    TF32 products."""
    assert _flash_entry(torch.float32, dh) == "flash_attention_f32_tc"


def test_flash_attention_entry_rule_raises():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            _flash_entry(dtype, 64)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dim"):
            _flash_entry(dtype, 257)


def test_flash_attention_entries_exist_in_the_source():
    """Every entry point the rule names is a C entry of the kernel source."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    named = {_flash_entry(dtype, dh) for dtype in (torch.float32, torch.bfloat16)
             for dh in (16, 36, 64, 80, 96, 128, 256)}
    assert named == {"flash_attention_f32_tc", "flash_attention_bf16",
                     "flash_attention_bf16_wgmma"}
    # the CUDA-core float32 entry stays, as the "before" yardstick that
    # chip_smoke.py times; no rule names it
    for entry in named | {"flash_attention_f32"}:
        assert f'extern "C" int {entry}(' in src


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on its float32 bits: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b as the tensor cores take float32: one TF32 product
    (``products=1``), or each operand split into a TF32 high part and a
    TF32 remainder and ``hi·hi' + hi·lo' + lo·hi'`` (``products=3``).  A
    product of two TF32 values is exact in float32, so float32 matmuls of
    the parts model the hardware's exact products and float32 sums."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    out = ah @ bh
    if products == 3:
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
        out = al @ bh + ah @ bl + out
    return out


def _tf32_attention(q, k, v, causal, window, q_offset, products):
    """The float32 kernel's arithmetic: S = Q Kᵀ and O = P V (P unnormalized,
    at most 1) through ``_tf32_matmul``, a float32 softmax, O divided by
    the row sum; a row that sees no key gives 0."""
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    T, S, Dh = q.shape[2], k.shape[2], q.shape[3]
    qpos = torch.arange(T)[:, None] + q_offset
    kpos = torch.arange(S)[None, :]
    live = torch.ones(T, S, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    s = _tf32_matmul(q, k.transpose(-1, -2), products) * Dh ** -0.5
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    o = _tf32_matmul(p, v, products)
    return torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(o))


@pytest.mark.parametrize("B,Hq,Hkv,T,S,Dh,causal,window,qoff", [
    (1, 4, 2, 64, 64, 64, True, None, 0),     # Granite-like: GQA, causal
    (1, 4, 1, 48, 48, 256, True, 16, 0),      # RecurrentGemma-like: MQA, window
    (1, 4, 1, 20, 52, 16, True, 24, 32),      # reduced Qwen3's width, an offset
])
def test_split_tf32_products_keep_float32_accuracy(B, Hq, Hkv, T, S, Dh, causal,
                                                   window, qoff):
    """The split's rounding, emulated on the CPU: three TF32 products stay
    within the float32 kernel tolerance (the reference's atol 2e-5, rtol
    1e-2) of the plain version, and at least 10x closer to it than one TF32
    product (P, in [0, 1], is split too).  The emulation sums in exact
    float32 matmuls, so it bounds only the error of the split: the tensor
    cores' truncating accumulation along the kernel's chain of mma is not
    in it, and the card's tests (``tests/test_torch_cuda.py``) hold the
    kernel itself to the bar."""
    q = torch.from_numpy(_normal((B, Hq, T, Dh), 0))
    k = torch.from_numpy(_normal((B, Hkv, S, Dh), 1))
    v = torch.from_numpy(_normal((B, Hkv, S, Dh), 2))
    want = attention_ref(q, k, v, causal=causal, window=window, q_offset=qoff)
    three = _tf32_attention(q, k, v, causal, window, qoff, products=3)
    one = _tf32_attention(q, k, v, causal, window, qoff, products=1)
    torch.testing.assert_close(three, want, atol=2e-5, rtol=1e-2)
    err3 = float((three - want).abs().max())
    err1 = float((one - want).abs().max())
    assert 10 * err3 <= err1, (err3, err1)


def _wgmma_attention(q, k, v, causal, window, q_offset):
    """The bf16 ``wgmma`` kernel's arithmetic on the CPU: the head
    zero-padded to the instantiation's width (64, 128 or 256; TMA's fill),
    kv in tiles of its kv rows (128 at width 128, else 64), S = Q Kᵀ in
    float32 (a product of two bf16 values is exact in float32) scaled by
    the true Dh ** -0.5, the online softmax in float32 (the row sum of the
    unrounded P), P rounded to bf16 before P V, float32 sums, O divided by
    the row sum and rounded to bf16.  Returns (out, the padded O before the
    division)."""
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    T, S, dh = q.shape[2], k.shape[2], q.shape[3]
    width = next(w for w in (64, 128, 256) if dh <= w)
    bk = 128 if width == 128 else 64
    pad = (0, width - dh)
    qp, kp, vp = (torch.nn.functional.pad(x.float(), pad) for x in (q, k, v))
    qpos = torch.arange(T)[:, None] + q_offset
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:3] + (1,))
    o = torch.zeros(q.shape[:3] + (width,))
    for k0 in range(0, S, bk):
        kpos = torch.arange(k0, min(k0 + bk, S))[None, :]
        live = torch.ones(T, kpos.shape[1], dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        s = (qp @ kp[:, :, k0:k0 + bk].transpose(-1, -2)) * dh ** -0.5
        s = s.masked_fill(~live, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vp[:, :, k0:k0 + bk]
        m = m_new
    out = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(o))
    return out[..., :dh].to(torch.bfloat16), o


@pytest.mark.parametrize("B,Hq,Hkv,T,S,Dh,causal,window,qoff", [
    (1, 4, 4, 300, 300, 96, True, None, 0),   # Phi-3-vision: Hkv = Hq
    (2, 4, 2, 100, 260, 96, True, 64, 160),   # a window, an offset, GQA
    (1, 4, 1, 77, 190, 96, False, None, 0),   # not causal, MQA
    (1, 4, 2, 130, 130, 80, True, None, 0),   # Dh 80 (5 of 8 k-steps)
    (1, 2, 1, 70, 150, 40, True, 50, 80),     # Dh 40, padded to 64
])
def test_wgmma_route_arithmetic_holds_the_bf16_bar(B, Hq, Hkv, T, S, Dh, causal,
                                                   window, qoff):
    """The ``wgmma`` route at widths off the 64-column grid, emulated on the
    CPU (``_wgmma_attention``): within the bf16 kernel tolerance of the
    plain version, and the padded columns of O (V's zeros) exactly 0.  The
    emulation's float32 matmuls stand for the tensor cores' sums, so the
    card's tests (``tests/test_torch_cuda.py``) hold the kernel itself."""
    q, k, v = (torch.from_numpy(_normal((B, h, n, Dh), seed)).to(torch.bfloat16)
               for seed, (h, n) in enumerate(((Hq, T), (Hkv, S), (Hkv, S))))
    want = attention_ref(q, k, v, causal=causal, window=window, q_offset=qoff)
    got, o_padded = _wgmma_attention(q, k, v, causal, window, qoff)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool((o_padded[..., Dh:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **KTOL["bfloat16"])


#: the reference's bar for the Mamba kernel (tests/test_kernels.py:81-87):
#: atol 5 × the kernel tolerance, rtol 3e-2
MAMBA_TOL = {"float32": dict(atol=5 * 2e-5, rtol=3e-2),
             "bfloat16": dict(atol=5 * 2e-2, rtol=3e-2)}


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _mamba_inputs(B, T, Di, Ds, seed=0):
    """x, Δ = softplus(N), A = -softplus(N), B, C, D: the reference kernel
    tests' distributions, from numpy."""
    return (_normal((B, T, Di), seed), _softplus(_normal((B, T, Di), seed + 1)),
            -_softplus(_normal((Di, Ds), seed + 2)), _normal((B, T, Ds), seed + 3),
            _normal((B, T, Ds), seed + 4), _normal((Di,), seed + 5))


def _mamba_both(arrays, h0, dtype):
    """(jax arrays, torch tensors) of the Mamba inputs: x, Δ, B and C in
    ``dtype``, A, D and h0 in float32, as the reference tests give them."""
    x, delta, A, Bc, Cc, D = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    act = (0, 1, 3, 4)
    j = [jnp.asarray(a, jd if i in act else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(td if i in act else torch.float32)
         for i, a in enumerate(arrays)]
    j.append(None if h0 is None else jnp.asarray(h0))
    t.append(None if h0 is None else torch.from_numpy(h0))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,Di,Ds,chunk", [
    (2, 64, 32, 8, 16), (1, 100, 64, 16, 32), (1, 33, 16, 4, 16)])
def test_mamba_plain_version_matches_reference(dtype, with_h0, B, T, Di, Ds,
                                               chunk):
    """Against the reference's plain version and its Pallas kernel
    (interpret mode), at the reference kernel tests' shapes."""
    arrays = _mamba_inputs(B, T, Di, Ds)
    h0 = _normal((B, Di, Ds), 6) if with_h0 else None
    j, t = _mamba_both(arrays, h0, dtype)
    pallas = pallas_mamba(*j, chunk=chunk, block_d=Di)
    oracle = rref.mamba_scan_ref(*j)
    y, h_t = mamba_scan_ref(*t)
    assert y.dtype == getattr(torch, dtype) and h_t.dtype == torch.float32
    assert tuple(y.shape) == (B, T, Di) and tuple(h_t.shape) == (B, Di, Ds)
    for want_y, want_h in (pallas, oracle):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y.astype(jnp.float32)),
                                   **MAMBA_TOL[dtype])
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h),
                                   **MAMBA_TOL[dtype])


def test_mamba_two_halves_equal_the_whole():
    """Scanning two halves with the carried state == scanning the whole
    (the reference's ``test_stateful_equals_full``)."""
    x, delta, A, Bc, Cc, D = (torch.from_numpy(a)
                              for a in _mamba_inputs(1, 64, 32, 8, seed=2))
    y, h = mamba_scan_ref(x, delta, A, Bc, Cc, D)
    y1, h1 = mamba_scan_ref(x[:, :32], delta[:, :32], A, Bc[:, :32],
                            Cc[:, :32], D)
    y2, h2 = mamba_scan_ref(x[:, 32:], delta[:, 32:], A, Bc[:, 32:],
                            Cc[:, 32:], D, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h2, h, atol=1e-5, rtol=1e-5)


def test_mamba_scan_on_cpu_takes_the_plain_version():
    """The wrapper and ``ops.ssm_scan`` on CPU tensors, with A and D in
    another dtype than the activations (bf16 parameters, float32 decode
    activations), launch nothing."""
    x, delta, A, Bc, Cc, D = (torch.from_numpy(a)
                              for a in _mamba_inputs(2, 5, 8, 4, seed=3))
    A, D = A.bfloat16(), D.bfloat16()
    h0 = torch.from_numpy(_normal((2, 8, 4), 4))
    before = mamba_scan.launches
    wy, wh = mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)
    for y, h in (mamba_scan(x, delta, A, Bc, Cc, D, h0),
                 ops.ssm_scan(x, delta, A, Bc, Cc, D, h0),
                 ops.ssm_scan(x, delta, A, Bc, Cc, D, h0, use_kernel=False)):
        torch.testing.assert_close(y, wy, atol=0.0, rtol=0.0)
        torch.testing.assert_close(h, wh, atol=0.0, rtol=0.0)
    assert mamba_scan.launches == before


# ---------------------------------------------------------------------------
# MoE dispatch and combine
# ---------------------------------------------------------------------------

#: (T, D, E, C): the reference kernel tests' shapes (tests/test_kernels.py)
MOE_CASES = [(128, 32, 4, 40), (200, 64, 8, 16), (64, 16, 3, 64)]


def _moe_inputs(T, D, E, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, D)).astype(np.float32),
            rng.integers(0, E, size=T).astype(np.int32))


def _pallas_moe(tokens, ids, slots, E, C, dtype="float32", block_t=48):
    """The reference's Pallas kernel (interpret mode) as float32 numpy."""
    out = pallas_moe(jnp.asarray(tokens, getattr(jnp, dtype)), jnp.asarray(ids),
                     jnp.asarray(slots), E, C, block_t=block_t)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("T,D,E,C", MOE_CASES)
def test_compute_slots_matches_reference(T, D, E, C):
    _, ids = _moe_inputs(T, D, E)
    want = np.asarray(ref_compute_slots(jnp.asarray(ids), E))
    got = compute_slots(torch.from_numpy(ids), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,C", MOE_CASES)
def test_moe_dispatch_plain_version_matches_reference(T, D, E, C, dtype):
    """Against the reference's plain version and its Pallas kernel, at slots
    from ``compute_slots`` (capacity overflow drops at the 200-token
    case).  Unique pairs: each kept row lands once, so the outputs are
    equal, not merely close."""
    tokens, ids = _moe_inputs(T, D, E)
    slots = np.array(ref_compute_slots(jnp.asarray(ids), E))
    jt = jnp.asarray(tokens, getattr(jnp, dtype))
    oracle = np.asarray(rref.moe_dispatch_ref(jt, jnp.asarray(ids),
                                              jnp.asarray(slots), E, C)
                        .astype(jnp.float32))
    pallas = _pallas_moe(tokens, ids, slots, E, C, dtype)
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    got = moe_dispatch_ref(tt, torch.from_numpy(ids), torch.from_numpy(slots),
                           E, C)
    assert got.dtype == tt.dtype and tuple(got.shape) == (E, C, D)
    for want in (oracle, pallas):
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_moe_capacity_overflow_drops():
    """All tokens to expert 0 with capacity 4: only the first 4 survive."""
    tokens = torch.arange(80, dtype=torch.float32).reshape(8, 10)
    ids = torch.zeros(8, dtype=torch.int32)
    slots = compute_slots(ids, 2)
    out = moe_dispatch_ref(tokens, ids, slots, 2, 4)
    torch.testing.assert_close(out[0], tokens[:4], atol=0.0, rtol=0.0)
    assert float(out[1].abs().sum()) == 0.0
    pallas = _pallas_moe(tokens.numpy(), ids.numpy(), slots.numpy(), 2, 4,
                         block_t=8)
    np.testing.assert_array_equal(out.numpy(), pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_duplicate_pairs_are_summed(dtype):
    """Rows that share an (expert, slot) pair add up, in float32 then cast,
    as the TPU kernel's one-hot product adds them: the MoE layer's clamped
    slots at a planned capacity above C repeat pairs."""
    rng = np.random.default_rng(4)
    T, D, E, C = 96, 16, 3, 5
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    ids = rng.integers(0, E, size=T).astype(np.int32)
    slots = rng.integers(0, C, size=T).astype(np.int32)  # ~6 rows per pair
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    got = moe_dispatch_ref(tt, torch.from_numpy(ids), torch.from_numpy(slots),
                           E, C).float().numpy()
    pallas = _pallas_moe(tokens, ids, slots, E, C, dtype)
    want = np.zeros((E, C, D), np.float64)
    np.add.at(want, (ids, slots), tt.float().numpy())
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_plain_version_sums_rows_in_row_order(dtype):
    """On the CPU the plain version adds the rows of a repeated pair in row
    order, in float32: equal bit for bit to a sequential float32 sum.  The
    card's kernel sums them in the same order, and its card test holds it
    to the plain version on a CPU copy bit for bit."""
    rng = np.random.default_rng(9)
    T, D, E, C = 24_000, 48, 6, 40
    # magnitudes over six decades, so that another order rounds otherwise
    tokens = (rng.normal(size=(T, D)) * 10.0 ** rng.integers(-3, 3, size=(T, 1))
              ).astype(np.float32)
    ids = rng.integers(0, E, size=T).astype(np.int32)
    slots = rng.integers(0, C + 3, size=T).astype(np.int32)  # ~100 a pair
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    got = moe_dispatch_ref(tt, torch.from_numpy(ids), torch.from_numpy(slots),
                           E, C)
    keep = slots < C
    want = np.zeros((E, C, D), np.float32)
    np.add.at(want, (ids[keep], slots[keep]), tt.float().numpy()[keep])
    want = torch.from_numpy(want).to(getattr(torch, dtype))
    assert torch.equal(got, want)
    shuffled = np.zeros((E, C, D), np.float32)
    order = rng.permutation(np.nonzero(keep)[0])
    np.add.at(shuffled, (ids[order], slots[order]), tt.float().numpy()[order])
    assert not np.array_equal(shuffled, want.float().numpy())


@pytest.mark.parametrize("name,entries,zero_fills", [
    ("segment_sum", ("segment_sum_f32", "segment_sum_bf16"), "out"),
    ("moe_dispatch", ("moe_dispatch_f32", "moe_dispatch_bf16"), "tables"),
])
def test_reduce_kernels_enter_c_once_and_zero_fill_there(name, entries,
                                                         zero_fills):
    """Each entry the wrapper names is a C entry of the kernel source, and
    the source zero-fills its buffer on the caller's stream with
    cudaMemsetAsync, so the wrapper allocates it with ``torch.empty`` and
    makes one ctypes call; the wrapper enters no ``torch.cuda.device``
    context and makes no ``torch.zeros`` of its own."""
    import importlib
    import inspect

    module = importlib.import_module(
        {"segment_sum": "repro_torch.kernels.segment_reduce",
         "moe_dispatch": "repro_torch.kernels.moe_dispatch"}[name])
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert set(module._ENTRY.values()) == set(entries)
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    assert re.search(rf"cudaMemsetAsync\(\s*{zero_fills},\s*0,", src)
    wrapper = inspect.getsource(getattr(module, name))
    assert "torch.cuda.device(" not in wrapper
    assert "torch.zeros" not in wrapper
    assert wrapper.count("_kernel(") == 1


def test_moe_dispatch_small_path_tables_fit_a_launch():
    """The one-launch path's index, 2·E·C int32 at the largest dispatch the
    wrapper sends it, fits the 48 KB of shared memory a launch may take
    without opting in; a larger one would fail to launch, and raise."""
    from repro_torch.kernels.moe_dispatch import _SMALL_PAIRS

    assert 2 * _SMALL_PAIRS * 4 <= 48 * 1024


def test_moe_out_of_range_ids_and_slots_are_dropped():
    """Expert ids outside [0, E) and slots outside [0, C), negative ones
    included, are dropped, as the TPU kernel drops them (the reference's
    plain version wraps negative indices; its kernel does not)."""
    rng = np.random.default_rng(5)
    T, D, E, C = 120, 8, 4, 6
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    ids = rng.integers(-2, E + 2, size=T).astype(np.int32)
    slots = rng.integers(-2, C + 2, size=T).astype(np.int32)
    got = moe_dispatch_ref(torch.from_numpy(tokens), torch.from_numpy(ids),
                           torch.from_numpy(slots), E, C).numpy()
    np.testing.assert_allclose(got, _pallas_moe(tokens, ids, slots, E, C),
                               **TOL["float32"])
    kept = (ids >= 0) & (ids < E) & (slots >= 0) & (slots < C)
    want = np.zeros((E, C, D), np.float64)
    np.add.at(want, (ids[kept], slots[kept]), tokens[kept])
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("T,D,E,C", MOE_CASES)
def test_moe_combine_plain_version_matches_reference(T, D, E, C):
    tokens, ids = _moe_inputs(T, D, E, seed=6)
    rng = np.random.default_rng(7)
    expert_out = rng.normal(size=(E, C, D)).astype(np.float32)
    gates = rng.uniform(size=T).astype(np.float32)
    slots = np.array(ref_compute_slots(jnp.asarray(ids), E))
    want = rref.moe_combine_ref(jnp.asarray(expert_out), jnp.asarray(ids),
                                jnp.asarray(slots), jnp.asarray(gates), C)
    got = moe_combine_ref(torch.from_numpy(expert_out), torch.from_numpy(ids),
                          torch.from_numpy(slots), torch.from_numpy(gates), C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_dispatch_combine_round_trip():
    """dispatch → identity expert → combine gives the gated tokens back
    (capacity ample: no drops)."""
    T, D, E, C = 96, 16, 4, 96
    tokens, ids = _moe_inputs(T, D, E, seed=3)
    gates = torch.sigmoid(torch.from_numpy(_normal((T,), 8)))
    t, i = torch.from_numpy(tokens), torch.from_numpy(ids)
    buf, slots = ops.dispatch_tokens(t, i, E, C)
    back = ops.combine_tokens(buf, i, slots, gates, C)
    torch.testing.assert_close(back, t * gates[:, None], atol=1e-6, rtol=1e-6)


def test_dispatch_tokens_matches_the_reference_kernel_path():
    """``ops.dispatch_tokens`` against the reference's, which at 128 tokens
    runs its Pallas kernel (interpret mode): the same buffers and slots."""
    T, D, E, C = 128, 32, 4, 24  # expert loads of ~32 > C: drops
    tokens, ids = _moe_inputs(T, D, E, seed=9)
    want_buf, want_slots = rops.dispatch_tokens(jnp.asarray(tokens),
                                                jnp.asarray(ids), E, C)
    buf, slots = ops.dispatch_tokens(torch.from_numpy(tokens),
                                     torch.from_numpy(ids), E, C)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(want_slots))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))


def test_moe_dispatch_on_cpu_takes_the_plain_version():
    tokens, ids = _moe_inputs(40, 8, 3, seed=10)
    t, i = torch.from_numpy(tokens), torch.from_numpy(ids)
    slots = compute_slots(i, 3)
    before = moe_dispatch.launches
    want = moe_dispatch_ref(t, i, slots, 3, 10)
    for out in (moe_dispatch(t, i, slots, 3, 10),
                ops.dispatch_at_slots(t, i, slots, 3, 10),
                ops.dispatch_at_slots(t, i, slots, 3, 10, use_kernel=False),
                ops.dispatch_tokens(t, i, 3, 10)[0]):
        torch.testing.assert_close(out, want, atol=0.0, rtol=0.0)
    assert moe_dispatch.launches == before


def _grad_inputs(seed=0):
    """Small inputs of each kernel wrapper, floats requiring grad; the call
    of each wrapper on them."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g).requires_grad_()

    ids = torch.tensor([0, 2, 2, 1, 5], dtype=torch.int32)
    slots = torch.tensor([0, 0, 1, 3, 1], dtype=torch.int32)
    a = torch.rand((2, 5, 8), generator=g).requires_grad_()
    return {
        "segment_sum": lambda: segment_sum(r(5, 3), ids, 4),
        "flash_attention": lambda: flash_attention(r(1, 4, 6, 8), r(1, 2, 6, 8),
                                                   r(1, 2, 6, 8)),
        "mamba_scan": lambda: mamba_scan(
            r(2, 5, 8), torch.rand((2, 5, 8), generator=g).requires_grad_(),
            -torch.rand((8, 4), generator=g).requires_grad_(), r(2, 5, 4),
            r(2, 5, 4), r(8), r(2, 8, 4))[0],
        "rglru_scan": lambda: rglru_scan(r(2, 5, 8), a, r(2, 8))[0],
        "moe_dispatch": lambda: moe_dispatch(r(5, 3), ids, slots, 4, 2),
    }


def test_refuse_grad_raises_only_where_autograd_needs_a_backward():
    t, plain = torch.ones(3).requires_grad_(), torch.ones(3)
    with pytest.raises(RuntimeError, match="has no backward"):
        _build.refuse_grad("k", plain, None, t)
    _build.refuse_grad("k", plain, None)
    with torch.no_grad():
        _build.refuse_grad("k", t)


@pytest.mark.parametrize("name", sorted(_grad_inputs()))
def test_wrappers_stay_differentiable_on_the_cpu(name):
    """On a CPU tensor a wrapper computes its plain version, which autograd
    differentiates; the guard against a cut graph is for the card's
    kernels (``tests/test_torch_cuda.py``)."""
    out = _grad_inputs()[name]()
    assert out.requires_grad and out.grad_fn is not None
    out.float().square().sum().backward()
