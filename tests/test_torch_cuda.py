"""The port's Hopper kernels on a CUDA card, against their plain versions.

Every test here is marked ``cuda`` and skips where no card is present: a
CUDA kernel has no CPU mode.  The file needs neither ``jax`` nor the
reference package, so it also runs on a machine with only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import segment_sum_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_sum  # noqa: E402
from repro_torch.mapreduce.apps import word_count  # noqa: E402

pytestmark = pytest.mark.cuda

#: float32 atomics sum in an order that changes from run to run: sums of
#: N(0,1) rows agree to atol 1e-4 (the reference's kernel tolerance); a
#: bfloat16 output may round to the neighbouring bf16 value (2^-8
#: relative).
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}


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
