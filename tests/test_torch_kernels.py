"""The port's ``segment_sum``: its plain PyTorch version against the
reference's Pallas kernel (interpret mode on the CPU) and jnp oracle, and
the CPU dispatch of the wrapper and the ops layer.  The Hopper kernel
itself is held against the plain version in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.segment_reduce import segment_sum as pallas_segment_sum  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import segment_sum_ref  # noqa: E402
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

