"""The port's MapReduce applications against the reference's, on the CPU:
every application's per-reducer outputs and the engine's ``PhaseStats``
byte matrices are identical under the uniform and the local-push plans at
the examples' corpus size.  Word count's reduce is the only code that
differs (the port's ``segment_sum`` in place of the Pallas kernel); its
counts are integers below 2^24 in float32, so they agree exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.plan import local_push_plan as r_local  # noqa: E402
from repro.core.plan import uniform_plan as r_uniform  # noqa: E402
from repro.core.platform import planetlab_platform as r_planetlab  # noqa: E402
from repro.mapreduce import apps as rapps  # noqa: E402
from repro.mapreduce.engine import GeoMapReduce as RGeoMapReduce  # noqa: E402
from repro_torch.core.plan import local_push_plan as t_local  # noqa: E402
from repro_torch.core.plan import uniform_plan as t_uniform  # noqa: E402
from repro_torch.core.platform import planetlab_platform as t_planetlab  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_sum  # noqa: E402
from repro_torch.mapreduce import apps as tapps  # noqa: E402
from repro_torch.mapreduce.engine import GeoMapReduce as TGeoMapReduce  # noqa: E402

#: (name, corpus, reference app, port app); the corpora are the examples'
#: sizes, word count's at generate_documents(800, 60)
APPS = {
    "word_count": ("docs", rapps.word_count, lambda: tapps.word_count(device="cpu")),
    "sessionization": ("logs", lambda: rapps.sessionization(gap=1000),
                       lambda: tapps.sessionization(gap=1000)),
    "inverted_index": ("docs", rapps.inverted_index, tapps.inverted_index),
    "synthetic_alpha_0.5": ("ids", lambda: rapps.synthetic_alpha_job(0.5),
                            lambda: tapps.synthetic_alpha_job(0.5)),
    "synthetic_alpha_2.0": ("ids", lambda: rapps.synthetic_alpha_job(2.0),
                            lambda: tapps.synthetic_alpha_job(2.0)),
}
PLANS = {"uniform": (r_uniform, t_uniform), "local_push": (r_local, t_local)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(kind, gen):
    if kind == "docs":
        return gen.generate_documents(800, 60, seed=0)
    if kind == "logs":
        return gen.generate_logs(5000, n_users=50, seed=3)
    keys = np.arange(4000, dtype=np.int64)
    return keys, keys.copy()


def _split(keys, values, n):
    return list(zip(np.array_split(keys, n), np.array_split(values, n)))


@pytest.mark.parametrize("kind", ["docs", "logs"])
def test_corpora_identical(kind):
    for r, t in zip(_corpus(kind, rapps), _corpus(kind, tapps)):
        np.testing.assert_array_equal(t, r)


@pytest.mark.parametrize("plan_kind", list(PLANS))
@pytest.mark.parametrize("app_name", list(APPS))
def test_outputs_and_phase_stats_identical(app_name, plan_kind):
    kind, r_app, t_app = APPS[app_name]
    rp, tp = r_planetlab(8, alpha=1.0, seed=0), t_planetlab(8, alpha=1.0, seed=0)
    r_plan, t_plan = PLANS[plan_kind][0](rp), PLANS[plan_kind][1](tp)
    keys, vals = _corpus(kind, rapps)
    srcs = _split(keys, vals, rp.nS)
    r_outs, r_stats = RGeoMapReduce(rp, r_plan, r_app()).run(srcs)
    before = segment_sum.launches
    t_outs, t_stats = TGeoMapReduce(tp, t_plan, t_app()).run(srcs)
    assert segment_sum.launches == before  # CPU tensors: the plain version

    assert len(t_outs) == len(r_outs) == rp.nR
    for (tk, tv), (rk, rv) in zip(t_outs, r_outs):
        assert tk.dtype == rk.dtype and tv.dtype == rv.dtype
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tv, rv)
    for field in ("push_bytes", "map_in_bytes", "shuffle_bytes",
                  "reduce_in_bytes"):
        np.testing.assert_array_equal(getattr(t_stats, field),
                                      getattr(r_stats, field), err_msg=field)
    assert t_stats.alpha_measured == r_stats.alpha_measured
    assert t_stats.makespan(tp) == r_stats.makespan(rp)


def test_word_count_kernel_and_plain_paths_agree():
    """``use_kernel=False`` selects the plain version explicitly; on CPU
    tensors both paths are the plain version and give the same counts."""
    keys = np.array([3, 3, 5, 9, 9, 9], np.int64)
    counts = np.array([1, 2, 7, 1, 1, 4], np.int64)
    for use_kernel in (True, False):
        uniq, sums = tapps.word_count(use_kernel=use_kernel,
                                      device="cpu").reduce_fn(keys, counts)
        np.testing.assert_array_equal(uniq, [3, 5, 9])
        np.testing.assert_array_equal(sums, [3, 7, 6])
        assert sums.dtype == np.int64
