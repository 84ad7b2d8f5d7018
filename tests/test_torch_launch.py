"""The port's dry-run pieces against the reference's, in one process.

* ``launch/analysis.py`` is the reference's text but its import line;
  ``visible_context_sum`` and ``attention_flops`` give the reference's
  numbers over the reference test's ranges, for all 10 archs;
* ``collective_bytes`` gives ``collective_bytes_from_hlo``'s per-device
  bytes on the same collectives: every kind, groups of 1, 2, 4 and 16
  ranks (listed and iota replica groups), tuple results;
* ``input_specs`` and ``cache_specs`` give the reference's
  ``ShapeDtypeStruct`` stand-ins leaf by leaf (path, shape, dtype) for every
  ``(arch, shape)`` of ``cells()``, with and without the int8 KV cache,
  as meta tensors;
* ``DeviceCounter`` counts a DTensor matmul at its local size, where
  ``FlopCounterMode`` counts the global one (on a fake world, in a
  subprocess), and its meta replay gives the counts of a full trace.

The dry run on fake worlds and its agreement with real gloo worlds are in
``tests/test_torch_multidevice.py``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import analysis as RA  # noqa: E402
from repro_torch.configs import (ARCHS, cache_specs, cells,  # noqa: E402
                                 input_specs)
from repro_torch.launch import analysis as A  # noqa: E402
from repro_torch.launch.dryrun import (COLLECTIVE_KINDS,  # noqa: E402
                                       DeviceCounter, collective_bytes)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_dryrun():
    """The reference's dry-run module, imported without leaving its
    512-device ``XLA_FLAGS`` in this process's environment."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as dr
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dr


# ---------------------------------------------------------------------------
# launch/analysis.py
# ---------------------------------------------------------------------------

def test_analysis_is_the_reference_text_but_its_import():
    ref = (ROOT / "src/repro/launch/analysis.py").read_text()
    port = (ROOT / "src/repro_torch/launch/analysis.py").read_text()
    want = ref.replace("from repro.models.config import ArchConfig",
                       "from repro_torch.models.config import ArchConfig")
    assert want != ref
    assert port == want


@settings(max_examples=60, deadline=None)
@given(T=st.integers(1, 300), off=st.integers(0, 200),
       w=st.one_of(st.none(), st.integers(1, 128)))
def test_visible_context_sum_is_the_reference_s(T, off, w):
    assert A.visible_context_sum(T, off, w) == RA.visible_context_sum(T, off, w)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@settings(max_examples=25, deadline=None)
@given(kind=st.sampled_from(["train", "prefill", "decode"]),
       B=st.integers(1, 300), T=st.integers(1, 70000),
       cache_len=st.integers(0, 600000))
def test_attention_flops_is_the_reference_s(arch, kind, B, T, cache_len):
    got = A.attention_flops(ARCHS[arch], kind, B, T, cache_len)
    assert got == RA.attention_flops(REF_ARCHS[arch], kind, B, T, cache_len)


# ---------------------------------------------------------------------------
# collective accounting
# ---------------------------------------------------------------------------

_HLO_OP = {"all-reduce": "all-reduce", "all-gather": "all-gather",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}
#: result shapes: (HLO type, bytes of each element)
_SHAPES = [[("f32[1024]{0}", 4096)],
           [("bf16[2048,512]{1,0}", 2048 * 512 * 2)],
           [("f32[128]{0}", 512), ("f32[256]{0}", 1024)],
           [("bf16[16,8]{1,0}", 256), ("s32[3]{0}", 12), ("u8[5]{0}", 5)]]


def _hlo_line(i, kind, shapes, g, iota):
    res = shapes[0][0] if len(shapes) == 1 else \
        "(" + ", ".join(t for t, _ in shapes) + ")"
    groups = (f"replica_groups=[{256 // g},{g}]<=[256]" if iota
              else "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
    start = "-start" if len(shapes) > 1 else ""
    return f"%c.{i} = {res} {_HLO_OP[kind]}{start}(%x.{i}), {groups}"


@pytest.mark.parametrize("iota", [False, True], ids=["listed", "iota"])
@pytest.mark.parametrize("g", [1, 2, 4, 16])
def test_collective_bytes_is_the_reference_s(g, iota):
    """Every kind at every result shape (one, two or three tensors) in one
    program, and each kind alone: the port's bytes from ``(kind, S, G)``
    records equal the reference's from the HLO lines."""
    dr = _ref_dryrun()
    lines, records = [], []
    for i, (kind, shapes) in enumerate(
            (k, s) for k in COLLECTIVE_KINDS for s in _SHAPES):
        if iota and g == 1:
            continue  # an iota group of one rank is not valid HLO
        lines.append(_hlo_line(i, kind, shapes, g, iota))
        sizes = [n for _, n in shapes]
        records.append((kind, sizes if len(sizes) > 1 else sizes[0], g))
        one = collective_bytes(records[-1:])
        assert one == pytest.approx(dr.collective_bytes_from_hlo(lines[-1]))
    want = dr.collective_bytes_from_hlo("\n".join(lines))
    got = collective_bytes(records)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if g == 1:
        assert got["total"] == 0.0
    elif records:
        assert all(got[k] > 0 for k in COLLECTIVE_KINDS)


def test_collective_bytes_rejects_an_unknown_kind():
    with pytest.raises(ValueError):
        collective_bytes([("broadcast", 4, 2)])


# ---------------------------------------------------------------------------
# input_specs / cache_specs
# ---------------------------------------------------------------------------

def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in flat}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    assert tree.device.type == "meta"
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch,shape", cells(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_input_and_cache_specs_are_the_reference_s(arch, shape):
    import jax.numpy as jnp
    from repro.configs import cache_specs as ref_cache
    from repro.configs import input_specs as ref_inputs

    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        assert _port_leaves(input_specs(ARCHS[arch], shape, tdt)) == \
            _ref_leaves(ref_inputs(REF_ARCHS[arch], shape, jdt))
        if shape.startswith(("decode", "long")):
            for kv_int8 in (False, True):
                got = _port_leaves(cache_specs(ARCHS[arch], shape, tdt,
                                               kv_int8=kv_int8))
                want = _ref_leaves(ref_cache(REF_ARCHS[arch], shape, jdt,
                                             kv_int8=kv_int8))
                assert got == want, (arch, shape, kv_int8)


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def test_counter_counts_a_dtensor_matmul_per_rank():
    """On a fake 8-rank world, a (256, 64) @ (64, 32) product whose left
    operand is sharded 8 ways: ``DeviceCounter`` counts the local (32, 64)
    @ (64, 32) product and no collective, ``FlopCounterMode`` the global
    one (the trap the dry run avoids)."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch.dryrun import DeviceCounter
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=8)
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        w = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                               [Replicate()], run_check=False)
        c = DeviceCounter("meta")
        with c:
            y = x @ w
        f = FlopCounterMode(display=False)
        with f:
            x @ w
        assert c.flops == 2 * 32 * 64 * 32, c.flops
        assert f.get_total_flops() == 8 * c.flops
        assert c.collectives == [] and tuple(y.shape) == (256, 32)
        with c:
            z = y.redistribute(mesh, [Replicate()])
        assert c.collectives == [("all-gather", 256 * 32 * 4, 8)], c.collectives
        dist.destroy_process_group()
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("arch,batch,seq", [
    # (3, 4096) is past the dense-attention limit: chunked_attention runs
    ("granite-moe-3b-a800m", 3, 4096),
    ("falcon-mamba-7b", 2, 256),
    ("recurrentgemma-9b", 2, 256),
])
def test_counter_replay_gives_the_counts_of_a_full_trace(arch, batch, seq):
    """A reduced prefill traced on meta tensors: flops, bytes, ops, the
    peak and the collectives are the same with the meta replay (ops, and
    the calls of ``chunked_attention`` and the plain scans) as without it,
    and its flops equal ``FlopCounterMode``'s on real CPU tensors of the
    same shapes."""
    import contextlib

    import repro_torch.launch.dryrun as D
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from torch.utils.flop_counter import FlopCounterMode

    cfg = ARCHS[arch].reduced()
    params = D.meta_params(cfg, torch.float32)
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")

    def trace(replay):
        c = DeviceCounter("meta")
        with contextlib.ExitStack() as stack:
            if replay:
                for owner, name in ((layers, "chunked_attention"),
                                    (ref, "mamba_scan_ref"),
                                    (ref, "rglru_scan_ref")):
                    stack.enter_context(c.memoized(owner, name))
            else:
                c._remember = lambda *a, **k: None  # never replay an op
            stack.enter_context(c)
            c.arguments(params, tokens)
            out = M.prefill(cfg, params, {"tokens": tokens},
                            max_cache_len=seq)
            del out
        return c.flops, c.operand_bytes, c.ops, c.peak, c.collectives

    full, replayed = trace(False), trace(True)
    assert replayed == full
    assert full[0] > 0 and full[3] > 0
    real = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    f = FlopCounterMode(display=False)
    with f:
        M.prefill(cfg, real, {"tokens": torch.zeros((batch, seq),
                                                    dtype=torch.int32)},
                  max_cache_len=seq)
    assert f.get_total_flops() == full[0]


def test_counter_reruns_in_place_ops_that_reshape():
    """The meta replay never hands back an in-place op's argument without
    running it when the op changes its shape (``unsqueeze_``,
    ``resize_``); an in-place op that keeps it is replayed, and the
    counts agree with a run without the replay."""
    def run(replay):
        c = DeviceCounter("meta")
        if not replay:
            c._remember = lambda *a, **k: None
        shapes = []
        with c:
            for _ in range(3):
                x = torch.empty(3, 4, device="meta")
                x.unsqueeze_(0)
                y = torch.empty(0, device="meta")
                y.resize_(5, 2)
                x.add_(1.0).mul_(x)
                shapes.append((tuple(x.shape), tuple(y.shape)))
        return shapes, c.ops, c.operand_bytes, c.peak

    got, want = run(True), run(False)
    assert got == want
    assert got[0] == [((1, 3, 4), (5, 2))] * 3
