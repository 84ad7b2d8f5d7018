#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout: the script puts ``src/`` on ``sys.path``
itself and imports only ``repro_torch`` (never ``jax`` or ``repro``).  It
needs one CUDA card, builds the port's kernels from ``src/repro_torch/
kernels/csrc/`` on first use (into ``build/repro_torch_kernels/``), and
exits nonzero, with no result line, on any fault.

Phases:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the kernel build time with ``ptxas`` resource usage.
2. Main path, the paper's loop through ``GeoJob`` at the paper's scale: the
   8-data-center PlanetLab platform, a 20M-word Zipf corpus (``vocab`` 2^20,
   the largest the 20-bit word packing allows), ``calibrate`` →
   ``plan("e2e_multi")`` at the default 24 restarts × 500 steps →
   ``execute``, then the same job under the uniform and Hadoop-locality
   plans.  Word counts must equal an independent numpy count, every
   non-empty reducer must have launched the kernel, the optimized plan must
   beat both baselines on measured makespan, and ``model_error`` must be
   finite.  The ``segment_sum`` launch count is zeroed just before and read
   just after.
3. Kernels against their plain versions on the card, at the shapes the main
   path gave them (every reducer's input, recorded) and at stress shapes:
   unsorted and out-of-range ids, a reducer without in-mapper combining,
   and wide rows in float32 and bfloat16.  Times are CUDA-event medians.
   Prints one ``{"kernels": [...]}`` line.
4. Batched solver: 64 PlanetLab platforms planned in one batched solve;
   every plan valid and never worse than uniform.  Then the device busy
   share of a warm single-job solve, from ``torch.profiler``.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor
#: core) operations/s, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: main-path scale: the paper's 8-DC testbed and a 20M-word corpus
N_DOCS, WORDS_PER_DOC, VOCAB = 20_000, 1_000, 1 << 20
N_RESTARTS, STEPS = 24, 500
BATCH = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _sync(device) -> None:
    """Wait for the card, so that a fault shows where it happened."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, runs: int = 30, per_run: int = 10, warmup: int = 5) -> float:
    """Median milliseconds per call of ``fn`` on the current stream: CUDA
    events around ``per_run`` back-to-back calls, median over ``runs``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_run)
    return statistics.median(samples)


def kernel_device_ms(fn, name: str, calls: int = 20):
    """Mean device time of the CUDA kernels whose name contains ``name``
    per call of ``fn``, from ``torch.profiler``; ``None`` where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:  # the profiler cannot trace this machine
        print(f"  profiler unavailable: {exc}")
        return None
    total_us = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += (getattr(ev, "device_time_total", None)
                         or getattr(ev, "cuda_time_total", 0.0))
    return total_us / calls / 1e3 if total_us > 0 else None


def segment_sum_bound_ms(n_kept: int, n: int, d: int, s: int, elem: int):
    """Least time for the function: kept rows' values and every id read
    once, the (S, D) output written once; one float32 add per kept
    element.  Returns (ms, "bytes" | "operations")."""
    bytes_ms = (n_kept * d * elem + 4 * n + s * d * elem) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_kept * d / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch
    from repro_torch.kernels import _build

    print("== phase 1: environment", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(len(smi) >= 1, "nvidia-smi listed no card")
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = _build.build("segment_sum")
    _build.load("segment_sum")
    print(f"kernel build: segment_sum -> {so.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in _build.build_log("segment_sum").splitlines():
        if "ptxas info" in line:
            print(f"  {line.strip()}")
    return smi[0]


def phase_main_path(device, n_docs=N_DOCS, words_per_doc=WORDS_PER_DOC,
                    vocab=VOCAB, n_restarts=N_RESTARTS, steps=STEPS):
    """The paper's loop through GeoJob; returns the reducer inputs of the
    optimized run (what the kernel was given) and the launch count."""
    import numpy as np
    import torch
    from repro_torch.api import GeoJob, split_sources
    from repro_torch.core import (BARRIERS_GGL, local_push_plan,
                                  planetlab_platform, uniform_plan)
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.mapreduce.apps import generate_documents, word_count

    print("== phase 2: main path (GeoJob word count)", flush=True)
    t0 = time.perf_counter()
    keys, vals = generate_documents(n_docs=n_docs, words_per_doc=words_per_doc,
                                    vocab=vocab, seed=0)
    words = vals & ((1 << 20) - 1)
    expect_keys, expect_counts = np.unique(words, return_counts=True)
    base = planetlab_platform(8, alpha=1.0, seed=0)
    sources = split_sources(keys, vals, base.nS)
    print(f"corpus: {words.size} words, {expect_keys.size} distinct, "
          f"made in {time.perf_counter() - t0:.3f} s")

    recorded = []
    wc = word_count(device=device)

    def recording_reduce(k, v):
        recorded.append((k, v))
        return wc.reduce_fn(k, v)

    app = dataclasses.replace(wc, reduce_fn=recording_reduce)

    def run(job, label):
        recorded.clear()
        before = segment_sum.launches
        t = time.perf_counter()
        report = job.execute(sources)
        _sync(device)
        wall = time.perf_counter() - t
        launched = segment_sum.launches - before
        nonempty = sum(1 for k, _ in report.outputs if k.shape[0])
        check(launched >= nonempty,
              f"{label}: {launched} segment_sum launches for {nonempty} "
              "non-empty reducers")
        out_k = np.concatenate([k for k, _ in report.outputs])
        out_v = np.concatenate([v for _, v in report.outputs])
        order = np.argsort(out_k, kind="stable")
        check(np.array_equal(out_k[order], expect_keys)
              and np.array_equal(out_v[order], expect_counts),
              f"{label}: word counts differ from the numpy count")
        err = report.model_error()
        check(np.isfinite(err), f"{label}: model_error {err} not finite")
        print(f"{label:16s} execute {wall:.3f} s  measured makespan "
              f"{report.makespan_measured!r} s  modeled "
              f"{report.makespan_modeled!r} s  model_error {err!r}  "
              f"launches {launched} (non-empty reducers {nonempty})")
        return report, wall, list(recorded)

    segment_sum.launches = 0
    t = time.perf_counter()
    job = GeoJob(base, app, device=device).calibrate(sources)
    print(f"calibrate {time.perf_counter() - t:.3f} s  alpha "
          f"{job.platform.alpha!r}")
    t = time.perf_counter()
    job.plan("e2e_multi", barriers=BARRIERS_GGL, n_restarts=n_restarts,
             steps=steps)
    solve_s = time.perf_counter() - t
    print(f"solve e2e_multi {n_restarts}x{steps}: {solve_s:.3f} s (first "
          f"call)  modeled makespan {job.planned.makespan!r} s")
    opt, _, reducer_inputs = run(job, "optimized")
    uni, _, _ = run(job.with_plan(uniform_plan(job.platform), BARRIERS_GGL),
                    "uniform")
    loc, _, _ = run(job.with_plan(local_push_plan(job.platform), BARRIERS_GGL),
                    "hadoop-locality")
    launches = segment_sum.launches
    check(launches > 0, "the main path never launched segment_sum")
    for name, other in (("uniform", uni), ("hadoop-locality", loc)):
        check(opt.makespan_measured < other.makespan_measured,
              f"optimized measured makespan {opt.makespan_measured} does "
              f"not beat {name} ({other.makespan_measured})")
    print(f"main path: segment_sum launches {launches}")

    t = time.perf_counter()
    job.plan("e2e_multi", barriers=BARRIERS_GGL, n_restarts=n_restarts,
             steps=steps)
    warm_s = time.perf_counter() - t
    print(f"solve e2e_multi {n_restarts}x{steps}: {warm_s:.3f} s (second "
          f"call)  modeled makespan {job.planned.makespan!r} s")
    return reducer_inputs, launches


def _reduce_tensors(keys, values, device):
    """What word count's reduce hands the kernel for one reducer."""
    import numpy as np
    import torch

    uniq = np.unique(keys)
    seg = np.searchsorted(uniq, keys).astype(np.int32)
    v = torch.from_numpy(np.asarray(values, np.float32)[:, None]).to(device)
    return v, torch.from_numpy(seg).to(device), int(uniq.shape[0])


def phase_kernels(device, reducer_inputs, launches):
    import numpy as np
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment_reduce import segment_sum

    print("== phase 3: kernels against their plain versions", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    # (label, values, ids, S, atol, rtol); tolerances: integer-valued float32
    # sums below 2^24 are exact in any order; N(0,1) float32 sums of a few
    # dozen terms differ by < 1e-5 between orders; bfloat16 outputs may
    # round to neighbouring values (one bf16 ulp, 2^-8 relative).
    cases = []
    for r, (k, v) in enumerate(reducer_inputs):
        if k.shape[0]:
            vals, ids, s = _reduce_tensors(k, v, device)
            cases.append((f"main-path reducer {r}", vals, ids, s, 0.0, 0.0))
    check(cases, "the main path recorded no reducer input")
    main = max(cases, key=lambda c: c[1].shape[0])
    vals, ids, s = main[1], main[2], main[3]
    n = ids.shape[0]
    perm = torch.randperm(n, generator=gen).to(device)
    cases.append(("main-path shape, unsorted ids", vals[perm].contiguous(),
                  ids[perm].contiguous(), s, 0.0, 0.0))
    bad = ids[perm].clone()
    bad[::7] = s + 3
    bad[3::11] = -1
    cases.append(("main-path shape, out-of-range ids", vals[perm].contiguous(),
                  bad, s, 0.0, 0.0))
    # a reducer without in-mapper combining: one record per word occurrence
    big_n, big_s = 2_500_000, 131_072
    rng = np.random.default_rng(0)
    z = np.sort(np.minimum(rng.zipf(1.4, size=big_n), big_s) - 1)
    cases.append(("no combining N=2.5M S=131072",
                  torch.ones(big_n, 1, device=device),
                  torch.from_numpy(z.astype(np.int32)).to(device), big_s,
                  0.0, 0.0))
    wide_ids = torch.from_numpy(
        np.sort(rng.integers(0, 4096, size=65_536)).astype(np.int32)).to(device)
    wide = torch.randn(65_536, 128, generator=gen).to(device)
    cases.append(("wide f32 N=65536 S=4096 D=128", wide, wide_ids, 4096,
                  1e-4, 1e-5))
    cases.append(("wide bf16 N=65536 S=4096 D=128",
                  wide.to(torch.bfloat16), wide_ids, 4096, 1e-3, 1e-2))

    rows = []
    for label, v, i, s, atol, rtol in cases:
        got = segment_sum(v, i, s)
        _sync(device)
        want = segment_sum_ref(v, i, s)
        _sync(device)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
              f"{tuple(want.shape)} {want.dtype}")
        err = (got.float() - want.float()).abs()
        lim = atol + rtol * want.float().abs()
        check(bool(torch.all(err <= lim)),
              f"{label}: max |err| {float(err.max())} over atol {atol} "
              f"rtol {rtol}")
        rows.append((label, v, i, s, float(err.max()) if err.numel() else 0.0))
        print(f"{label:36s} N={i.shape[0]} S={s} D={v.shape[1]} {v.dtype}: "
              f"max |err| {rows[-1][4]!r} (atol {atol}, rtol {rtol})")

    entry = None
    for label, v, i, s, err in rows:
        if label != main[0] and not label.startswith(("no combining", "wide")):
            continue
        n, d = v.shape
        kept = int(((i >= 0) & (i < s)).sum())
        elem = v.element_size()
        bound, bound_by = segment_sum_bound_ms(kept, n, d, s, elem)
        ms = time_ms(lambda: segment_sum(v, i, s))
        plain = time_ms(lambda: segment_sum_ref(v, i, s))
        library = None
        if v.dtype == torch.float32:
            i64 = i.long()
            library = time_ms(
                lambda: torch.zeros(s, d, device=device).index_add_(0, i64, v))
        dev_ms = kernel_device_ms(lambda: segment_sum(v, i, s),
                                  "segment_sum_kernel")
        print(f"timing {label:32s} wrapper {ms!r} ms  kernel (device) "
              f"{dev_ms!r} ms  plain {plain!r} ms  library {library!r} ms  "
              f"bound {bound!r} ms ({bound_by})")
        if label == main[0]:
            entry = {
                "name": "segment_sum", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
                "replaces": "src/repro/kernels/segment_reduce.py:26",
                "launches": launches, "max_abs_err": max(r[4] for r in rows),
                "ms": ms, "kernel_device_ms": dev_ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
                "shape": {"N": n, "S": s, "D": d, "dtype": str(v.dtype)},
            }
    print(json.dumps({"kernels": [entry]}), flush=True)


def phase_batched_solver(device, batch=BATCH, n_restarts=N_RESTARTS,
                         steps=STEPS):
    from repro_torch.core import (BARRIERS_GGL, makespan, optimize_plan_batch,
                                  planetlab_platform, uniform_plan)
    from repro_torch.core.plan import validate_plan

    print("== phase 4: batched solver", flush=True)
    platforms = [planetlab_platform(8, seed=s) for s in range(batch)]
    t = time.perf_counter()
    results = optimize_plan_batch(platforms, "e2e_multi", barriers=BARRIERS_GGL,
                                  n_restarts=n_restarts, steps=steps,
                                  device=device)
    wall = time.perf_counter() - t
    for p, r in zip(platforms, results):
        validate_plan(r.plan.x, r.plan.y)
        uni = makespan(p, uniform_plan(p), BARRIERS_GGL)
        check(r.makespan <= uni + 1e-6,
              f"{p.name}: planned {r.makespan} worse than uniform {uni}")
    print(f"optimize_plan_batch B={batch} {n_restarts}x{steps}: {wall:.3f} s, "
          f"{batch / wall!r} plans/s")


def solver_device_share(device, n_restarts=N_RESTARTS, steps=50):
    """Where a warm single-job solve spends its time: device activity
    (kernels, copies, fills) from ``torch.profiler`` over the host wall
    time of one ``optimize_plan`` call, and device launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BARRIERS_GGL, optimize_plan, planetlab_platform

    p = planetlab_platform(8, alpha=1.0, seed=0)

    def solve():
        optimize_plan(p, "e2e_multi", barriers=BARRIERS_GGL,
                      n_restarts=n_restarts, steps=steps, device=device)
        torch.cuda.synchronize()

    solve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        solve()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:  # union of the device intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    if not spans:
        print(f"solver profile {n_restarts}x{steps}: wall {wall!r} s, device "
              "time not measured (the profiler recorded no device activity)")
        return
    print(f"solver profile {n_restarts}x{steps}: wall {wall!r} s  device busy "
          f"{busy_us / 1e6!r} s  busy share {busy_us / 1e6 / wall!r}  device "
          f"launches {len(spans)} ({len(spans) / steps!r} per step)")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(SRC))
    import repro_torch

    device = torch.device("cuda", 0)
    repro_torch.set_default_device(device)
    t0 = time.perf_counter()
    phase_environment()
    reducer_inputs, launches = phase_main_path(device)
    phase_kernels(device, reducer_inputs, launches)
    phase_batched_solver(device)
    solver_device_share(device)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
