#!/usr/bin/env python3
"""Time variants of the port's two scan kernels on one CUDA card.

    python3 scripts/tune_scans.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Each variant is a copy of ``csrc/mamba_scan.cu`` or ``csrc/rglru_scan.cu``
with some of its ``constexpr`` constants replaced (the first variant of
each kernel is the source as it stands), built with the flags of
``repro_torch.kernels._build`` into ``build/tune_scans/``, all builds
started together.  Every variant is called through its C entry at the
served prefill and decode shapes (Falcon-Mamba's (1, 3000, 8192, 16) bf16
and (4, 1, 8192, 16) float32; RecurrentGemma's (1, 3000, 4096) bf16 and
(4, 1, 4096) float32), compared with the committed wrapper's output (the
largest difference is printed), and timed with CUDA events: the median over 20 runs of 10 calls queued on
the card behind a sleep kernel, in turns with the committed source's
build.  Prints one line per
variant and shape and writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: {kernel: [(variant name, {constant: value})]}: the source as it stands
#: first
VARIANTS = {
    "mamba_scan": [
        ("committed", {}),
        ("sub 16 states", {"kSubStates": 16}),
        ("sub 64 states", {"kSubStates": 64}),
        ("tile 32", {"kTile": 32}),
        ("2 stages", {"kStages": 2}),
        ("8 warps of 2 states", {"kGroups": 8}),
        ("2 warps of 8 states", {"kGroups": 2}),
    ],
    "rglru_scan": [
        ("committed", {}),
        ("unroll 4", {"kUnroll": 4}),
        ("unroll 16", {"kUnroll": 16}),
        ("512 channels a block", {"kThreads": 512, "kMinBlocks": 2}),
    ],
}


def variant_source(src: str, values) -> str:
    for name, value in values.items():
        src, n = re.subn(rf"(constexpr (?:int|float) {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"no single constant {name} in the source")
    return src


def build_all(out_dir: Path):
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for kernel, variants in VARIANTS.items():
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        for i, (_, values) in enumerate(variants):
            cu = out_dir / f"{kernel}_{i}.cu"
            cu.write_text(variant_source(src, values))
            jobs.append((kernel, i, cu, cu.with_suffix(".so")))

    def build(job):
        _, _, cu, so = job
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
        return proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(build, jobs))
    return {(k, i): (ctypes.CDLL(str(so)), log)
            for (k, i, _, so), log in zip(jobs, logs)}


def entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def time_turns(fns, runs=20, per_run=10):
    """Median ms per call of each of ``fns`` on the card, taken in turns:
    each run's calls are queued behind a sleep kernel, so that the card
    runs them back to back whatever the host's cost per call."""
    import torch

    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    samples = [[] for _ in fns]
    for r in range(runs):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            for _ in range(per_run):
                fns[k]()
            end.record()
            end.synchronize()
            samples[k].append(start.elapsed_time(end) / per_run)
    return [statistics.median(s) for s in samples]


def main() -> None:
    import importlib

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/tune_scans/results.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tune_scans: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    libs = build_all(ROOT / "build" / "tune_scans")
    ms_mod = importlib.import_module("repro_torch.kernels.mamba_scan")
    rg_mod = importlib.import_module("repro_torch.kernels.rglru_scan")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    stream = torch._C._cuda_getCurrentRawStream(0)
    rows = []
    # Falcon-Mamba's prefill and decode step: A and D bfloat16 parameters
    for b, t, dtype in ((1, 3000, torch.bfloat16), (4, 1, torch.float32)):
        di, ds = 8192, 16
        x = normal(b, t, di, dtype=dtype)
        delta = F.softplus(normal(b, t, di)).to(dtype)
        A = -torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds).to(
            dev, torch.bfloat16).contiguous()
        D = normal(di, dtype=torch.bfloat16)
        proj = normal(b, t, 256 + 2 * ds, dtype=dtype)
        _, Bc, Cc = torch.split(proj, [256, ds, ds], dim=-1)
        h0 = normal(b, di, ds)
        want_y, want_h = ms_mod.mamba_scan(x, delta, A, Bc, Cc, D, h0)
        name = ms_mod._ENTRY[dtype]
        fns, outs = [], []
        for i, _ in enumerate(VARIANTS["mamba_scan"]):
            fn = entry(libs[("mamba_scan", i)][0], name, ms_mod._ARGTYPES)
            y = torch.empty_like(x)
            h = torch.empty((b, di, ds), dtype=torch.float32, device=dev)

            def call(fn=fn, y=y, h=h):
                rc = fn(x.data_ptr(), delta.data_ptr(), A.data_ptr(),
                        Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(),
                        h0.data_ptr(), y.data_ptr(), h.data_ptr(), b, t, di,
                        ds, Bc.stride(0), Bc.stride(1), Cc.stride(0),
                        Cc.stride(1), 1, 1, stream)
                assert rc == 0, rc
            call()
            fns.append(call)
            outs.append((y, h))
        torch.cuda.synchronize()
        times = time_turns(fns)
        for (label, _), (y, h), ms in zip(VARIANTS["mamba_scan"], outs, times):
            err = max((y.float() - want_y.float()).abs().max().item(),
                      (h - want_h).abs().max().item())
            rows.append({"kernel": "mamba_scan", "variant": label,
                         "shape": [b, t, di, ds], "dtype": str(dtype),
                         "ms": ms, "max_abs_diff_from_committed": err})
    # RecurrentGemma's prefill and decode step
    for b, t, dtype in ((1, 3000, torch.bfloat16), (4, 1, torch.float32)):
        d = 4096
        x = normal(b, t, d, dtype=dtype)
        a = torch.sigmoid(normal(b, t, d)).to(dtype)
        h0 = normal(b, d)
        want_y, want_h = rg_mod.rglru_scan(x, a, h0)
        name = rg_mod._ENTRY[dtype]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fns, outs = [], []
        for i, _ in enumerate(VARIANTS["rglru_scan"]):
            lib = libs[("rglru_scan", i)][0]
            fn = entry(lib, name, rg_mod._ARGTYPES)
            # each variant's chunks, from its own geometry
            geometry = (ctypes.c_int64 * 3)()
            lib.rglru_scan_geometry.argtypes = [ctypes.c_void_p]
            lib.rglru_scan_geometry(geometry)
            chunk, k = rg_mod.chunking(b, t, d, geometry[0], geometry[1],
                                       geometry[2] * sms)
            scratch = torch.empty(max(2 * b * (k - 1) * d, 1), device=dev)
            y = torch.empty_like(x)
            h = torch.empty((b, d), dtype=torch.float32, device=dev)

            def call(fn=fn, y=y, h=h, chunk=chunk, scratch=scratch):
                rc = fn(x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                        h.data_ptr(), scratch.data_ptr(), b, t, d, chunk,
                        stream)
                assert rc == 0, rc
            call()
            fns.append(call)
            outs.append((y, h))
        torch.cuda.synchronize()
        times = time_turns(fns)
        for (label, _), (y, h), ms in zip(VARIANTS["rglru_scan"], outs, times):
            err = max((y.float() - want_y.float()).abs().max().item(),
                      (h - want_h).abs().max().item())
            rows.append({"kernel": "rglru_scan", "variant": label,
                         "shape": [b, t, d], "dtype": str(dtype), "ms": ms,
                         "max_abs_diff_from_committed": err})
    for row in rows:
        print(f"{row['kernel']:10s} {row['variant']:22s} {row['shape']} "
              f"{row['dtype']}: {row['ms']!r} ms  max |diff| from the "
              f"committed build {row['max_abs_diff_from_committed']!r}")
    for (kernel, i), (_, log) in sorted(libs.items()):
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)), key=int)
        print(f"ptxas {kernel} {VARIANTS[kernel][i][0]}: registers {regs}, "
              f"spill stores {spills}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
