#!/usr/bin/env python3
"""Time variants of the float32 (split-TF32) flash_attention kernel on one
CUDA card.

    python3 scripts/tune_flash.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Each variant is a copy of ``csrc/flash_attention.cu`` with some of the
float32 kernel's ``constexpr`` tile constants replaced (the first variant
is the source as it stands), built with the flags of
``repro_torch.kernels._build`` into ``build/tune_flash/``, all builds
started together.  Every variant is called through its C entry
``flash_attention_f32_tc`` at the two served float32 prefill shapes
(RecurrentGemma's (1, 16, 3000, 256), one kv head, window 2048;
Granite-MoE's (1, 24, 3000, 64), 8 kv heads, causal), held to the plain
version (``attention_ref``) on the card, and timed with CUDA events: the
median over 20 runs of 10 calls queued on the card behind a sleep kernel,
in turns with the other variants.  Also times ``mma.sync`` alone (TF32
and bf16, independent chains and one dependent chain): the rate the
kernel's products can reach on this card, and counts the commonest SASS
opcodes of the committed float32 kernel.  Prints each variant's
registers and spills, and one line per variant and shape, and writes them
as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

#: (variant name, {constant: value}): the source as it stands first
VARIANTS = [
    ("committed", {}),
    ("small: P V into O", {"kTcOChunkSmall": 0}),
    ("wide: fresh P V every 64 columns", {"kTcOChunkWide": 64}),
    ("wide: 8 warps, 16-row kv tiles", {"kTcWarpsWide": 8, "kTcBKWide": 16}),
    ("small: 32-row kv tiles, 3 blocks, P V into O",
     {"kTcBKSmall": 32, "kTcBlocksSmall": 3, "kTcOChunkSmall": 0}),
    ("3 stages, wide 16-row kv tiles", {"kTcStages": 3, "kTcBKWide": 16}),
]

#: the tensor cores' rate for mma.sync, which the float32 kernel issues:
#: each warp keeps 8 independent accumulators (or one chain, for the
#: latency of a dependent mma) through ``iters`` steps
MMA_PEAK_SRC = r"""
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <int KIND, int CHAINS>
__global__ void mma_peak_kernel(float* out, int iters) {
  float d[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int x = 0; x < 4; ++x) d[c][x] = 0.f;
  uint32_t a[4], b0, b1;
  for (int x = 0; x < 4; ++x)
    a[x] = __float_as_uint(1e-3f * (threadIdx.x + x));
  b0 = __float_as_uint(1e-3f);
  b1 = __float_as_uint(2e-3f);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
            "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
            "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float sum = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int x = 0; x < 4; ++x) sum += d[c][x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_peak(int kind, int chains, int blocks, int threads,
                        int iters, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0 && chains == 8)
    mma_peak_kernel<0, 8><<<blocks, threads, 0, st>>>(out, iters);
  else if (kind == 0)
    mma_peak_kernel<0, 1><<<blocks, threads, 0, st>>>(out, iters);
  else if (chains == 8)
    mma_peak_kernel<1, 8><<<blocks, threads, 0, st>>>(out, iters);
  else
    mma_peak_kernel<1, 1><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
#: (label, B, Hq, Hkv, T, Dh, window)
SHAPES = [("RecurrentGemma", 1, 16, 1, 3000, 256, 2048),
          ("Granite-MoE", 1, 24, 8, 3000, 64, None)]
ENTRY = "flash_attention_f32_tc"


def build_all(out_dir: Path):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from tune_scans import variant_source

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = []
    for i, (_, values) in enumerate(VARIANTS):
        cu = out_dir / f"flash_attention_{i}.cu"
        cu.write_text(variant_source(src, values))
        jobs.append((cu, cu.with_suffix(".so")))

    def build(job):
        cu, so = job
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
        return proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(build, jobs))
    return [(ctypes.CDLL(str(so)), log) for (_, so), log in zip(jobs, logs)]


def opcode_counts(so: Path, kernel: str, top: int = 14):
    """{head width: [(opcode, count)]}: the commonest SASS opcodes (without
    their modifiers) of each instantiation of ``kernel`` in a built
    library, from ``cuobjdump -sass``."""
    import re
    from collections import Counter

    import chip_smoke as C
    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = C._dh(m.group(1)) if kernel in m.group(1) else None
            if fn:
                counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if fn and m:
            counts[fn][m.group(1)] += 1
    return {dh: c.most_common(top) for dh, c in counts.items()}


def mma_peak(out_dir: Path):
    """The rate of mma.sync on this card: TF32 m16n8k8 and, beside it,
    bf16 m16n8k16, 8 independent chains a warp at 4 and 8 warps a block,
    two blocks an SM; and the time of one dependent TF32 mma, one warp
    alone.  Returns the rows it printed."""
    import torch

    from repro_torch.kernels import _build

    cu = out_dir / "mma_peak.cu"
    cu.write_text(MMA_PEAK_SRC)
    so = cu.with_suffix(".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).mma_peak
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for kind, name, flops in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                              (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for chains, blocks, threads, iters in ((8, 2 * sms, 128, 20000),
                                               (8, 2 * sms, 256, 20000),
                                               (1, 1, 32, 20000)):
            def call():
                rc = fn(kind, chains, blocks, threads, iters, out.data_ptr(),
                        stream)
                assert rc == 0, rc
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            n_mma = blocks * threads // 32 * chains * iters
            row = {"mma": name, "chains": chains, "blocks": blocks,
                   "threads": threads, "ms": ms,
                   "tflops": n_mma * flops / ms / 1e9,
                   "ns_per_dependent_mma": ms * 1e6 / iters
                   if chains == 1 else None}
            rows.append(row)
            print(f"mma.sync {name}: {chains} chains a warp, {blocks} blocks of "
                  f"{threads} threads: {ms!r} ms, {row['tflops']!r} TFLOP/s"
                  + (f", {row['ns_per_dependent_mma']!r} ns a dependent mma"
                     if chains == 1 else ""), flush=True)
    return rows


def main() -> None:
    import torch

    import chip_smoke as C
    from repro_torch.kernels.ref import attention_ref
    from tune_scans import time_turns

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/tune_flash/results.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tune_flash: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = build_all(ROOT / "build" / "tune_flash")
    peak = mma_peak(ROOT / "build" / "tune_flash")
    opcodes = {}
    for i, (label, _) in enumerate(VARIANTS[:1]):
        so = ROOT / "build" / "tune_flash" / f"flash_attention_{i}.so"
        opcodes[label] = opcode_counts(so, C.FLASH_F32)
        for dh in ("64", "256"):
            print(f"{label}: SASS opcodes of {C.FLASH_F32}<Dh {dh}>: "
                  f"{opcodes[label].get(dh)}")
    rows = []
    for (label, _), (_, log) in zip(VARIANTS, libs):
        for fn, (regs, st, ld) in sorted(C.ptxas_usage(log).items()):
            if C.FLASH_F32 in fn:
                print(f"{label}: {C.FLASH_F32}<Dh {C._dh(fn)}> {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B")
    gen = torch.Generator(device="cpu").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    atol, rtol = C.KERNEL_TOL["torch.float32"]
    for label, b, hq, hkv, t, dh, window in SHAPES:
        q, k, v = (torch.randn((b, h, t, dh), generator=gen).to(dev)
                   for h in (hq, hkv, hkv))
        want = attention_ref(q, k, v, causal=True, window=window)
        bound = C.flash_floors(q, k, True, window, 0)["split_tf32_ms"]
        fns, outs, rcs = [], [], []
        for lib, _ in libs:
            fn = getattr(lib, ENTRY)
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i32, i64,
                           i64, ctypes.c_float, p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(q)

            def call(fn=fn, out=out):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, hq, hkv, t, t, dh, 1,
                          -1 if window is None else window, 0, dh ** -0.5,
                          stream)
            rcs.append(call())
            torch.cuda.synchronize()
            fns.append(call)
            outs.append(out)
        ok = [i for i, rc in enumerate(rcs) if rc == 0]
        times = dict(zip(ok, time_turns([fns[i] for i in ok])))
        for i, (name, values) in enumerate(VARIANTS):
            row = {"variant": name, "constants": values, "shape": label,
                   "q": [b, hq, t, dh], "hkv": hkv, "window": window,
                   "rc": rcs[i], "split_tf32_floor_ms": bound}
            if i in times:
                err = (outs[i] - want).abs()
                row.update(ms=times[i], max_abs_err=float(err.max()),
                           within_bar=bool(torch.all(
                               err <= atol + rtol * want.abs())))
            rows.append(row)
            print(f"{label} {name}: " + (
                f"{row['ms']!r} ms ({bound / row['ms']:.1%} of the split-TF32 "
                f"floor {bound!r} ms), max |err| {row['max_abs_err']!r}, "
                f"within atol {atol} rtol {rtol}: {row['within_bar']}"
                if i in times else f"launch failed with CUDA error {rcs[i]}"),
                flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "mma_peak": peak,
                                          "opcodes": opcodes, "rows": rows},
                                         indent=1))


if __name__ == "__main__":
    main()
