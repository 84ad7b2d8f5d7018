#!/usr/bin/env python3
"""Every dry-run cell of the port at both production meshes, several at a
time, and the table of what each rank needs.

    python3 scripts/dryrun_sweep.py --out reports/sweep --jobs 8
    python3 scripts/dryrun_sweep.py --out reports/sweep --table-only

Each (arch, shape, mesh) runs ``python -m repro_torch.launch.dryrun
--arch A --shape S --multi-pod single|multi --device cpu`` in a process
of its own (the counts are shape arithmetic: they do not depend on the
card), ``--jobs`` at once, the slowest first (a recurrent arch's
``train_4k`` traces each of its 4096 scan steps under autograd).  The
table lists, per cell and mesh, the per-device bytes, whether they fit
in one card, the flops a device and the collective bytes a device, from
the reports under ``--out``; a cell without a report is listed as
missing.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import cells, get_config  # noqa: E402

MESHES = ("single", "multi")


def _slow_first(cell):
    arch, shape = cell
    cfg = get_config(arch)
    recurrent = any(b.mixer != "attn" for b in cfg.pattern)
    return (not (recurrent and shape == "train_4k"), arch, shape)


def run(out: str, jobs: int, timeout: float) -> None:
    todo = [(a, s, m) for a, s in sorted(cells(), key=_slow_first)
            for m in MESHES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    running, t0 = [], time.perf_counter()
    while todo or running:
        while todo and len(running) < jobs:
            arch, shape, mesh = todo.pop(0)
            log = open(os.path.join(out, f"{arch}__{shape}__{mesh}.log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--multi-pod", mesh,
                   "--device", "cpu", "--out", out]
            running.append((subprocess.Popen(cmd, env=env, stdout=log,
                                             stderr=subprocess.STDOUT),
                            log, time.perf_counter(), (arch, shape, mesh)))
        for item in list(running):
            proc, log, start, cell = item
            if proc.poll() is None and time.perf_counter() - start > timeout:
                proc.kill()
                proc.wait()
            if proc.poll() is not None:
                log.close()
                running.remove(item)
                print(f"[{time.perf_counter() - t0:7.1f} s] {cell} rc "
                      f"{proc.returncode} in "
                      f"{time.perf_counter() - start:.1f} s", flush=True)
        time.sleep(0.5)


def table(out: str) -> None:
    print("| cell | mesh | per-device GB | fits 80 GB | flops / device | "
          "collective GB / device |")
    print("|---|---|---|---|---|---|")
    over = []
    for arch, shape in cells():
        for mesh in MESHES:
            path = os.path.join(out, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(path):
                print(f"| {arch} `{shape}` | {mesh} | missing | | | |")
                continue
            rep = json.load(open(path))
            gb = rep["per_device_bytes"] / 1e9
            if not rep["fits_card"]:
                over.append((arch, shape, rep["mesh"], gb))
            print(f"| {arch} `{shape}` | {rep['mesh']} | {gb:.2f} | "
                  f"{'yes' if rep['fits_card'] else 'no'} | "
                  f"{rep['flops_per_device']:.4g} | "
                  f"{rep['collectives_per_device_bytes']['total'] / 1e9:.3f} |")
    print(f"\n{len(over)} of {2 * len(cells())} over 80 GB:")
    for cell in over:
        print("  ", *cell)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="reports/sweep")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds a cell may take before it is killed")
    ap.add_argument("--table-only", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if not args.table_only:
        run(args.out, args.jobs, args.timeout)
    table(args.out)


if __name__ == "__main__":
    main()
