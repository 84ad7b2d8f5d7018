#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on the card, from a tree.

    python3 scripts/run_phases.py 5 7                  # this checkout
    python3 scripts/run_phases.py --tree build/parent 5 7

``--tree`` is the root of a checkout (its ``chip_smoke.py`` and ``src/``
are imported; its kernels build into its own ``build/``), so that two
versions can be run in turns in one chip call (parent, change, change,
parent), each in a process of its own.  Phases: ``5`` serving
RecurrentGemma-9B, ``6a`` its kernels against their plain versions, ``7``
serving Falcon-Mamba-7B, ``8a`` ``mamba_scan`` against its plain version,
``14`` the planner in multi-device training, ``15`` the dry run at the
production meshes, held to the card, ``16`` the tensor-parallel layout on
two processes sharing the card, after phase 1 (the card's name and
power limit, and the kernels built).  Phases 6a and 8a run on
stand-in launch counts (they print their kernels-line entries).  Needs a
CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("phases", nargs="+", choices=["5", "6a", "7", "8a", "14", "15",
                                              "16"])
args = ap.parse_args()
tree = Path(args.tree).resolve()
sys.path[:0] = [str(tree), str(tree / "src")]

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("run_phases: torch.cuda.is_available() is false")

import chip_smoke as C  # noqa: E402
import repro_torch  # noqa: E402

device = torch.device("cuda", 0)
repro_torch.set_default_device(device)
print(f"tree {tree}", flush=True)
t0 = time.perf_counter()
C.phase_environment()  # the card, and every kernel built, one nvcc each
stand_in = dict.fromkeys(C.LM_KERNELS, 0)
for phase in args.phases:
    t = time.perf_counter()
    if phase == "5":
        C.phase_serving(device)
    elif phase == "6a":
        print(json.dumps(C.phase_lm_kernels(device, stand_in), default=str))
    elif phase == "7":
        C.phase_serving(device, C.MAMBA_ARCH, fixed=C.MAMBA_PROMPTS, phase="7")
    elif phase == "8a":
        print(json.dumps(C.phase_mamba_kernel(device, stand_in), default=str))
    elif phase == "14":
        print(json.dumps(C.phase_multidevice(device)[0], default=str))
    elif phase == "16":
        print(json.dumps(C.phase_tensor_parallel(device)))
    else:
        print(json.dumps(C.phase_dryrun(device)[1], default=str))
    C.free_device_memory(device)
    print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
print(f"run_phases {args.phases} from {tree}: {time.perf_counter() - t0:.1f} s")
