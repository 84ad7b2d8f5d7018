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
``10a`` ``moe_dispatch`` and ``flash_attention`` at Granite-MoE's shapes, ``10b``
Granite-MoE's float32 depth-4 cut (kernels against plain versions, and the
float32 prefill's wall on the float32 attention kernel and on the one before),
``14`` the planner in multi-device training, ``15`` the dry run at the
production meshes, held to the card, ``16`` the tensor-parallel layout on
two processes sharing the card, ``17`` the port's examples, ``18`` the six model families no other phase
runs (``18a`` OLMo-1B, ``18b`` StableLM-1.6B, ``18c`` Mistral-NeMo-12B,
``18d`` Llama4-Scout at depth 8, ``18e`` Phi-3-vision, ``18f``
MusicGen-large, each alone), ``18w`` bf16 ``flash_attention`` at head
widths off the 64-column grid (which the whole script runs before 18a),
``19`` the reference's long shapes (``19a`` RecurrentGemma-9B, ``19b``
Falcon-Mamba-7B, ``19c`` Granite-MoE-3B-A800M, each alone; each makes
its own weights, where the whole script reuses those of phases 5, 7 and
9), ``20`` the reference's default serving dtype, float32, at full width
and depth through ``repro_torch.launch.serve`` and a full-depth hold of
the kernels against their plain versions (``20a`` RecurrentGemma-9B,
``20b`` Falcon-Mamba-7B, ``20c`` Granite-MoE-3B-A800M, ``20d``
Qwen3-1.7B, each alone), ``21`` the reference's training launcher on the
three block families no other phase trains, and their float32 cuts against
the CPU (``21a`` Granite-MoE-3B-A800M, ``21b`` Falcon-Mamba-7B at depth
24, ``21c`` RecurrentGemma-9B at depth 8, each alone with its own cut),
``22`` the paper's own evaluation (every planner mode over the 13
PlanetLab platforms, the barrier relaxations, the model against the DES,
the three applications executed, the dynamic mechanisms; ``22a``..``22e``
each alone; ``22`` and ``22d`` run phase 2 first, whose word count run is
22d's word count row, and 22b, 22c and 22e alone solve the plans they
otherwise take from 22a or 22d), ``23`` the control plane at the
reference's scale (``23a`` failover, shared co-replanning and Fig 12's
replication, ``23b`` the planner service, with the process's first solve
split into its parts in a fresh process, ``23c`` the 1000-node / 100-job
``online_1000``; each alone, and ``23`` all three in turn, every kernel's
launches counted from 0), after phase 1 (the card's name and power limit,
and the kernels built).  Phases 6a, 8a and 10a run on stand-in
launch counts (they print their kernels-line entries).  Needs a CUDA card.

To rehearse phase 22 on the CPU, see ``tests/test_torch_paper_figures.py``;
phase 23, ``tests/test_torch_control_plane.py``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("phases", nargs="+", choices=[
    "5", "6a", "7", "8a", "10a", "10b", "14", "15", "16", "17", "18",
    "18w", "18a", "18b", "18c", "18d", "18e", "18f", "19", "19a", "19b",
    "19c", "20", "20a", "20b", "20c", "20d", "21", "21a", "21b", "21c",
    "22", "22a", "22b", "22c", "22d", "22e", "23", "23a", "23b", "23c"])
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
    elif phase == "10a":
        print(json.dumps(C.phase_moe_kernel(device, stand_in), default=str))
    elif phase == "10b":
        C.phase_moe_model(device)
    elif phase == "14":
        print(json.dumps(C.phase_multidevice(device)[0], default=str))
    elif phase == "16":
        print(json.dumps(C.phase_tensor_parallel(device)))
    elif phase == "17":
        print(json.dumps(C.phase_examples(device)))
    elif phase == "18":
        print(json.dumps(C.phase_card_archs(device), default=str))
    elif phase == "18w":
        print(json.dumps(C.phase_flash_widths(device)))
    elif phase.startswith("18"):
        spec = next(s for s in C.CARD_ARCHS if s.phase == phase)
        print(json.dumps(C.phase_card_arch(device, spec), default=str))
    elif phase.startswith("19"):
        for spec in C.LONG_ARCHS:
            if phase in ("19", spec[0]):
                print(json.dumps(C.phase_long_context(device, *spec),
                                 default=str))
                C.free_device_memory(device)
    elif phase.startswith("20"):
        for spec in C.FLOAT32_ARCHS:
            if phase in ("20", spec[0]):
                r = C.phase_float32_serving(device, *spec)
                print(json.dumps({k: r[k] for k in ("arch", "launches",
                                                    "numbers", "s")}))
                print(f"phase {spec[0]}: {r['s']:.1f} s on "
                      f"{C.card_name_and_limit()}", flush=True)
    elif phase.startswith("21"):
        archs = [s for s in C.TRAIN_ARCHS if phase in ("21", s.phase)]
        print(json.dumps(C.phase_train_archs(device, archs=archs)))
    elif phase in ("22", "22d"):
        wc_row = C.phase_main_path(device)[2]
        C.free_device_memory(device)
        if phase == "22":
            out = C.phase_paper_figures(device, wc_row)
            print(json.dumps({k: out[k] for k in ("launches", "walls",
                                                  "fig4", "fig9", "fig10",
                                                  "s")}))
        else:
            C.paper_apps(device, wc_row)
    elif phase == "23":
        out = C.phase_control_plane(device, first_solve=True)
        print(json.dumps({k: out[k] for k in ("launches", "secs", "s")}))
    elif phase == "23a":
        print(json.dumps(C.phase_control_failover_shared(device)["cells"]))
    elif phase == "23b":
        out = C.phase_planner_service(device, first_solve=True)
        print(json.dumps({k: out[k] for k in ("cold_s", "p50_ms", "p99_ms",
                                              "plans_per_s", "full_s",
                                              "incremental_s", "stats")}))
    elif phase == "23c":
        out = C.phase_scale_online(device)
        print(json.dumps({k: v for k, v in out.items()
                          if k not in ("profile", "held_errs")}))
    elif phase.startswith("22"):
        {"22a": C.paper_modes, "22b": C.paper_barriers, "22c": C.paper_des,
         "22e": C.paper_dynamics}[phase](device)
    else:
        print(json.dumps(C.phase_dryrun(device)[1], default=str))
    C.free_device_memory(device)
    print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
print(f"run_phases {args.phases} from {tree}: {time.perf_counter() - t0:.1f} s")
