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
   and the kernels' build times (one ``nvcc`` per source, all started
   together) with ``ptxas`` resource usage; the registers and spills of
   the bf16 tensor-core ``flash_attention`` instantiations, and, where the
   toolkit has ``cuobjdump``, their ``HGMMA`` (``wgmma``) and ``UTMALDG``
   (TMA load) instructions in the built library's SASS: a bf16 kernel
   without ``HGMMA`` fails the run.
2. Main path, the paper's loop through ``GeoJob`` at the paper's scale: the
   8-data-center PlanetLab platform, a 20M-word Zipf corpus (``vocab`` 2^20,
   the largest the 20-bit word packing allows), ``calibrate`` →
   ``plan("e2e_multi")`` at the default 24 restarts × 500 steps →
   ``execute``, then the same job under the uniform and Hadoop-locality
   plans.  Word counts must equal an independent numpy count, every
   non-empty reducer must have launched the kernel, the optimized plan must
   beat both baselines on measured makespan, and ``model_error`` must be
   finite.  The ``segment_sum`` launch count is zeroed just before and read
   just after; one more ``execute`` is profiled for the kernel in place.
3. ``segment_sum`` against its plain version on the card, at the shapes the
   main path gave it (every reducer's input, recorded) and at stress
   shapes: unsorted and out-of-range ids, ids and values at storage
   offsets that are not 16 bytes, one id for a million rows, a reducer
   without in-mapper combining (a hot id), and wide rows in float32 and
   bfloat16; with the kernel's ``ptxas`` registers and spills.  Times are
   CUDA-event medians, the wrapper's taken in turns with its PyTorch call's,
   the device's also queued behind a sleep kernel.
4. Batched solver: 64 PlanetLab platforms planned in one batched solve;
   every plan valid and never worse than uniform.  Then the device busy
   share of a warm single-job solve, from ``torch.profiler``.
5. Serving, the LM path: RecurrentGemma-9B at full width and depth (38
   layers, d_model 4096, vocab 256000), random bfloat16 weights from a
   seeded generator, through ``ServeEngine`` (4 slots, max_len 4096): 8
   requests with prompts of 17, 2047, 2049, 3000 and 4 random lengths, 32
   new tokens each.  Every request must finish with 32 tokens in the
   vocabulary, every logit must be finite, ``flash_attention`` must launch
   12 times per admission and ``rglru_scan`` 26 times per admission and per
   decode step.  The launch counts are zeroed just before and read just
   after.
6. ``flash_attention`` and ``rglru_scan`` against their plain versions at
   the served shapes, in bfloat16 and float32 (``rglru_scan`` also at the
   edges of its chunking: T at and around the chunk lengths, D off the
   128-channel tile, B = 3, a near 1 and near 0, near 1 also at 32 and
   33 chunks; and two calls equal bit for bit), with both ``rglru_scan``
   kernels' ``ptxas`` registers and spills, device times summed over its
   two passes and the launches of each a call as the profiler recorded
   them (both at the prefill, the rescan alone at a decode step), and
   times (for
   ``flash_attention`` also one call alone: CUDA events around a single
   launch after a synchronize, median of 20; the launches queued on the
   card behind a sleep kernel; and the CUDA-core kernel that served bf16
   before, called through its C entry); then a
   full-width cut to depth 5 — one (rg, rg, attn) group plus the two-block
   tail — in float32, run with the kernels and with the plain versions:
   the logits of a 3000-token prefill and of three decode steps must
   agree.
7. Serving Falcon-Mamba-7B, after RecurrentGemma's weights are freed: 64
   Mamba layers, d_model 4096, d_inner 8192, d_state 16, vocab 65024, at
   full width and depth in bfloat16 (14.54 GB) through the same engine: 8
   requests with prompts of 1, 17, 2048, 3000 tokens and 4 random lengths,
   32 new tokens each.  The same checks as phase 5, with ``mamba_scan``
   launched exactly 64 times per admission and per decode step, and peak
   device memory under 80 GB.
8. ``mamba_scan`` against its plain version at the served shapes (prefills
   of 17, 2048 and 3000 tokens in bfloat16 and float32, with and without
   ``h0``; the float32 decode step against bfloat16 A and D) and at the
   edges of its tiling (T around the 64-step tile and past the 3-stage
   ring, d_inner off the 32-channel tile, d_state 1 to 32, B = 3, A and D
   in both dtypes, rows off 16 bytes; two calls equal bit for bit), with
   its ``ptxas`` registers and spills and times;
   then a full-width cut to depth 4 in float32, kernels against plain
   versions, as in phase 6.
9. Serving Granite-MoE-3B-A800M, after Falcon-Mamba's weights are freed: 32
   layers of GQA attention (24 heads, 8 kv heads, head dim 64) and a
   40-expert top-8 MoE FFN, d_model 1536, vocab 49155, at full width and
   depth in bfloat16 (6.60 GB) through the same engine and traffic as
   phase 7.  The same checks, with ``moe_dispatch`` launched exactly 32
   times per admission and per decode step and ``flash_attention`` 32
   times per admission and never in decode.
10. ``moe_dispatch`` against its plain version at the served shapes (the
    3000-token prefill's 24,000 routed rows into (40, 750, 1536) and the
    4-slot decode step's 32 into (40, 8, 1536)), in bfloat16 and float32:
    bit for bit where every (expert, slot) pair is unique; where the served
    capacity rule repeats pairs, to a stated tolerance against the plain
    version on the card (atomics) and bit for bit against it on a CPU copy
    and against a second call (row-order sums); with the kernels' ``ptxas``
    registers and spills; and
    ``flash_attention`` at Granite's prefill shape; with times, as in
    phase 6.  Then a
    full-width cut to depth 4 in float32: with the same attention, the
    model with the ``moe_dispatch`` kernel equals the one with its plain
    version bit for bit; with all kernels against all plain versions, the
    routing choices that differ are counted (at most 1%) and the logits
    are held to the model tolerance where routing agreed in every layer.

11. Training, after Granite's weights are freed: Qwen3-1.7B at full width
    and depth (28 layers, d_model 2048, vocab 151,936, 1.72 B parameters)
    through ``repro_torch.launch.train``: 8 AdamW steps of 4 x 2048 tokens
    from the Zipf(1.3) synthetic stream, bf16 compute over float32 masters,
    remat, the geo-planned ingest solved on the card (11a).  Every loss and
    grad norm must be finite, the mean of the last two losses below the
    first, peak device memory under 80 GB; it prints the step walls,
    tokens/s, ``train_mfu`` and a profiled warm step, with the float32
    chunked attention's share timed alone at the step's shapes.  Then a
    full-width cut to depth 2 in float32, loss and every gradient on the
    card against the CPU (11b); the reduced config checkpointed every 2
    steps and resumed with ``--resume auto`` (11c: the restored state
    equals the saved one bit for bit, the resumed run starts at the batch
    of step 4); and each kernel wrapper refusing a CUDA input that requires
    grad (11d).  No kernel runs on the training path: the reference trains
    on its plain path too.
12. Multi-job schedules and online control on the paper's 8-data-centre
    platform.  12a: four word-count tenants, each on its own 20M-word
    Zipf(1.4) corpus with 35% of its input at sources g and g+4 and 5% at
    the other six, calibrated, planned through ``GeoSchedule`` by
    ``independent``, ``sequential`` and ``joint`` (and ``joint`` under
    ``min_max_slowdown``) at 24 x 500, simulated and executed: word counts
    exact, every non-empty reducer of every job launching ``segment_sum``
    (counted from 0), every plan valid, joint's modeled aggregate no worse
    than independent's, the fair objective's worst slowdown no worse than
    independent's; the joint solve's first and warm walls and its device
    busy share.  12b: on the same substrate, two shuffle links into the
    frozen joint plan's busiest reducer step down 250x at half its
    simulated makespan, a fifth job arrives at a quarter and a mapper dies
    at 40%; ``run_online`` under all eight built-in policies with the
    measured solve charge: ``static`` equals the frozen
    ``simulate_schedule``, ``reactive`` with hysteresis inf equals
    ``static`` in ``as_dict()`` and calls no solver, no solo swap before
    the failure is modeled worse, no adopted shared stack's modeled
    remaining rises, every plan valid and every makespan finite; then an
    incremental co-replan of a 20-job snapshot (past the 16-job stack
    cap).  12c: the joint, residual and shared-residual solvers for 25
    steps from the same logits and the inputs each path builds, on the
    card and on the CPU (x, y at atol 1e-4, the exact objective at rtol
    1e-4; two sharper inputs no path builds are printed, unchecked), and
    ``reactive_shared`` with its charge pinned on both devices, the
    decisions that differ counted.
13. Multi-stage pipelines on the same platform.  13a: a 3-stage word-count
    chain through ``GeoPipeline`` on phase 2's corpus (stage 0 counts the
    words, stages 1 and 2 count the low 20 bits of the counts before),
    its downstream alphas and out_scales measured by one uniform-plan
    probe run; planned ``stagewise`` and ``end_to_end`` at 24 x 500,
    simulated and executed: every stage's outputs equal numpy's chain,
    every non-empty reducer of every stage launches ``segment_sum``
    (counted from 0), every plan valid, ``end_to_end`` no worse modeled,
    every makespan finite; the ``end_to_end`` plan's first and warm walls
    and the busy share of a 50-step ``_solve_pipeline_batch``; then the
    example's two-node ``pipeline_pair`` at 8 x 250 (``end_to_end`` no
    worse modeled and at least 20% below ``stagewise`` simulated).  13b:
    the chain's first two stages on tenant 0's layout inside a
    ``GeoSchedule`` with tenants 1 and 2, planned ``joint`` /
    ``end_to_end``: ``execute`` refused, ``run_online("static")`` equal to
    the frozen ``simulate()``, ``reactive`` with the measured charge
    through a 250x drift of the two links into the pipeline's stage-1
    busiest reducer valid and finite.  13c: ``_solve_pipeline_batch`` for
    25 steps from the inputs 13a's ``end_to_end`` built, on the card and
    on the CPU, in float64 (x, y at atol 1e-4, the exact span at rtol
    1e-4); the float32 runs, whose rounding alone moves x by more than
    that at these inputs, are printed.

14. The paper's planner in multi-device training.  14a:
    ``plan_cross_pod_reduction`` (the example's llama4-scout gradients,
    pods at 6400/6400/1600/6400 Mb/s, and homogeneous pods) and
    ``plan_moe_dispatch`` (the example's 8 groups) at 8 x 300 on the card,
    first and warm: never worse than uniform, the slow pod's share under
    0.15, and each est within 1e-3 of the band the CPU's plans at 296-304
    steps span (one point where the anneal settles).  On a one-rank NCCL
    world (a ``FileStore`` in a temporary directory): 14b Granite at full
    width and depth 4 in bfloat16, prefills of 3000 and 17 tokens through
    the expert-parallel ``moe_fwd(mesh=)`` against ``mesh=None``, both with
    the kernels (the same greedy tokens, logits at the model tolerance,
    ``moe_dispatch`` launched in every layer of both), then with a
    ``plan_moe_dispatch`` plan of 4 groups of 10 experts loaded (router
    bias and capacity per expert): the dropped (token, k) share and the
    prefill wall with and without; 14c ``hierarchical_allreduce`` over
    Qwen3-1.7B's parameter shapes in float32 (1.72 B elements) on a
    (pod 1, data 1) mesh: the input back bit for bit, wall and peak; 14d
    ``launch.train --mesh 1x1`` on Qwen3-1.7B at full width and depth 4, 3
    AdamW steps of 4 x 2048 tokens, against the run without a mesh: the
    same losses to 1e-5, warm step walls of both.  The LM kernels' counts
    are zeroed before phase 14 and must equal the launches its prefills
    made.
15. The dry run (``repro_torch.launch.dryrun``).  15a: ``run_cell`` of
    Qwen3-1.7B ``train_4k``, Granite-MoE ``prefill_32k`` and Falcon-Mamba
    ``decode_32k`` on the 16 x 16 mesh and Llama4-Scout ``train_4k`` on
    2 x 16 x 16, each on a fake world of 256 or 512 ranks with stand-ins
    on the meta device: every trace finishes, every count is finite,
    collective bytes above 0 in every cell whose layout communicates (a
    train step, an MoE) and 0 in a dense model's decode, and the card's
    allocated bytes the same before and after; each cell's per-device
    bytes, flops, collective bytes by kind, whether it fits in 80 GB and
    its wall are printed.  On a one-rank NCCL world: 15b phase 14d's
    Qwen3 train step (depth 4, 4 x 2048 tokens, bf16, remat) and phase
    14b's Granite prefill (depth 4, 3000 tokens, bf16), each as a dry run
    and for real on the card without kernels: the dry run's flops equal
    ``FlopCounterMode``'s over the real call, its peak within 10% of
    ``max_memory_allocated`` from a reset; 15c ``launch.train --mesh 1x1
    --compression int8`` against no mesh, 3 steps of 14d's configuration:
    the same losses to 1e-5.

After the phases, one ``{"kernels": [...]}`` line lists every kernel; the
scans' entries time the float32 prefill inputs the bf16 models now give
them (the bf16 prefill beside), and ``moe_dispatch``'s and
``flash_attention``'s launches add those of 14b's expert-parallel
prefills.

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

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor
#: core) operations/s and dense bfloat16 tensor-core operations/s, at the
#: full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: the reference's kernel tolerances (tests/test_kernels.py:19-20): the
#: kernels sum in another order than their plain versions
KERNEL_TOL = {"torch.float32": (2e-5, 1e-2), "torch.bfloat16": (2e-2, 1e-2)}
#: float32 model logits, kernels against plain versions: the same float32
#: sums in another order, carried through 5 (RecurrentGemma) or 4
#: (Falcon-Mamba) full-width layers and the 4096-wide unembedding
MODEL_TOL = (1e-3, 1e-3)

#: main-path scale: the paper's 8-DC testbed and a 20M-word corpus
N_DOCS, WORDS_PER_DOC, VOCAB = 20_000, 1_000, 1 << 20
N_RESTARTS, STEPS = 24, 500
#: anneal steps of a profiled solve
PROFILE_STEPS = 50
BATCH = 64
KERNELS = ("segment_sum", "flash_attention", "rglru_scan", "mamba_scan",
           "moe_dispatch")
#: the kernels of the LM serving paths, and what each is counted on
LM_KERNELS = ("flash_attention", "rglru_scan", "mamba_scan", "moe_dispatch")

#: serving scale: prompts on both sides of the 2048 window, a ragged
#: 64-row tile (17) and the longest served prompt (3000)
SERVE_ARCH = "recurrentgemma-9b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 4096, 32
SERVE_PROMPTS = (17, 2047, 2049, 3000)
SERVE_RANDOM_PROMPTS = 4
#: Falcon-Mamba: a one-token prompt, a ragged one and the longest served
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_PROMPTS = (1, 17, 2048, 3000)
#: Granite-MoE: the same traffic as Falcon-Mamba's
GRANITE_ARCH = "granite-moe-3b-a800m"
GRANITE_PROMPTS = MAMBA_PROMPTS
#: the most (token, layer) routing choices that may differ between the
#: kernels and the plain versions in the float32 cut: flash_attention sums
#: in another order (~1e-6), which flips a top-k choice where two gates
#: nearly tie
ROUTING_FLIPS_MAX = 0.01
#: one card's device memory
CARD_BYTES = 80e9
#: the reference's bar for the Mamba kernel (tests/test_kernels.py:81-87):
#: atol 5 × the kernel tolerance, rtol 3e-2
MAMBA_TOL = {"torch.float32": (5 * 2e-5, 3e-2), "torch.bfloat16": (5 * 2e-2, 3e-2)}
#: training (phase 11): Qwen3-1.7B at full width and depth, 8 AdamW steps
#: of 4 x 2048 tokens; the float32 cut's bars, card against CPU: the loss
#: to rtol 1e-5 and each gradient leaf to 1e-4 of its largest entry (the
#: embedding's backward adds rows with atomics on the card, in an order of
#: its own: float32 sums of a few hundred terms, ~1e-6 of the leaf)
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
#: multi-job schedules (phase 12): four tenants, every built-in schedule
#: policy (joint under both objectives) at the default 24 x 500; online
#: re-planning at run_online's default 8 restarts x 200 steps
SCHED_JOBS = 4
SCHED_POLICIES = (("independent", "makespan"), ("sequential", "makespan"),
                  ("joint", "makespan"), ("joint", "min_max_slowdown"))
ONLINE_RESTARTS, ONLINE_STEPS = 8, 200
#: pipelines (phase 13): a 3-stage word-count chain, each stage after the
#: first counting the counts of the one before (its map keeps the low 20
#: bits of a value, as word count's does); the example's pipeline_pair
#: at its own 8 x 250
PIPE_STAGES = 3
COUNT_MASK = (1 << 20) - 1
PIPE_PAIR_OPT = dict(n_restarts=8, steps=250)
#: seeded one-ulp moves of the pipeline solver's logits in 13c
ULP_SEEDS = 4
#: exponentials per second on the special function units: 16 a clock per
#: SM at compute capability 9.0 (CUDA C++ programming guide, arithmetic
#: instruction throughput), 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9


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


def time_pair_ms(fn_a, fn_b, runs: int = 40, per_run: int = 10,
                 warmup: int = 5):
    """(ms per call of ``fn_a``, of ``fn_b``) as ``time_ms`` measures each,
    in turns (a b, b a, ...) so that both see the same host: where a call
    is bound by the host's cost, back-to-back times drift between and
    within runs by more than the two calls differ."""
    import torch

    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    samples = {0: [], 1: []}
    for r in range(runs):
        for k in ((0, 1) if r % 2 == 0 else (1, 0)):
            fn = fn_a if k == 0 else fn_b
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_run):
                fn()
            end.record()
            end.synchronize()
            samples[k].append(start.elapsed_time(end) / per_run)
    return statistics.median(samples[0]), statistics.median(samples[1])


def time_alone_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` alone: CUDA events around a
    single call on an idle card (``synchronize`` before each), median over
    ``runs``.  The wrapper's host work before its launch is inside."""
    import torch

    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def time_queued_ms(fn, calls: int = 20) -> float:
    """Milliseconds per call of ``fn`` on the card alone: the launches are
    queued behind a ~25 ms sleep kernel, so the card runs them back to back
    whatever the host's cost per call; CUDA events around them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_device_ms(fn, names, calls: int = 20, recorded_per_call=None,
                     sessions: int = 3):
    """Mean device time of one call of ``fn``, from ``torch.profiler`` over
    ``calls`` calls: for each kernel name in ``names`` (a substring of the
    CUDA kernels' names; one string or several, for a call that launches
    several kernels or one of several), its device time over the launches
    the profiler recorded, summed over the names it recorded; ``None``
    where it records no device time.  Where ``recorded_per_call`` is a
    dict, it gets each name's launches the profiler recorded, over
    ``calls``; it stays empty where the profiler cannot trace.

    Each session traces a warm-up step of ``calls`` calls whose events it
    drops before the ``calls`` it keeps: a session started without one
    missed the first launches after it enabled its tracing (on an H100 it
    recorded 3 or 4 of 5 calls' launches, and once none).  A session that
    records no launch of any name is made again, up to ``sessions`` in
    all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    names = (names,) if isinstance(names, str) else tuple(names)
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):  # the warm-up step, then the kept one
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
        except RuntimeError as exc:  # the profiler cannot trace this machine
            print(f"  profiler unavailable: {exc}")
            return None
        events = prof.key_averages()
        if any(name in ev.key for ev in events for name in names):
            break
        print(f"  profiler session {session} of {sessions} recorded no launch "
              f"of {' or '.join(names)} in {calls} calls")
    per_call = None
    for name in names:
        total_us, recorded = 0.0, 0
        for ev in events:
            if name in ev.key:
                total_us += (getattr(ev, "device_time_total", None)
                             or getattr(ev, "cuda_time_total", 0.0))
                recorded += ev.count
        if recorded_per_call is not None:
            recorded_per_call[name] = recorded / calls
        if recorded and recorded != calls:
            print(f"  profiler recorded {recorded} launches of {name} in "
                  f"{calls} calls")
        if total_us > 0:
            per_call = (per_call or 0.0) + total_us / recorded / 1e3
            if len(names) > 1:
                print(f"  {name}: {total_us / recorded / 1e3!r} ms a launch, "
                      f"{recorded} launches recorded")
    if per_call is None:
        print(f"  profiler recorded no launch of {' or '.join(names)} in "
              f"{calls} calls")
    return per_call


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

#: the bf16 tensor-core attention kernel, by the name its instantiations
#: carry in the build log and the SASS
FLASH_WGMMA = "flash_attention_kernel_wgmma"


def ptxas_usage(log: str):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from an ``nvcc -Xptxas -v`` log."""
    import re

    usage, fn, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), *spills)
    return usage


def sass_counts(so: Path, opcodes=("HGMMA", "UTMALDG")):
    """{function: {opcode: count}} in the SASS of a built library, from
    ``cuobjdump -sass``; ``None`` where the toolkit has no ``cuobjdump``."""
    import os
    import re
    from repro_torch.kernels import _build

    tool = Path(os.environ.get("CUDA_HOME") or
                Path(_build.find_nvcc()).parent.parent) / "bin" / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def _dh(mangled: str) -> str:
    """The head width of a flash_attention instantiation's mangled name."""
    import re

    m = re.search(r"ILi(\d+)E", mangled)
    return m.group(1) if m else "?"


def check_flash_build(so: Path):
    """Registers and spills of the bf16 tensor-core instantiations, and
    their wgmma (HGMMA) and TMA (UTMALDG) instructions; fails if a bf16
    tensor-core kernel has no HGMMA.  Returns what it read."""
    from repro_torch.kernels import _build

    usage = {fn: u for fn, u in ptxas_usage(_build.build_log("flash_attention"))
             .items() if FLASH_WGMMA in fn}
    check(usage, f"the build log lists no {FLASH_WGMMA} instantiation")
    found = {}
    for fn, (regs, st, ld) in sorted(usage.items(), key=lambda kv: int(_dh(kv[0]))):
        found[_dh(fn)] = {"registers": regs, "spill_store_bytes": st,
                          "spill_load_bytes": ld}
        print(f"{FLASH_WGMMA}<Dh {_dh(fn)}>: {regs} registers, spill stores "
              f"{st} B, spill loads {ld} B")
    counts = sass_counts(so)
    if counts is None:
        print("cuobjdump not found next to nvcc: the SASS check of HGMMA "
              "instructions is skipped")
        return found
    wgmma = {fn: c for fn, c in counts.items() if FLASH_WGMMA in fn}
    check(wgmma, f"the SASS of {so.name} has no {FLASH_WGMMA} function")
    for fn, c in sorted(wgmma.items(), key=lambda kv: int(_dh(kv[0]))):
        print(f"{FLASH_WGMMA}<Dh {_dh(fn)}> SASS: {c['HGMMA']} HGMMA, "
              f"{c['UTMALDG']} UTMALDG")
        check(c["HGMMA"] > 0, f"{FLASH_WGMMA}<Dh {_dh(fn)}> has no HGMMA "
              "instruction: the bf16 kernel does not run on the tensor cores")
        found[_dh(fn)].update(c)
    core = sum(c["HGMMA"] for fn, c in counts.items() if FLASH_WGMMA not in fn)
    print(f"HGMMA in the CUDA-core flash_attention_kernel instantiations: {core}")
    return found


def print_ptxas(name: str):
    """Registers and spills of each instantiation of kernel ``name``, from
    its build log; returns {short name: {registers, spill bytes}}."""
    import re
    from repro_torch.kernels import _build

    usage = {}
    for fn, (regs, st, ld) in sorted(ptxas_usage(_build.build_log(name)).items()):
        m = re.search(rf"{name}_[a-z]+_kernel|{name}_kernel", fn)
        kind = m.group(0) if m else fn
        dtype = "bf16" if "bfloat16" in fn else ("f32" if "If" in fn else "")
        arg = re.search(r"Li(\d+)E", fn)  # an int template argument
        if arg and kind == "mamba_scan_kernel":
            g, ng, steps = re.findall(r"Li(\d+)E", fn)[:3]
            width = (f"{g} states a thread, {ng} warps, {steps}-step tiles, "
                     + ("cp.async" if "Lb1E" in fn else "plain loads"))
        elif arg and "rows" in kind:
            width = f"{arg.group(1)} rows a lane"
        elif (arg and arg.group(1) != "1") or "3Vec" in fn:
            width = "vector"
        else:
            width = "scalar" if arg or "6Scalar" in fn else ""
        short = " ".join(x for x in (kind, dtype, width) if x)
        usage[short] = {"registers": regs, "spill_store_bytes": st,
                        "spill_load_bytes": ld}
        print(f"ptxas {short}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B")
    check(usage, f"the build log of {name} lists no kernel")
    return usage


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
    from concurrent.futures import ThreadPoolExecutor

    def build(name):
        t = time.perf_counter()
        so = _build.build(name)
        return so, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        built = dict(zip(KERNELS, pool.map(build, KERNELS)))
    print(f"kernel builds, in parallel: {time.perf_counter() - t0:.3f} s")
    for name, (so, secs) in built.items():
        _build.load(name)
        print(f"kernel build: {name} -> {so.relative_to(ROOT)} in {secs:.3f} s")
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line:
                print(f"  {line.strip()}")
    return check_flash_build(built["flash_attention"][0])


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
    if device.type == "cuda":  # segment_sum in place, in one execute
        profile_breakdown(lambda: job.execute(sources), "execute", top=3)
    return reducer_inputs, launches


def _reduce_tensors(keys, values, device):
    """What word count's reduce hands the kernel for one reducer."""
    import numpy as np
    import torch

    uniq = np.unique(keys)
    seg = np.searchsorted(uniq, keys).astype(np.int32)
    v = torch.from_numpy(np.asarray(values, np.float32)[:, None]).to(device)
    return v, torch.from_numpy(seg).to(device), int(uniq.shape[0])


def phase_segment_sum(device, reducer_inputs, launches):
    import numpy as np
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment_reduce import segment_sum

    print("== phase 3: segment_sum against its plain version", flush=True)
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
    # the same reducer's ids and values at storage offsets that are not 16
    # bytes: views into larger tensors (the kernel's ragged head and tail,
    # vector loads only where both line up)
    for i_off, v_off in ((1, 3), (2, 2), (3, 0)):
        i_view = torch.cat([ids[:i_off], ids])[i_off:]
        v_view = torch.cat([vals[:v_off], vals])[v_off:]
        cases.append((f"main-path shape, ids offset {i_off} values offset "
                      f"{v_off}", v_view, i_view, s, 0.0, 0.0))
    # a hot id: one id for every row, a run across every lane and warp
    cases.append(("one id for every row N=1000000",
                  torch.ones(1_000_000, 1, device=device),
                  torch.zeros(1_000_000, dtype=torch.int32, device=device), 1,
                  0.0, 0.0))
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

    ptxas = print_ptxas("segment_sum")
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
        print(f"{label:42s} N={i.shape[0]} S={s} D={v.shape[1]} {v.dtype}: "
              f"max |err| {rows[-1][4]!r} (atol {atol}, rtol {rtol})")

    entry = None
    for label, v, i, s, err in rows:
        if label != main[0] and not label.startswith(("no combining", "wide")):
            continue
        n, d = v.shape
        kept = int(((i >= 0) & (i < s)).sum())
        elem = v.element_size()
        bound, bound_by = segment_sum_bound_ms(kept, n, d, s, elem)
        plain = time_ms(lambda: segment_sum_ref(v, i, s))
        run = lambda: segment_sum(v, i, s)  # noqa: E731
        ms = time_ms(run)
        library = in_turns = None
        if v.dtype == torch.float32:
            i64 = i.long()

            def index_add():
                return torch.zeros(s, d, device=device).index_add_(0, i64, v)

            library = time_ms(index_add)
            in_turns = time_pair_ms(run, index_add)
        dev_ms = kernel_device_ms(run, "segment_sum_")
        queued = time_queued_ms(run)
        print(f"timing {label:32s} wrapper {ms!r} ms  kernel (device) "
              f"{dev_ms!r} ms  queued on the card (zero-fill, kernel and "
              f"cast) {queued!r} ms  plain {plain!r} ms  library {library!r} "
              f"ms  in turns (wrapper, library) {in_turns!r} ms  bound "
              f"{bound!r} ms ({bound_by})")
        if label == main[0]:
            entry = {
                "name": "segment_sum", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
                "replaces": "src/repro/kernels/segment_reduce.py:26",
                "launches": launches, "max_abs_err": max(r[4] for r in rows),
                "ms": ms, "kernel_device_ms": dev_ms, "queued_ms": queued,
                "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library,
                "ms_in_turns": in_turns and in_turns[0],
                "library_ms_in_turns": in_turns and in_turns[1],
                "shape": {"N": n, "S": s, "D": d, "dtype": str(v.dtype)},
                "ptxas": ptxas,
            }
    return entry


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


def device_activity(prof):
    """(busy µs, device event count, µs by kernel name) of a profile: busy
    time is the union of the device intervals (kernels, copies, fills)."""
    import torch

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return busy_us, len(spans), by_name


#: rglru_scan's kernels: the chunk pairs (skipped where one chunk covers
#: T) and the rescan, launched once each a call
RGLRU_KERNELS = ("rglru_scan_summary_kernel", "rglru_scan_output_kernel")
#: moe_dispatch's kernels: the index and gather passes, launched once
#: each a call, or the one-launch path of a small dispatch
MOE_KERNELS = ("moe_dispatch_index_kernel", "moe_dispatch_gather_kernel",
               "moe_dispatch_small_kernel")
#: the kernels' device names, as the profiler lists them: one kernel a
#: call, or moe_dispatch's two
KERNEL_NAMES = {"segment_sum": ("segment_sum_",),
                "flash_attention": ("flash_attention_kernel",),
                "rglru_scan": RGLRU_KERNELS,
                "mamba_scan": ("mamba_scan_kernel",),
                "moe_dispatch": MOE_KERNELS}


def profile_breakdown(fn, label, top=8):
    """Where one call of ``fn`` spends its time on the card: host wall,
    device busy share, the ``top`` kernels by device time, and each
    kernel's launches and device time per call in place."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy_us, n, by_name = device_activity(prof)
    if not n:
        print(f"profile {label}: wall {wall_us / 1e3!r} ms, device time not "
              "measured (the profiler recorded no device activity)")
        return
    total = sum(by_name.values())
    print(f"profile {label}: wall {wall_us / 1e3!r} ms (profiled)  device busy "
          f"{busy_us / 1e3!r} ms  busy share {busy_us / wall_us!r}  device "
          f"events {n}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:10.3f} ms  {us / total:6.1%}  {name[:110]}")
    for kernel, keys in KERNEL_NAMES.items():
        spans = {key: [e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and key in e.name] for key in keys}
        calls = max(len(v) for v in spans.values())  # each name once a call
        us = sum(sum(v) for v in spans.values())
        if calls:
            print(f"  in place: {kernel} {calls} calls "
                  f"({sum(len(v) for v in spans.values())} kernels), "
                  f"{us / 1e3!r} ms ({us / total:.1%}), "
                  f"{us / calls / 1e3!r} ms per call")


def solver_device_share(device, n_restarts=N_RESTARTS, steps=PROFILE_STEPS):
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
    busy_us, n_events, _ = device_activity(prof)
    if not n_events:
        print(f"solver profile {n_restarts}x{steps}: wall {wall!r} s, device "
              "time not measured (the profiler recorded no device activity)")
        return
    print(f"solver profile {n_restarts}x{steps}: wall {wall!r} s  device busy "
          f"{busy_us / 1e6!r} s  busy share {busy_us / 1e6 / wall!r}  device "
          f"launches {n_events} ({n_events / steps!r} per step)")


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

def serve_prompts(vocab, seed=0, fixed=SERVE_PROMPTS, n_random=SERVE_RANDOM_PROMPTS,
                  longest=max(SERVE_PROMPTS)):
    """The served prompts: the fixed lengths, then random ones, tokens
    uniform over the vocabulary, all from one seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = list(fixed) + [int(n) for n in rng.integers(16, longest + 1,
                                                          size=n_random)]
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _lm_kernels():
    """The LM kernels' wrappers by name, whose ``.launches`` count."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.rglru_scan import rglru_scan

    return {"flash_attention": flash_attention, "rglru_scan": rglru_scan,
            "mamba_scan": mamba_scan, "moe_dispatch": moe_dispatch}


def expected_launches(cfg):
    """Launches of each LM kernel per admission (a prefill) and per decode
    step: attention prefills only, the recurrences and the MoE dispatch
    every call."""
    blocks = list(cfg.pattern) * cfg.n_groups + list(cfg.tail)
    n = {m: sum(b.mixer == m for b in blocks) for m in ("attn", "rglru", "ssm")}
    n_moe = sum(b.ffn == "moe" for b in blocks)
    return {"flash_attention": (n["attn"], 0),
            "rglru_scan": (n["rglru"], n["rglru"]),
            "mamba_scan": (n["ssm"], n["ssm"]),
            "moe_dispatch": (n_moe, n_moe)}


def phase_serving(device, arch=SERVE_ARCH, cfg=None, slots=SERVE_SLOTS,
                  max_len=SERVE_MAX_LEN, new_tokens=SERVE_NEW, prompts=None,
                  fixed=SERVE_PROMPTS, phase="5"):
    """``arch`` through ServeEngine in bfloat16, on ``prompts`` (default:
    the ``fixed`` lengths and random ones); returns the kernels' launch
    counts of the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = cfg or get_config(arch)
    print(f"== phase {phase}: serving {cfg.name} (ServeEngine, bfloat16)",
          flush=True)
    kernels = _lm_kernels()
    expect = expected_launches(cfg)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.n_params() / 1e9:.3f} B parameters; launches "
          f"expected per admission and per decode step {expect}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = M.init(cfg, gen, device=device, dtype=torch.bfloat16)
    _sync(device)
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    print(f"init: {n_bytes / 1e9:.3f} GB of weights in {time.perf_counter() - t:.3f} s")
    init_peak = 0
    if device.type == "cuda":
        # init draws each leaf in float32 before the cast: its own peak
        init_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    print(f"init peak device memory {init_peak / 1e9!r} GB")
    check(init_peak < CARD_BYTES, f"init peak device memory "
          f"{init_peak / 1e9} GB over {CARD_BYTES / 1e9} GB")
    eng = ServeEngine(cfg, params, ServeConfig(
        slots=slots, max_len=max_len, compute_dtype=torch.bfloat16,
        use_kernels=True, seed=0), device=device)
    prompts = prompts if prompts is not None else serve_prompts(cfg.vocab,
                                                                fixed=fixed)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    print(f"requests: {len(reqs)}, prompt lengths {[len(p) for p in prompts]}, "
          f"{new_tokens} new tokens each")

    records = {"prefill": [], "decode": []}
    real = {"prefill": M.prefill, "decode": M.decode_step}

    def timed(kind):
        def run(*args, **kwargs):
            _sync(device)
            before = {k: w.launches for k, w in kernels.items()}
            t0 = time.perf_counter()
            logits, cache, aux = real[kind](*args, **kwargs)
            finite = bool(torch.isfinite(logits).all())
            _sync(device)
            records[kind].append({
                "s": time.perf_counter() - t0, "finite": finite,
                "T": int(logits.shape[1]),
                "launched": {k: w.launches - before[k]
                             for k, w in kernels.items()}})
            return logits, cache, aux
        return run

    for r in reqs:
        eng.submit(r)
    M.prefill, M.decode_step = timed("prefill"), timed("decode")
    try:
        for w in (*kernels.values(), segment_sum):
            w.launches = 0
        t = time.perf_counter()
        done = eng.run()
        _sync(device)
        wall = time.perf_counter() - t
        launches = {k: w.launches for k, w in kernels.items()}
        launches["segment_sum"] = segment_sum.launches
    finally:
        M.prefill, M.decode_step = real["prefill"], real["decode"]

    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        check(r.done and len(r.output) == new_tokens,
              f"request {r.rid}: {len(r.output)} tokens, wanted {new_tokens}")
        check(all(0 <= tok < cfg.vocab for tok in r.output),
              f"request {r.rid}: a token outside [0, {cfg.vocab})")
    pre, dec = records["prefill"], records["decode"]
    check(all(x["finite"] for x in pre + dec), "a logit is not finite")
    check(len(pre) == len(reqs), f"{len(pre)} prefills for {len(reqs)} requests")
    for kind, calls, col in (("prefill", pre, 0), ("decode step", dec, 1)):
        want = {k: v[col] for k, v in expect.items()}
        for x in calls:
            check(x["launched"] == want,
                  f"{kind} of {x['T']} tokens launched {x['launched']}, "
                  f"wanted {want}")
    for k, (per_admission, per_step) in expect.items():
        total = per_admission * len(pre) + per_step * len(dec)
        check(launches[k] == total,
              f"{k}: {launches[k]} launches in the run, wanted {total}")
        if per_admission:
            check(launches[k] > 0, f"the serving path never launched {k}")
    check(launches["segment_sum"] == 0, "serving launched segment_sum")
    decode_s = sum(x["s"] for x in dec)
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    for x in pre:
        print(f"prefill T={x['T']:5d}: {x['s']!r} s")
    print(f"decode: {len(dec)} steps, {decode_tokens} tokens in {decode_s!r} s: "
          f"{decode_tokens / decode_s!r} tokens/s, {decode_s / len(dec) * 1e3!r} "
          f"ms/step (first step {dec[0]['s'] * 1e3!r} ms)")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"serving wall {wall!r} s; launches {launches}; peak device memory "
          f"while serving {peak / 1e9!r} GB; card {torch.cuda.get_device_name(0) if device.type == 'cuda' else device}")
    check(peak < CARD_BYTES, f"peak device memory {peak / 1e9} GB over "
          f"{CARD_BYTES / 1e9} GB")
    if device.type == "cuda":
        longest = max(prompts, key=len)
        batch = {"tokens": torch.zeros((slots, 1), dtype=torch.long, device=device),
                 "positions": torch.full((slots, 1), len(longest), device=device)}
        profile_breakdown(lambda: M.decode_step(cfg, eng.params, batch, eng.cache,
                                                use_kernels=True),
                          f"decode step ({slots} slots)")
        tokens = torch.as_tensor(longest[None].astype("int64"), device=device)
        profile_breakdown(lambda: M.prefill(cfg, eng.params, {"tokens": tokens},
                                            max_cache_len=max_len,
                                            use_kernels=True),
                          f"prefill of {len(longest)} tokens")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _close(got, want, atol, rtol):
    """(ok, max |err|) of ``got`` against ``want`` under atol + rtol·|want|."""
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    return ok, float(err.max()) if err.numel() else 0.0


def live_pairs(t_len, s_len, causal, window, q_offset):
    """(query, key) pairs that the mask lets through, for one head."""
    total = 0
    for t in range(t_len):
        hi = min(s_len - 1, t + q_offset) if causal else s_len - 1
        lo = max(0, t + q_offset - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound_ms(q, k, causal, window, q_offset):
    """Least time: q, k, v read once and the output written once, against
    2·Dh multiply-adds (QKᵀ and PV) per live pair and head."""
    B, Hq, T, Dh = q.shape
    S = k.shape[2]
    elem = q.element_size()
    n_bytes = (2 * B * Hq * T * Dh + 2 * k.numel()) * elem
    ops = 4 * Dh * B * Hq * live_pairs(T, S, causal, window, q_offset)
    rate = BF16_OPS_PER_S if elem == 2 else F32_OPS_PER_S
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_timings(q, k, v, window, causal=True):
    """bf16 flash_attention at a served shape, timed five ways: the wrapper
    back to back, the profiler's device time per launch, one call alone,
    the launches queued on the card; and the CUDA-core kernel that served
    the shape before (its C entry called directly: no launch is counted)
    back to back and queued."""
    import torch
    from repro_torch.kernels.flash_attention import _kernel, flash_attention

    def run():
        return flash_attention(q, k, v, causal=causal, window=window)

    def cuda_core():
        out = torch.empty_like(q)
        B, Hq, T, Dh = q.shape
        rc = _kernel("flash_attention_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            k.shape[1], T, k.shape[2], Dh, int(causal),
            -1 if window is None else window, 0, Dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the CUDA-core flash_attention kernel failed: {rc}")
        return out

    return {
        "ms": time_ms(run, runs=10, per_run=5),
        "kernel_device_ms": kernel_device_ms(run, "flash_attention_kernel",
                                             calls=5),
        "alone_ms": time_alone_ms(run),
        "queued_ms": time_queued_ms(run),
        "cuda_core_ms": time_ms(cuda_core, runs=3, per_run=3, warmup=1),
        "cuda_core_queued_ms": time_queued_ms(cuda_core, calls=5),
    }


def rglru_bound_ms(x, has_h0):
    """Least time: x and a read, y written, h0 read and h_T written once;
    about 7 float32 operations per element."""
    B, T, D = x.shape
    n_bytes = 3 * x.numel() * x.element_size() + (2 if has_h0 else 1) * B * D * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 7 * x.numel() / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


#: rglru_scan's edges: (B, T, D, a) with T at and around the chunk
#: lengths the wrapper picks (16 steps and more), D off the 128-channel
#: tile, B = 3, a near 1 and near 0; near 1 also at 33 and 32 chunks,
#: where pass 2 folds pairs past its groups of 8 while the carry survives
RGLRU_EDGES = (
    (1, 1, 130, "sigmoid"), (3, 1, 33, "near_zero"), (1, 15, 256, "sigmoid"),
    (1, 16, 256, "near_one"), (1, 17, 256, "sigmoid"), (3, 33, 130, "near_zero"),
    (2, 100, 200, "near_one"), (1, 1025, 256, "sigmoid"),
    (1, 1025, 256, "near_one"), (3, 3000, 4096, "sigmoid"),
    (1, 3000, 4096, "near_one"), (1, 2049, 4096, "near_zero"),
)


def rglru_gate(n, kind):
    """a in (0, 1) from N(0, 1) draws ``n``: their sigmoid, or 1 - 1e-4·u or
    1e-4·u with u in (0.5, 1), where a chunk's product underflows to 0."""
    import torch

    if kind == "sigmoid":
        return torch.sigmoid(n)
    u = 0.5 + 0.5 * torch.sigmoid(n)
    return 1.0 - 1e-4 * u if kind == "near_one" else 1e-4 * u


def phase_lm_kernels(device, launches, lengths=(17, 2049, 3000), hq=16, dh=256,
                     window=2048, width=4096, slots=SERVE_SLOTS):
    """flash_attention and rglru_scan against their plain versions at the
    served shapes, and their times; returns their kernels-line entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref, rglru_scan_ref
    from repro_torch.kernels.rglru_scan import _geometry as rglru_geometry
    from repro_torch.kernels.rglru_scan import chunking as rglru_chunking
    from repro_torch.kernels.rglru_scan import rglru_scan

    print("== phase 6a: flash_attention and rglru_scan against their plain "
          "versions", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(1)

    def normal(*shape, dtype):
        return torch.randn(shape, generator=gen).to(device, dtype)

    errs = {"flash_attention": 0.0, "rglru_scan": 0.0}
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = KERNEL_TOL[str(dtype)]
        for t_len in lengths:
            for q_offset in (0, 1000):
                s_len = t_len + q_offset
                q = normal(1, hq, t_len, dh, dtype=dtype)
                k = normal(1, 1, s_len, dh, dtype=dtype)
                v = normal(1, 1, s_len, dh, dtype=dtype)
                got = flash_attention(q, k, v, causal=True, window=window,
                                      q_offset=q_offset)
                _sync(device)
                want = attention_ref(q, k, v, causal=True, window=window,
                                     q_offset=q_offset)
                ok, err = _close(got, want, atol, rtol)
                check(ok and got.dtype == q.dtype, f"flash_attention T={t_len} "
                      f"S={s_len} q_offset={q_offset} {dtype}: max |err| {err} "
                      f"over atol {atol} rtol {rtol}")
                errs["flash_attention"] = max(errs["flash_attention"], err)
                print(f"flash_attention (1,{hq},{t_len},{dh}) S={s_len} window "
                      f"{window} q_offset {q_offset} {dtype}: max |err| {err!r} "
                      f"(atol {atol}, rtol {rtol})")
                if t_len == max(lengths) and q_offset == 0:
                    timed[("flash_attention", dtype)] = (q, k, v)
        for b, t_len, label in ((1, max(lengths), "prefill"), (slots, 1, "decode")):
            x = normal(b, t_len, width, dtype=dtype)
            a = torch.sigmoid(normal(b, t_len, width, dtype=torch.float32)).to(dtype)
            h0 = (torch.zeros(b, width, device=device) if label == "prefill"
                  else normal(b, width, dtype=torch.float32))
            y, h_t = rglru_scan(x, a, h0)
            _sync(device)
            y_ref, h_ref = rglru_scan_ref(x, a, h0)
            ok_y, err_y = _close(y, y_ref, atol, rtol)
            ok_h, err_h = _close(h_t, h_ref, atol, rtol)
            check(ok_y and ok_h and y.dtype == dtype and h_t.dtype == torch.float32,
                  f"rglru_scan {label} {dtype}: max |err| y {err_y} h_T {err_h}")
            errs["rglru_scan"] = max(errs["rglru_scan"], err_y, err_h)
            print(f"rglru_scan {label} ({b},{t_len},{width}) {dtype} with h0: max "
                  f"|err| y {err_y!r} h_T {err_h!r} (atol {atol}, rtol {rtol})")
            timed[("rglru_scan", dtype, label)] = (x, a, h0)

    # the chunked scan's edges: T at and around the chunk lengths the
    # wrapper picks, D off the 128-channel tile, B = 3, a near 1 and near 0
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = KERNEL_TOL[str(dtype)]
        edge_err = 0.0
        for b, t_len, d, kind in RGLRU_EDGES:
            x = normal(b, t_len, d, dtype=dtype)
            a = rglru_gate(normal(b, t_len, d, dtype=torch.float32), kind).to(dtype)
            for h0 in (None, normal(b, d, dtype=torch.float32)):
                y, h_t = rglru_scan(x, a, h0)
                _sync(device)
                y_ref, h_ref = rglru_scan_ref(x, a, h0)
                ok_y, err_y = _close(y, y_ref, atol, rtol)
                ok_h, err_h = _close(h_t, h_ref, atol, rtol)
                check(ok_y and ok_h, f"rglru_scan ({b},{t_len},{d}) a {kind} "
                      f"{dtype} h0 {h0 is not None}: max |err| y {err_y} h_T "
                      f"{err_h} over atol {atol} rtol {rtol}")
                edge_err = max(edge_err, err_y, err_h)
        errs["rglru_scan"] = max(errs["rglru_scan"], edge_err)
        print(f"rglru_scan edges {dtype}: {len(RGLRU_EDGES)} shapes "
              f"{RGLRU_EDGES} with and without h0: max |err| {edge_err!r} "
              f"(atol {atol}, rtol {rtol})")
    x, a, h0 = timed[("rglru_scan", torch.float32, "prefill")]
    first, second = rglru_scan(x, a, h0), rglru_scan(x, a, h0)
    _sync(device)
    check(all(torch.equal(u, w) for u, w in zip(first, second)),
          "rglru_scan: two calls at the served prefill differ")

    # times at the served shapes: the prefill of the longest prompt, whose
    # scan inputs are float32 in the bf16 model (the reference's sigmoid and
    # gating reach its scan unrounded), and the decode step, whose
    # recurrence runs in float32 (the float32 serving cache promotes it, as
    # in the reference); the bf16 prefill as the kernel served it before
    q, k, v = timed[("flash_attention", torch.bfloat16)]
    t_len = q.shape[2]
    mask = torch.ones(t_len, t_len, dtype=torch.bool, device=device).tril()
    mask &= ~torch.ones_like(mask).tril(-window)
    kx, vx = k.expand(q.shape), v.expand(q.shape)  # MQA as views
    times = flash_timings(q, k, v, window)
    ms, dev_ms = times["ms"], times["kernel_device_ms"]
    plain = time_ms(lambda: attention_ref(q, k, v, window=window), runs=5,
                    per_run=1, warmup=1)
    def sdpa():
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)

    library = time_ms(sdpa, runs=10, per_run=5)
    times["library_queued_ms"] = time_queued_ms(sdpa)
    bound, bound_by = flash_bound_ms(q, k, True, window, 0)
    print(f"timing flash_attention (1,{hq},{t_len},{dh}) window {window} "
          f"{q.dtype}: wrapper {ms!r} ms  kernel (device) {dev_ms!r} ms  one "
          f"call alone (events) {times['alone_ms']!r} ms  queued on the card "
          f"{times['queued_ms']!r} ms  CUDA-core kernel {times['cuda_core_ms']!r}"
          f" ms (queued {times['cuda_core_queued_ms']!r})  plain {plain!r} ms  "
          f"library (sdpa, boolean mask) {library!r} ms (queued "
          f"{times['library_queued_ms']!r})  bound {bound!r} ms ({bound_by})")
    entries = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], **times, "plain_ms": plain,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
        "shape": {"B": 1, "Hq": hq, "Hkv": 1, "T": t_len, "S": t_len,
                  "Dh": dh, "window": window, "dtype": str(q.dtype)},
    }]
    rglru = {"name": "rglru_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
             "replaces": "src/repro/kernels/rglru_scan.py:25",
             "launches": launches["rglru_scan"],
             "max_abs_err": errs["rglru_scan"],
             "ptxas": print_ptxas("rglru_scan")}
    for key in (("rglru_scan", torch.float32, "prefill"),
                ("rglru_scan", torch.bfloat16, "prefill"),
                ("rglru_scan", torch.float32, "decode")):
        x, a, h0 = timed[key]
        ms = time_ms(lambda: rglru_scan(x, a, h0), runs=10, per_run=5)
        # the kernels a call launches, as the profiler recorded them: both
        # passes at the prefill, the rescan alone at a decode step.  The
        # bf16 prefill, timed beside the kernel as it was served before,
        # by CUDA events only: with that profiler session added, a later
        # one recorded no launch in two of three runs on the H100
        per_name, dev_ms = {}, None
        if key[1] == torch.float32:
            dev_ms = kernel_device_ms(lambda: rglru_scan(x, a, h0),
                                      RGLRU_KERNELS, calls=5,
                                      recorded_per_call=per_name)
            summary, output = (per_name.get(n, 0.0) for n in RGLRU_KERNELS)
            check(output > 0 and (summary > 0) == (key[2] == "prefill"),
                  f"rglru_scan {key[2]}: the profiler recorded {per_name} "
                  f"launches a call of {RGLRU_KERNELS}: need both kernels "
                  "at the prefill and the rescan alone at a decode step")
        summary, output = (per_name.get(n, 0.0) for n in RGLRU_KERNELS)
        queued = time_queued_ms(lambda: rglru_scan(x, a, h0))
        plain = time_ms(lambda: rglru_scan_ref(x, a, h0), runs=3, per_run=1,
                        warmup=1)
        bound, bound_by = rglru_bound_ms(x, True)
        chunk, n_chunks = rglru_chunking(*x.shape,
                                         *rglru_geometry(x.get_device()))
        print(f"timing rglru_scan {key[2]} {tuple(x.shape)} {key[1]}: wrapper "
              f"{ms!r} ms  kernels (device) {dev_ms!r} ms  queued on the card "
              f"{queued!r} ms  plain {plain!r} ms  library none  bound "
              f"{bound!r} ms ({bound_by}); the wrapper's chunking: {n_chunks} "
              f"chunks of {chunk} steps; recorded launches a call {per_name}")
        # the profiler may miss launches (on an H100, before its sessions
        # had a warm-up step, it recorded 3 or 4 of 5 calls'): count the
        # kernels it saw, and give its launches a call
        times = {"ms": ms, "kernel_device_ms": dev_ms, "queued_ms": queued,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                 "kernels_per_call": (summary > 0) + (output > 0),
                 "recorded_launches_per_call": per_name,
                 "shape": {"B": x.shape[0], "T": x.shape[1], "D": width,
                           "dtype": str(x.dtype)}}
        if key[2] == "decode":
            rglru["decode"] = times
        elif key[1] == torch.float32:
            rglru.update(times, library_ms=None)
        else:
            rglru["bf16_prefill"] = times
    entries.append(rglru)
    return entries


def mamba_bound_ms(b, t_len, d_inner, d_state, act_elem, param_elem,
                   has_h0):
    """Least time: x, Δ, B and C read, y written, A and D read, h0 read and
    h_T written once (float32), against 7 float32 operations per state
    update (Δ·A, exp, Δ·x·B, the FMA into h, h·C and its sum), over 67
    TFLOP/s.  Also the time of the exponentials alone on the special
    function units, a term the bound does not count.  Returns (ms,
    "bytes" | "operations", exp_sfu_ms)."""
    updates = b * t_len * d_inner * d_state
    n_bytes = ((3 * b * t_len * d_inner + 2 * b * t_len * d_state) * act_elem
               + (d_inner * d_state + d_inner) * param_elem
               + (2 if has_h0 else 1) * b * d_inner * d_state * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 7 * updates / F32_OPS_PER_S * 1e3
    sfu_ms = updates / SFU_EXP_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", sfu_ms
    return ops_ms, "operations", sfu_ms


#: mamba_scan's edges: (B, T, d_inner, d_state) with T inside, at and
#: around the 64-step time tile and past the 3-stage ring, d_inner off the
#: 32-channel tile, d_state 1, 5, 16 and 32, B = 3
MAMBA_EDGES = (
    (1, 31, 64, 16), (1, 63, 64, 16), (1, 64, 64, 16), (1, 65, 64, 16),
    (2, 128, 96, 16), (1, 129, 32, 16), (3, 193, 100, 5), (3, 200, 33, 1),
    (2, 130, 20, 32), (1, 1, 33, 32), (3, 1, 40, 5),
)


def mamba_edge_inputs(normal, b, t_len, di, ds, dtype, param):
    """x, Δ = softplus(N), A = -softplus(N), B, C, D and h0: activations in
    ``dtype``, A and D in ``param``."""
    import torch
    import torch.nn.functional as F

    return (normal(b, t_len, di, dtype=dtype),
            F.softplus(normal(b, t_len, di)).to(dtype),
            (-F.softplus(normal(di, ds))).to(param),
            normal(b, t_len, ds, dtype=dtype), normal(b, t_len, ds, dtype=dtype),
            normal(di, dtype=param), normal(b, di, ds, dtype=torch.float32))


def mamba_against_plain(args, atol, rtol, label):
    """The kernel against its plain version on ``args``; fails past the
    tolerance; returns the largest error of y and h_T."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ref import mamba_scan_ref

    y, h_t = mamba_scan(*args)
    _sync(args[0].device)
    y_ref, h_ref = mamba_scan_ref(*args)
    ok_y, err_y = _close(y, y_ref, atol, rtol)
    ok_h, err_h = _close(h_t, h_ref, atol, rtol)
    check(ok_y and ok_h and y.dtype == args[0].dtype
          and h_t.dtype == torch.float32,
          f"mamba_scan {label}: max |err| y {err_y} h_T {err_h} over atol "
          f"{atol} rtol {rtol}")
    return max(err_y, err_h)


def phase_mamba_kernel(device, launches, lengths=(17, 2048, 3000),
                       d_inner=8192, d_state=16, slots=SERVE_SLOTS,
                       timed_len=None):
    """mamba_scan against its plain version at the served shapes, and its
    times; returns its kernels-line entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ref import mamba_scan_ref

    print("== phase 8a: mamba_scan against its plain version", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(3)
    timed_len = timed_len or max(lengths)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device, dtype)

    # A and D as the served model holds them: bfloat16 parameters, A the
    # initial -exp(A_log) = -(1..d_state)
    A = -torch.arange(1, d_state + 1, dtype=torch.float32).expand(
        d_inner, d_state).to(device, torch.bfloat16)
    D = normal(d_inner, dtype=torch.bfloat16)

    def inputs(b, t_len, dtype, with_h0):
        x = normal(b, t_len, d_inner, dtype=dtype)
        delta = F.softplus(normal(b, t_len, d_inner)).to(dtype)
        Bc = normal(b, t_len, d_state, dtype=dtype)
        Cc = normal(b, t_len, d_state, dtype=dtype)
        h0 = normal(b, d_inner, d_state) if with_h0 else None
        return x, delta, A, Bc, Cc, D, h0

    cases = [(1, t_len, dtype, with_h0) for dtype in (torch.bfloat16, torch.float32)
             for t_len in lengths for with_h0 in (False, True)]
    cases.append((slots, 1, torch.float32, True))  # the decode step
    err_max, timed = 0.0, {}
    for b, t_len, dtype, with_h0 in cases:
        args = inputs(b, t_len, dtype, with_h0)
        atol, rtol = MAMBA_TOL[str(dtype)]
        err = mamba_against_plain(args, atol, rtol,
                                  f"({b},{t_len},{d_inner},{d_state}) {dtype} "
                                  f"h0 {with_h0}")
        err_max = max(err_max, err)
        print(f"mamba_scan ({b},{t_len},{d_inner},{d_state}) {dtype}, A and D "
              f"bfloat16, h0 {with_h0}: max |err| {err!r} (atol {atol}, rtol "
              f"{rtol})")
        # the served prefill's scan inputs are float32 in the bf16 model
        # (the reference's silu reaches its scan unrounded); the bf16
        # prefill as the kernel served it before
        if with_h0 and t_len in (timed_len, 1):
            timed[("prefill" if t_len > 1 else "decode", dtype)] = args

    # the tiling's edges: T at and around the 64-step time tile and past the
    # 3-stage ring, d_inner off the 32-channel tile, d_state 1 to 32, B = 3;
    # A and D in float32 and in bfloat16
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = MAMBA_TOL[str(dtype)]
        edge_err = 0.0
        for b, t_len, di, ds in MAMBA_EDGES:
            for param in (torch.bfloat16, torch.float32):
                args = mamba_edge_inputs(normal, b, t_len, di, ds, dtype, param)
                edge_err = max(edge_err, mamba_against_plain(
                    args, atol, rtol, f"({b},{t_len},{di},{ds}) {dtype} A and "
                    f"D {param}"))
        # rows off 16 bytes: x and delta one element into their storage, B
        # and C views of a 13-wide projection (the plain-load staging)
        x, delta, A, Bc, Cc, D, h0 = mamba_edge_inputs(normal, 2, 70, 36, 5,
                                                       dtype, torch.bfloat16)
        flat = torch.empty(2 * x.numel() + 1, device=device, dtype=dtype)
        xs = flat[1:1 + x.numel()].view(x.shape)
        ds_ = flat[1 + x.numel():].view(x.shape)
        xs.copy_(x)
        ds_.copy_(delta)
        proj = normal(2, 70, 13, dtype=dtype)
        _, Bc, Cc = torch.split(proj, [3, 5, 5], dim=-1)
        edge_err = max(edge_err, mamba_against_plain(
            (xs, ds_, A, Bc, Cc, D, h0), atol, rtol,
            f"unaligned rows {dtype}"))
        err_max = max(err_max, edge_err)
        print(f"mamba_scan edges {dtype}: {len(MAMBA_EDGES)} shapes "
              f"{MAMBA_EDGES} with A and D in bfloat16 and float32, and "
              f"unaligned rows: max |err| {edge_err!r} (atol {atol}, rtol "
              f"{rtol})")
    args = timed[("prefill", torch.float32)]
    first, second = mamba_scan(*args), mamba_scan(*args)
    _sync(device)
    check(all(torch.equal(u, w) for u, w in zip(first, second)),
          "mamba_scan: two calls at the served prefill differ")

    entry = {"name": "mamba_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
             "replaces": "src/repro/kernels/mamba_scan.py:27",
             "launches": launches["mamba_scan"], "max_abs_err": err_max,
             "ptxas": print_ptxas("mamba_scan")}
    for label, dtype in (("prefill", torch.float32),
                         ("prefill", torch.bfloat16),
                         ("decode", torch.float32)):
        args = timed[(label, dtype)]
        x, h0 = args[0], args[-1]
        b, t_len, _ = x.shape
        ms = time_ms(lambda: mamba_scan(*args), runs=10, per_run=5)
        # the bf16 prefill by CUDA events only, as rglru_scan's (phase 6a)
        dev_ms = (kernel_device_ms(lambda: mamba_scan(*args),
                                   "mamba_scan_kernel", calls=5)
                  if dtype == torch.float32 else None)
        queued = time_queued_ms(lambda: mamba_scan(*args))
        plain = time_ms(lambda: mamba_scan_ref(*args), runs=3, per_run=1,
                        warmup=1)
        bound, bound_by, sfu = mamba_bound_ms(b, t_len, d_inner, d_state,
                                              x.element_size(), 2, True)
        print(f"timing mamba_scan {label} {tuple(x.shape)} d_state {d_state} "
              f"{x.dtype}: wrapper {ms!r} ms  kernel (device) {dev_ms!r} ms  "
              f"queued on the card {queued!r} ms  plain {plain!r} ms  library "
              f"none (no single PyTorch call computes a selective scan)  bound "
              f"{bound!r} ms ({bound_by}; exp on the SFUs alone {sfu!r} ms, "
              f"not counted)")
        times = {"ms": ms, "kernel_device_ms": dev_ms, "queued_ms": queued,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                 "exp_sfu_ms": sfu,
                 "shape": {"B": b, "T": t_len, "Di": d_inner, "Ds": d_state,
                           "dtype": str(x.dtype),
                           "A_D_dtype": "torch.bfloat16"}}
        if label == "decode":
            entry["decode"] = times
        elif dtype == torch.float32:
            entry.update(times, library_ms=None)
        else:
            entry["bf16_prefill"] = times
    return entry


def phase_model_kernels_vs_plain(device, arch=SERVE_ARCH, depth=None, cfg=None,
                                 prompt_len=3000, max_len=SERVE_MAX_LEN,
                                 steps=3, phase="6b"):
    """A full-width cut of ``arch`` to ``depth`` layers (default: one
    pattern group plus the tail), float32: prefill and decode logits with
    the kernels against the plain versions, on the same tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    base = cfg or get_config(arch)
    depth = depth or len(base.pattern) + len(base.tail)
    cfg = dataclasses.replace(base, n_layers=depth)
    print(f"== phase {phase}: {cfg.name} at full width and depth {depth}, "
          "kernels against plain versions (float32)", flush=True)
    kernels = _lm_kernels()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = M.init(cfg, gen, device=device, dtype=torch.float32)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, prompt_len)),
                             device=device)
    feed = rng.integers(0, cfg.vocab, size=steps)  # the same decode tokens
    atol, rtol = MODEL_TOL
    out = {}
    for use_kernels in (True, False):
        before = sum(w.launches for w in kernels.values())
        logits, cache, _ = M.prefill(cfg, params, {"tokens": tokens},
                                     max_cache_len=max_len,
                                     use_kernels=use_kernels)
        # the prefill cache is float32 here, as the serving cache is, and
        # padded to max_len: decode runs on it directly
        outs = [logits]
        for i, tok in enumerate(feed):
            batch = {"tokens": torch.tensor([[int(tok)]], device=device),
                     "positions": torch.tensor([[prompt_len + i]], device=device)}
            outs.append(M.decode_step(cfg, params, batch, cache,
                                      use_kernels=use_kernels)[0])
        _sync(device)
        launched = sum(w.launches for w in kernels.values()) - before
        check((launched > 0) == use_kernels,
              f"use_kernels={use_kernels}: {launched} kernel launches")
        out[use_kernels] = outs
    for i, (got, want) in enumerate(zip(out[True], out[False])):
        label = "prefill" if i == 0 else f"decode step {i}"
        ok, err = _close(got, want, atol, rtol)
        check(ok and bool(torch.isfinite(got).all()),
              f"{label}: max |err| {err} over atol {atol} rtol {rtol}")
        print(f"{cfg.name} depth {cfg.n_layers}, {label} logits "
              f"{tuple(got.shape)}: kernels vs plain max |err| {err!r} (atol "
              f"{atol}, rtol {rtol}; max |logit| {float(want.abs().max())!r})")
    del params


def moe_capacity(n_tokens, top_k, n_experts, capacity_factor):
    """The MoE layer's capacity C for ``n_tokens`` routed together."""
    import math

    return max(int(math.ceil(n_tokens * top_k / n_experts * capacity_factor)),
               top_k)


def moe_bound_ms(n_kept, t, d, e, c, elem):
    """Least time: the kept rows read once, every expert id and slot read
    once, the (E, C, D) buffers written once; one float32 add per kept
    element.  Returns (ms, "bytes" | "operations")."""
    n_bytes = n_kept * d * elem + 8 * t + e * c * d * elem
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_kept * d / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _routed(n_tokens, top_k, n_experts, capacity, d, dtype, rule, device,
            seed):
    """Routed rows as the MoE layer hands them to the dispatch: each token
    repeated top_k times, expert ids from a skewed router (a Dirichlet(2)
    load, so some experts overflow), slots from compute_slots.  ``rule``
    "unique": rows past C dropped (slot C), every kept pair unique (a
    float32 plan capacity of 1.0); "served": the layer's rule at the
    bfloat16 plan capacity of 1.0, whose capacity round(bf16(1) * C) may
    exceed C (bf16(750) = 752), the rows past C-1 then adding into slot
    C-1."""
    import numpy as np
    import torch
    from repro_torch.kernels.moe_dispatch import compute_slots

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n_tokens, d), dtype=np.float32))
    tokens = x.to(device, dtype).repeat_interleave(top_k, dim=0)
    load = rng.dirichlet(np.full(n_experts, 2.0))
    ids = np.stack([rng.choice(n_experts, size=top_k, replace=False, p=load)
                    for _ in range(n_tokens)]).reshape(-1)
    ids = torch.from_numpy(ids.astype(np.int32)).to(device)
    slots = compute_slots(ids, n_experts)
    cap = capacity
    if rule == "served":
        one = torch.ones((), dtype=torch.bfloat16)
        cap = max(int(torch.round(one * capacity)), 1)
    slots = torch.where(slots < cap, slots.clamp(max=capacity - 1),
                        capacity).int()
    return tokens, ids, slots


def _three_pass(tokens, ids, slot_ids, n_experts, capacity):
    """moe_dispatch's C entry given a workspace, so that it takes its
    memset, index and gather passes whatever the size (the wrapper gives
    none to a dispatch of the one-launch size)."""
    import torch
    from repro_torch.kernels.moe_dispatch import _kernel

    t, d = tokens.shape
    out = torch.empty((n_experts, capacity, d), dtype=tokens.dtype,
                      device=tokens.device)
    tables = torch.empty(2 * n_experts * capacity, dtype=torch.int32,
                         device=tokens.device)
    rc = _kernel(tokens.dtype)(
        tokens.data_ptr(), ids.data_ptr(), slot_ids.data_ptr(), out.data_ptr(),
        tables.data_ptr(), t, d, n_experts, capacity,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"moe_dispatch three-pass path: CUDA error {rc}")
    return out


def phase_moe_kernel(device, launches, prompt_len=3000, slots=SERVE_SLOTS,
                     d=1536, n_experts=40, top_k=8, capacity_factor=1.25,
                     hq=24, hkv=8, dh=64):
    """moe_dispatch against its plain version at the served shapes, with
    times; flash_attention at Granite's prefill shape.  Returns the
    moe_dispatch kernels-line entry and flash_attention's numbers at
    Granite's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.ref import attention_ref, moe_dispatch_ref

    print("== phase 10a: moe_dispatch and flash_attention (Granite's shapes) "
          "against their plain versions", flush=True)
    # repeated pairs against the plain version on the card: its index_add_
    # adds at most 3 float32 rows into one slot with atomics, in an order
    # that changes from run to run (~2 float32 ulps of the sum); a bfloat16
    # output may then round to the neighbouring value (one bf16 ulp, 2^-7
    # relative at most).  Against the plain version on a CPU copy, which
    # adds them in row order as the kernel does: bit for bit.
    tol = {"torch.float32": (1e-5, 1e-6), "torch.bfloat16": (1e-5, 2 ** -7)}
    ptxas = print_ptxas("moe_dispatch")
    err_max, timed = 0.0, {}
    for n_tokens, label in ((prompt_len, "prefill"), (slots, "decode")):
        c = moe_capacity(n_tokens, top_k, n_experts, capacity_factor)
        for dtype in (torch.bfloat16, torch.float32):
            for rule in ("unique", "served"):
                args = _routed(n_tokens, top_k, n_experts, c, d, dtype, rule,
                               device, seed=4)
                got = moe_dispatch(*args, n_experts, c)
                _sync(device)
                want = moe_dispatch_ref(*args, n_experts, c)
                tokens, ids, slot_ids = args
                kept = slot_ids < c
                pairs = ids[kept].long() * c + slot_ids[kept].long()
                repeats = int(kept.sum()) - int(pairs.unique().numel())
                if rule == "unique" or repeats == 0:
                    ok = torch.equal(got, want)
                    err = 0.0 if ok else float((got.float() - want.float())
                                               .abs().max())
                    how = "bit for bit"
                else:
                    ok, err = _close(got, want, *tol[str(dtype)])
                    how = f"atol {tol[str(dtype)][0]}, rtol {tol[str(dtype)][1]}"
                check(ok and got.dtype == dtype and tuple(got.shape) ==
                      (n_experts, c, d),
                      f"moe_dispatch {label} {rule} {dtype}: max |err| {err} "
                      f"({how})")
                err_max = max(err_max, err)
                print(f"moe_dispatch {label} T={tokens.shape[0]} D={d} "
                      f"E={n_experts} C={c} {dtype} {rule}: kept "
                      f"{int(kept.sum())}, repeated pairs {repeats}, max "
                      f"|err| {err!r} ({how})")
                if rule == "served":
                    cpu = moe_dispatch_ref(*(a.cpu() for a in args), n_experts,
                                           c)
                    again = moe_dispatch(*args, n_experts, c)
                    _sync(device)
                    check(torch.equal(got.cpu(), cpu) and torch.equal(got, again),
                          f"moe_dispatch {label} {rule} {dtype}: not equal bit "
                          "for bit to the plain version on a CPU copy, or to "
                          "a second call")
                    print(f"moe_dispatch {label} {dtype} {rule}: equal bit for "
                          "bit to the plain version on a CPU copy and to a "
                          "second call")
                timed[(label, dtype, rule)] = (args, c, int(kept.sum()))

    entry = None
    for label in ("prefill", "decode"):
        for dtype in (torch.bfloat16, torch.float32):
            (tokens, ids, slot_ids), c, n_kept = timed[(label, dtype, "unique")]
            t = tokens.shape[0]
            e_c = n_experts * c
            flat = torch.where(slot_ids < c, ids.long() * c + slot_ids.long(),
                               e_c)

            def library():  # one PyTorch call: index_add_ into (E·C + 1, D)
                return torch.zeros((e_c + 1, d), dtype=dtype,
                                   device=device).index_add_(0, flat, tokens)

            run = lambda: moe_dispatch(tokens, ids, slot_ids, n_experts, c)  # noqa: E731
            ms, lib_ms = time_ms(run), time_ms(library)
            in_turns = time_pair_ms(run, library)
            dev_ms = kernel_device_ms(run, MOE_KERNELS)
            queued = time_queued_ms(run)
            lib_queued = time_queued_ms(library)
            plain = time_ms(lambda: moe_dispatch_ref(tokens, ids, slot_ids,
                                                     n_experts, c),
                            runs=5, per_run=2)
            bound, bound_by = moe_bound_ms(n_kept, t, d, n_experts, c,
                                           tokens.element_size())
            print(f"timing moe_dispatch {label} T={t} D={d} E={n_experts} "
                  f"C={c} {dtype}: wrapper {ms!r} ms  kernels (device; the "
                  f"index and gather passes, or the one-launch path) "
                  f"{dev_ms!r} ms  queued on the card (with the tables' "
                  f"zero-fill) {queued!r} ms  plain {plain!r} ms  library "
                  f"(index_add_) {lib_ms!r} ms (queued {lib_queued!r})  in "
                  f"turns (wrapper, library) {in_turns!r} ms  bound "
                  f"{bound!r} ms ({bound_by})")
            if label == "decode":
                # the other path at this size: memset, index and gather
                # passes, given a workspace as above the one-launch size
                three = lambda: _three_pass(tokens, ids, slot_ids, n_experts, c)  # noqa: E731
                check(torch.equal(three(), run()), f"moe_dispatch {label} "
                      f"{dtype}: the three-pass path differs from the "
                      "one-launch path")
                print(f"timing moe_dispatch {label} {dtype} three-pass path: "
                      f"{time_ms(three)!r} ms  in turns with index_add_ "
                      f"{time_pair_ms(three, library)!r} ms  queued "
                      f"{time_queued_ms(three)!r} ms")
            if label == "prefill" and dtype == torch.bfloat16:
                entry = {
                    "name": "moe_dispatch", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
                    "replaces": "src/repro/kernels/moe_dispatch.py:36",
                    "launches": launches["moe_dispatch"],
                    "max_abs_err": err_max, "ms": ms,
                    "kernel_device_ms": dev_ms, "queued_ms": queued,
                    "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": lib_ms, "library_queued_ms": lib_queued,
                    "ms_in_turns": in_turns[0],
                    "library_ms_in_turns": in_turns[1],
                    "shape": {"T": t, "D": d, "E": n_experts, "C": c,
                              "kept": n_kept, "dtype": str(dtype)},
                    "ptxas": ptxas,
                }

    # the MLP/MoE activation as the reference rounds it (a bfloat16 rounding
    # after each step of 1 / (1 + exp(-x))) against F.silu, which rounds
    # once, at Granite's expert buffers in the prefill: what the port pays
    # in each MoE layer to give the reference's bits
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _silu

    shape = (n_experts, moe_capacity(prompt_len, top_k, n_experts,
                                     capacity_factor),
             get_config(GRANITE_ARCH).expert_d_ff_)
    g = torch.randn(shape, device=device).to(torch.bfloat16)
    print(f"timing silu {shape} bfloat16: as the reference rounds it "
          f"{time_ms(lambda: _silu(g), runs=10)!r} ms  F.silu "
          f"{time_ms(lambda: F.silu(g), runs=10)!r} ms")

    # flash_attention at Granite's prefill: GQA 24/8, Dh 64, causal
    gen = torch.Generator(device="cpu").manual_seed(5)
    flash = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = KERNEL_TOL[str(dtype)]
        q, k, v = (torch.randn((1, h, prompt_len, dh), generator=gen)
                   .to(device, dtype) for h in (hq, hkv, hkv))
        got = flash_attention(q, k, v, causal=True)
        _sync(device)
        want = attention_ref(q, k, v, causal=True)
        ok, err = _close(got, want, atol, rtol)
        check(ok and got.dtype == dtype, f"flash_attention Granite shape "
              f"{dtype}: max |err| {err} over atol {atol} rtol {rtol}")
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        print(f"flash_attention (1,{hq},{prompt_len},{dh}) Hkv {hkv} causal "
              f"{dtype}: max |err| {err!r} (atol {atol}, rtol {rtol})")
        if dtype == torch.bfloat16:
            flash.update(flash_timings(q, k, v, None))
            flash["plain_ms"] = time_ms(lambda: attention_ref(q, k, v),
                                        runs=5, per_run=1, warmup=1)
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)

            flash["library_ms"] = time_ms(sdpa, runs=10, per_run=5)
            flash["library_queued_ms"] = time_queued_ms(sdpa)
            flash["bound_ms"], flash["bound_by"] = flash_bound_ms(
                q, k, True, None, 0)
            flash["shape"] = {"B": 1, "Hq": hq, "Hkv": hkv, "T": prompt_len,
                              "S": prompt_len, "Dh": dh, "window": None,
                              "dtype": str(dtype)}
    print(f"timing flash_attention (1,{hq},{prompt_len},{dh}) Hkv {hkv} causal "
          f"bfloat16: wrapper {flash['ms']!r} ms  kernel (device) "
          f"{flash['kernel_device_ms']!r} ms  one call alone (events) "
          f"{flash['alone_ms']!r} ms  queued on the card {flash['queued_ms']!r} "
          f"ms  CUDA-core kernel {flash['cuda_core_ms']!r} ms (queued "
          f"{flash['cuda_core_queued_ms']!r})  plain {flash['plain_ms']!r} ms  "
          f"library (sdpa, is_causal, enable_gqa) {flash['library_ms']!r} ms "
          f"(queued {flash['library_queued_ms']!r})  bound {flash['bound_ms']!r} "
          f"ms ({flash['bound_by']})")
    return entry, flash


def _routing_recorder():
    """Wrap ``layers.route`` so that each MoE call's top-k expert ids are
    recorded; returns (the list they go to, a function that unwraps)."""
    from repro_torch.models import layers as L

    real, calls = L.route, []

    def recording(cfg, p, x2d):
        out = real(cfg, p, x2d)
        calls.append(out[2].sort(dim=-1).values)
        return out

    L.route = recording

    def restore():
        L.route = real

    return calls, restore


def phase_moe_model(device, arch=GRANITE_ARCH, depth=4, cfg=None,
                    prompt_len=3000, max_len=SERVE_MAX_LEN, steps=3):
    """A full-width float32 cut of Granite: (a) the moe_dispatch kernel
    against its plain version with the same attention, bit for bit; (b)
    all kernels against all plain versions, routing flips counted and the
    logits held where routing agreed in every layer."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_dispatch_ref
    from repro_torch.models import model as M

    base = cfg or get_config(arch)
    cfg = dataclasses.replace(base, n_layers=depth)
    print(f"== phase 10b: {cfg.name} at full width and depth {depth}, kernels "
          "against plain versions (float32)", flush=True)
    kernels = _lm_kernels()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = M.init(cfg, gen, device=device, dtype=torch.float32)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, prompt_len)),
                             device=device)
    feed = rng.integers(0, cfg.vocab, size=steps)

    def run(use_kernels):
        """(logits of the prefill and each decode step, routing per MoE
        call, launches by kernel)."""
        before = {k: w.launches for k, w in kernels.items()}
        calls, restore = _routing_recorder()
        try:
            logits, cache, _ = M.prefill(cfg, params, {"tokens": tokens},
                                         max_cache_len=max_len,
                                         use_kernels=use_kernels)
            outs = [logits]
            for i, tok in enumerate(feed):
                batch = {"tokens": torch.tensor([[int(tok)]], device=device),
                         "positions": torch.tensor([[prompt_len + i]],
                                                   device=device)}
                outs.append(M.decode_step(cfg, params, batch, cache,
                                          use_kernels=use_kernels)[0])
            _sync(device)
        finally:
            restore()
        return outs, calls, {k: w.launches - before[k]
                             for k, w in kernels.items()}

    n_moe = expected_launches(cfg)["moe_dispatch"][0]
    with_kernels, routes_k, launched = run(True)
    check(launched["moe_dispatch"] == n_moe * (1 + steps)
          and launched["flash_attention"] == n_moe,
          f"kernel run launched {launched}")
    # (a) the same attention (the flash kernel), the plain dispatch
    real = ops.moe_dispatch
    ops.moe_dispatch = moe_dispatch_ref
    try:
        plain_dispatch, routes_a, launched = run(True)
    finally:
        ops.moe_dispatch = real
    check(launched["moe_dispatch"] == 0, f"plain dispatch run launched {launched}")
    for i, (got, want) in enumerate(zip(with_kernels, plain_dispatch)):
        label = "prefill" if i == 0 else f"decode step {i}"
        check(torch.equal(got, want), f"{label}: the moe_dispatch kernel and "
              "its plain version give different logits with the same attention")
    print(f"{cfg.name} depth {depth}: moe_dispatch kernel vs plain version, "
          f"same attention: prefill and {steps} decode steps' logits equal bit "
          "for bit")
    # (b) every kernel against every plain version
    plain, routes_p, launched = run(False)
    check(sum(launched.values()) == 0, f"plain run launched {launched}")
    # routing: one (N, k) record per MoE call, prefill's first
    differ = [(a != b).any(dim=-1) for a, b in zip(routes_k, routes_p)]
    n_choices = sum(x.numel() for x in differ)
    n_flips = int(sum(int(x.sum()) for x in differ))
    print(f"routing: {n_flips} of {n_choices} (token, layer) choices differ "
          f"between kernels and plain versions")
    check(n_flips <= ROUTING_FLIPS_MAX * n_choices,
          f"{n_flips} of {n_choices} routing choices differ, over "
          f"{ROUTING_FLIPS_MAX:.0%}")
    atol, rtol = MODEL_TOL
    for i, (got, want) in enumerate(zip(with_kernels, plain)):
        label = "prefill" if i == 0 else f"decode step {i}"
        # the MoE calls of this forward, one per layer
        flips = torch.stack(differ[i * depth:(i + 1) * depth]).any(dim=0)
        agreed = ~flips
        ok, err = _close(got[0][agreed], want[0][agreed], atol, rtol)
        check(ok and bool(torch.isfinite(got).all()),
              f"{label}: max |err| {err} over atol {atol} rtol {rtol} at the "
              "positions whose routing agreed")
        print(f"{cfg.name} depth {depth}, {label} logits {tuple(got.shape)}: "
              f"routing agreed at {int(agreed.sum())} of {agreed.numel()} "
              f"positions; there kernels vs plain max |err| {err!r} (atol "
              f"{atol}, rtol {rtol}; max |logit| {float(want.abs().max())!r})")
    del params


# ---------------------------------------------------------------------------
# the LM training path
# ---------------------------------------------------------------------------

class _Tee:
    """Standard output that is also kept, line by line."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, s):
        self.out.write(s)
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines += done
        return len(s)

    def flush(self):
        self.out.flush()


def _train_argv(arch, reduced, steps, batch, seq, *extra):
    return ["--arch", arch, *(["--reduced"] if reduced else []),
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--log-every", "1", "--seed", "0", *extra]


def _recording_step(records, device, profile_step=None):
    """A ``wrap_step`` for ``launch.train.main``: each step's wall
    (synchronized before and after), batch and metrics are recorded, and
    step ``profile_step`` runs under ``torch.profiler``."""

    def wrap(step_fn):
        def run(state, batch):
            index = len(records) + 1
            prof = None
            _sync(device)
            t0 = time.perf_counter()
            if index == profile_step:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, metrics = step_fn(state, batch)
                    _sync(device)
            else:
                state, metrics = step_fn(state, batch)
                _sync(device)
            records.append({"s": time.perf_counter() - t0, "profile": prof,
                            "batch": {k: v.cpu().numpy() for k, v in batch.items()},
                            "loss": _metric(metrics["loss"]),
                            "grad_norm": _metric(metrics["grad_norm"])})
            return state, metrics
        return run
    return wrap


def _metric(t) -> float:
    """A step metric's value (on a mesh a replicated DTensor)."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _run_launcher(argv, records, device, profile_step=None):
    """``repro_torch.launch.train.main(argv)`` in this process: (its final
    state, the lines it printed)."""
    import contextlib

    from repro_torch.launch import train as launch_train

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        state = launch_train.main(
            argv, wrap_step=_recording_step(records, device, profile_step))
    return state, tee.lines


def train_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 6 · parameters · tokens, plus the
    causal attention's 6 · layers · B · T² · heads · head dim."""
    n_attn = sum(b.mixer == "attn" for b in list(cfg.pattern) * cfg.n_groups
                 + list(cfg.tail))
    return (6 * cfg.n_params() * batch * seq
            + 6 * n_attn * batch * seq ** 2 * cfg.n_heads * cfg.head_dim_)


def chunked_attention_step_ms(device, cfg, batch, seq):
    """The float32 chunked attention's device time in one training step,
    measured alone at the step's shapes: (forward ms, forward and backward
    ms, a step's ms: each attention layer's forward and backward plus the
    forward that remat runs again)."""
    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device=device).manual_seed(5)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = (torch.randn((batch, h, seq, Dh), generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_()
               for h in (H, Hkv, Hkv))
    grad = torch.randn((batch, H, seq, Dh), generator=gen, device=device,
                       dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            L.chunked_attention(q, k, v, True, None, 0)

    def fwd_bwd():
        L.chunked_attention(q, k, v, True, None, 0).backward(grad)

    f = time_ms(fwd, runs=5, per_run=1, warmup=1)
    fb = time_ms(fwd_bwd, runs=5, per_run=1, warmup=1)
    layers = sum(b.mixer == "attn" for b in list(cfg.pattern) * cfg.n_groups
                 + list(cfg.tail))
    return f, fb, layers * (fb + f)


def phase_training(device, arch=TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Phase 11a: ``arch`` trained through ``repro_torch.launch.train`` at
    full width and depth, bf16 compute over float32 masters, remat on, the
    geo-planned ingest on; checks finite, falling losses and peak memory,
    prints step walls, tokens/s, ``train_mfu`` and a profiled warm step."""
    import math

    import torch
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    print(f"== phase 11a: training {cfg.name} through repro_torch.launch.train "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.n_params() / 1e9:.3f} B parameters; batch {batch} x {seq}, "
          f"{steps} AdamW steps, bf16 compute, float32 masters, remat)",
          flush=True)
    if device.type == "cuda":
        _sync(device)  # a CUDA context first, where this phase runs alone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    from repro_torch.kernels.segment_reduce import segment_sum

    kernels = dict(_lm_kernels(), segment_sum=segment_sum)
    records = []
    argv = _train_argv(arch, reduced, steps, batch, seq, "--dtype", "bfloat16",
                       "--remat", "--warmup", "2", "--lr", "3e-4",
                       "--geo-ingest", "--device", str(device))
    for w in kernels.values():
        w.launches = 0
    t = time.perf_counter()
    state, lines = _run_launcher(argv, records, device,
                                 profile_step=steps if device.type == "cuda" else None)
    wall = time.perf_counter() - t
    launches = {k: w.launches for k, w in kernels.items()}
    check(not any(launches.values()),
          f"the training path launched a kernel: {launches}")
    print(f"kernel launches while training: {launches}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    logged = [dict(f.split("=") for f in line.split()[2:])
              for line in lines if line.startswith("step ")]
    check(len(logged) == steps == len(records),
          f"{len(logged)} step lines and {len(records)} steps, wanted {steps}")
    check(any(line.startswith("[ingest] planned=") for line in lines),
          "no [ingest] line: the geo-planned ingest did not run")
    check(lines[-1] == "[train] done", f"last line {lines[-1]!r}")
    losses = [float(x["loss"]) for x in logged]
    gnorms = [float(x["gnorm"]) for x in logged]
    check(all(map(math.isfinite, losses + gnorms)),
          f"a loss or grad norm is not finite: {losses} {gnorms}")
    first, last_two = records[0]["loss"], statistics.mean(
        r["loss"] for r in records[-2:])
    check(last_two < first, f"loss did not fall: first {first}, mean of the "
          f"last two {last_two}")
    check(peak < CARD_BYTES, f"peak device memory {peak / 1e9} GB over "
          f"{CARD_BYTES / 1e9} GB")
    n_state = sum(a.numel() * a.element_size()
                  for a in _leaves({"p": state.params, "m": state.opt.m,
                                    "v": state.opt.v}))
    warm = [r["s"] for r in records[1:] if r["profile"] is None]
    median = statistics.median(warm) if warm else records[0]["s"]
    flops = train_flops(cfg, batch, seq)
    print(f"losses {[r['loss'] for r in records]!r}")
    print(f"grad norms {[r['grad_norm'] for r in records]!r}")
    print(f"first step {records[0]['s']!r} s; warm steps {warm!r} s, median "
          f"{median!r} s; {batch * seq / median!r} tokens/s; launcher wall "
          f"{wall!r} s")
    print(f"train_mfu {flops / median / BF16_OPS_PER_S!r} ({flops / 1e12!r} "
          f"TFLOP a step over {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16); peak "
          f"device memory {peak / 1e9!r} GB; params + moments {n_state / 1e9!r} GB")
    prof = records[-1]["profile"]
    if prof is not None:
        busy_us, n, by_name = device_activity(prof)
        total = sum(by_name.values())
        print(f"profile of warm step {steps}: wall {records[-1]['s']!r} s "
              f"(profiled), device busy {busy_us / 1e6!r} s, busy share "
              f"{busy_us / 1e6 / records[-1]['s']!r} of the profiled wall and "
              f"{busy_us / 1e6 / median!r} of the warm median step, device "
              f"events {n}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {us / 1e3:10.3f} ms  {us / total:6.1%}  {name[:110]}")
        f, fb, per_step = chunked_attention_step_ms(device, cfg, batch, seq)
        print(f"chunked_attention (float32) at ({batch}, {cfg.n_heads}, {seq}, "
              f"{cfg.head_dim_}) alone: forward {f!r} ms, forward+backward "
              f"{fb!r} ms; a step's share (layers x (forward+backward + the "
              f"remat forward)) {per_step!r} ms, {per_step / 1e3 / median!r} "
              "of the warm median step")


def _grads(cfg, params, batch):
    """(float32 loss, {path: grad}) of ``loss_fn`` in float32."""
    import torch
    from repro_torch.models import model as M

    leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(cfg, leaves, batch)
    paths, flat = [], []
    M._tree_map(lambda p, a: (paths.append(p), flat.append(a)), leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), dict(zip(paths, grads))


def phase_training_float32_cut(device, arch=TRAIN_ARCH, depth=2, seq=256,
                               reduced=False):
    """Phase 11b: a full-width cut of ``arch`` to ``depth`` layers, float32
    (no TF32): ``loss_fn`` and every gradient on the card against the same
    on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.set_float32_matmul_precision("highest")
    base = get_config(arch).reduced() if reduced else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=depth)
    print(f"== phase 11b: {cfg.name} at full width and depth {depth}, loss and "
          f"gradients on the card against the CPU (float32, B=1, T={seq})",
          flush=True)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(3),
                    device=device)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(1, seq + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    on_card = {k: v.to(device) for k, v in batch.items()}
    loss, grads = _grads(cfg, params, on_card)
    cpu = torch.device("cpu")
    want_loss, want = _grads(cfg, M.cast_params(params, torch.float32, cpu),
                             batch)
    check(bool(torch.isfinite(loss)) and abs(float(loss) - float(want_loss))
          <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
          f"loss {float(loss)} on the card, {float(want_loss)} on the CPU")
    worst = 0.0
    for path, g in grads.items():
        w = want[path]
        if w is None or g is None:
            check(w is None and g is None, f"{path}: reached on one side only")
            continue
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        check(err <= TRAIN_GRAD_TOL * scale,
              f"{'/'.join(path)}: gradient max |err| {err} over "
              f"{TRAIN_GRAD_TOL} x {scale}")
        worst = max(worst, err / scale)
    print(f"loss card {float(loss)!r} cpu {float(want_loss)!r} (rtol "
          f"{TRAIN_LOSS_RTOL}); {len(grads)} gradient leaves, worst max |err| "
          f"{worst!r} of the leaf's largest entry (bar {TRAIN_GRAD_TOL})")
    del params, grads


def phase_checkpoint_resume(device, arch=TRAIN_ARCH):
    """Phase 11c: the reduced config on the card, 4 steps with checkpoints
    every 2, then on to 6 with ``--resume auto``: the restored state equals
    the first run's last one bit for bit, and the resumed run starts at the
    batch of step 4."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.train.checkpoint import CheckpointManager, _leaf_paths

    cfg = get_config(arch).reduced()
    print(f"== phase 11c: checkpoint and resume through the launcher "
          f"({cfg.name} reduced, on {device})", flush=True)
    batch, seq = 4, 64
    with tempfile.TemporaryDirectory() as d:
        common = ["--ckpt-dir", d, "--ckpt-every", "2", "--device", str(device)]
        first, _ = _run_launcher(_train_argv(arch, True, 4, batch, seq, *common),
                                 [], device)
        mgr = CheckpointManager(d)
        check(mgr.steps() == [2, 4], f"committed steps {mgr.steps()}")
        restored, _, step = mgr.restore(None, first)
        check(step == 4, f"restored step {step}")
        want = _leaf_paths(first)
        for path, a in _leaf_paths(restored).items():
            check(a.device == want[path].device and a.dtype == want[path].dtype
                  and torch.equal(a, want[path]),
                  f"{path}: restored differs from the saved state")
        records = []
        _, lines = _run_launcher(_train_argv(arch, True, 6, batch, seq,
                                             "--resume", "auto", *common),
                                 records, device)
        check("[resume] restored committed step 4" in lines,
              f"no resume line in {lines[:3]}")
        next_batch = synthetic_lm_batch(cfg.vocab, batch, seq, 4, seed=0)
        check(len(records) == 2 and all(
            np.array_equal(records[0]["batch"][k], v)
            for k, v in next_batch.items()),
            "the resumed run's first batch is not the batch of step 4")
        check(mgr.steps() == [2, 4, 6], f"committed steps {mgr.steps()}")
    print(f"{len(want)} leaves restored bit for bit at step 4; resumed at the "
          "batch of step 4; committed steps [2, 4, 6]")


def _grad_guard_calls(device):
    """Each kernel's wrapper on small CUDA inputs that require grad."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).requires_grad_()

    ids = torch.tensor([0, 2, 2, 1], dtype=torch.int32, device=device)
    from repro_torch.kernels.segment_reduce import segment_sum

    kernels = dict(_lm_kernels(), segment_sum=segment_sum)
    return {
        "segment_sum": lambda: kernels["segment_sum"](r(4, 3), ids, 4),
        "flash_attention": lambda: kernels["flash_attention"](
            r(1, 4, 64, 64), r(1, 2, 64, 64), r(1, 2, 64, 64)),
        "mamba_scan": lambda: kernels["mamba_scan"](
            r(1, 8, 32), r(1, 8, 32).detach().abs().requires_grad_(),
            -r(32, 4).detach().abs().requires_grad_(), r(1, 8, 4), r(1, 8, 4),
            r(32)),
        "rglru_scan": lambda: kernels["rglru_scan"](
            r(1, 8, 128), r(1, 8, 128).detach().sigmoid().requires_grad_()),
        "moe_dispatch": lambda: kernels["moe_dispatch"](r(4, 64), ids, ids, 4, 4),
    }


def phase_grad_guard(device):
    """Phase 11d: every kernel wrapper refuses a CUDA input that requires
    grad under autograd (its output would carry no ``grad_fn``)."""
    import torch

    print("== phase 11d: the kernel wrappers refuse inputs that require grad",
          flush=True)
    for name, call in _grad_guard_calls(device).items():
        with torch.enable_grad():
            try:
                call()
            except RuntimeError as exc:
                check("no backward" in str(exc), f"{name}: raised {exc}")
                print(f"{name}: raises ({exc})")
                continue
        fail(f"{name} launched on an input that requires grad")


# ---------------------------------------------------------------------------
# multi-job schedules and online control (phase 12)
# ---------------------------------------------------------------------------

def tenant_fractions(g, n_sources=8):
    """Job ``g``'s input layout: 35% at sources g and g+4, 5% at each of the
    other six (a data-centre-local layout: the tenants collide on
    different links)."""
    import numpy as np

    frac = np.full(n_sources, 0.05)
    frac[[g % n_sources, (g + 4) % n_sources]] = 0.35
    return frac


def split_by_fractions(keys, values, fractions):
    """Per-source record sets holding ``fractions`` of the corpus, in order."""
    import numpy as np

    cuts = np.round(np.cumsum(fractions)[:-1] * keys.shape[0]).astype(int)
    return list(zip(np.split(keys, cuts), np.split(values, cuts)))


def recording_ema(base):
    """A ``SolveTimeEMA`` subclass that keeps every estimator made (in
    ``made``) and each solve time it observed (in ``observed``): the
    online loop's charge, read from outside."""

    class RecordingEMA(base):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.observed = []
            RecordingEMA.made.append(self)

        def observe(self, seconds, compiled=False):
            self.observed.append((seconds, compiled))
            super().observe(seconds, compiled)

    return RecordingEMA


def worst_slowdown(result, solo):
    return max(r.makespan / s for r, s in zip(result.results, solo))


def tenant_jobs(device, n_jobs=SCHED_JOBS, n_docs=N_DOCS,
                words_per_doc=WORDS_PER_DOC, vocab=VOCAB):
    """12a's tenants on the 8-DC platform, each on its own Zipf corpus and
    calibrated; returns (jobs, per-source record sets, numpy's counts)."""
    import numpy as np
    from repro_torch.api import GeoJob
    from repro_torch.core import Substrate, planetlab_platform
    from repro_torch.mapreduce.apps import generate_documents, word_count

    sub = Substrate.of(planetlab_platform(8, alpha=1.0, seed=0))
    wc = word_count(device=device)
    jobs, per_source, expect = [], [], []
    for g in range(n_jobs):
        keys, vals = generate_documents(n_docs=n_docs,
                                        words_per_doc=words_per_doc,
                                        vocab=vocab, seed=g + 1)
        expect.append(np.unique(vals & COUNT_MASK, return_counts=True))
        frac = tenant_fractions(g, sub.nS)
        per_source.append(split_by_fractions(keys, vals, frac))
        view = sub.view(frac * keys.shape[0] * wc.record_bytes / 1e6, 1.0,
                        name=f"tenant{g}")
        jobs.append(GeoJob(view, wc, device=device).calibrate(per_source[-1]))
    return jobs, per_source, expect


def phase_schedule(device, n_docs=N_DOCS, words_per_doc=WORDS_PER_DOC,
                   vocab=VOCAB, n_restarts=N_RESTARTS, steps=STEPS,
                   n_jobs=SCHED_JOBS):
    """Phase 12a: four word-count tenants on the 8-DC platform through
    ``GeoSchedule``; returns (jobs, per_source, joint schedule, launches)."""
    import numpy as np
    import torch
    from repro_torch.api import GeoSchedule
    from repro_torch.core import BARRIERS_GGL, makespan
    from repro_torch.core.plan import validate_plan
    from repro_torch.kernels.segment_reduce import segment_sum

    print(f"== phase 12a: a {n_jobs}-tenant schedule (GeoSchedule word count)",
          flush=True)
    t0 = time.perf_counter()
    jobs, per_source, expect = tenant_jobs(device, n_jobs, n_docs,
                                           words_per_doc, vocab)
    print(f"corpora and calibration: {n_jobs} x {words_per_doc * n_docs} "
          f"words in {time.perf_counter() - t0:.3f} s; alpha "
          f"{[j.platform.alpha for j in jobs]!r}")

    def plan(policy, objective, steps=steps):
        sched = GeoSchedule(jobs, device=device)
        t = time.perf_counter()
        sched.plan(policy, barriers=BARRIERS_GGL, n_restarts=n_restarts,
                   steps=steps, objective=objective)
        return sched, time.perf_counter() - t

    launches = 0
    results = {}
    for policy, objective in SCHED_POLICIES:
        sched, wall = plan(policy, objective)
        for job in sched.jobs:
            validate_plan(job.planned.plan.x, job.planned.plan.y)
        t = time.perf_counter()
        sim = sched.simulate()
        sim_wall = time.perf_counter() - t
        segment_sum.launches = 0
        t = time.perf_counter()
        report = sched.execute(per_source)
        _sync(device)
        exec_wall = time.perf_counter() - t
        launched = segment_sum.launches
        launches += launched
        nonempty = sum(1 for job in report.jobs for k, _ in job.outputs
                       if k.shape[0])
        check(launched >= nonempty,
              f"{policy}/{objective}: {launched} segment_sum launches for "
              f"{nonempty} non-empty reducers")
        for g, (job, (ek, ec)) in enumerate(zip(report.jobs, expect)):
            k = np.concatenate([k for k, _ in job.outputs])
            v = np.concatenate([v for _, v in job.outputs])
            order = np.argsort(k, kind="stable")
            check(np.array_equal(k[order], ek) and np.array_equal(v[order], ec),
                  f"{policy}/{objective}: tenant {g}'s word counts differ "
                  "from the numpy count")
        for name, value in (("modeled", report.makespan_modeled),
                            ("simulated", sim.makespan_sim),
                            ("measured", report.makespan_measured)):
            check(np.isfinite(value), f"{policy}: {name} makespan {value}")
        results[policy, objective] = sched.planned
        print(f"{policy:12s} {objective:17s} plan {wall:.3f} s  modeled "
              f"{report.makespan_modeled!r} s  simulated {sim.makespan_sim!r}"
              f" s  measured {report.makespan_measured!r} s  per job modeled "
              f"{[r.makespan for r in sched.planned.results]!r}  simulate "
              f"{sim_wall:.3f} s  execute {exec_wall:.3f} s  segment_sum "
              f"launches {launched} "
              f"(non-empty reducers {nonempty})")
        if (policy, objective) == ("joint", "makespan"):
            joint, first = sched, wall
    check(launches > 0, "the schedule path never launched segment_sum")
    check(results["joint", "makespan"].makespan
          <= results["independent", "makespan"].makespan,
          "joint's modeled aggregate is worse than independent's")
    indep = results["independent", "makespan"]
    solo = [makespan(j.platform, r.plan, BARRIERS_GGL)
            for j, r in zip(jobs, indep.results)]
    worst = {key: worst_slowdown(results[key], solo) for key in results}
    check(worst["joint", "min_max_slowdown"]
          <= worst["independent", "makespan"],
          "min_max_slowdown's worst slowdown is worse than independent's")
    print(f"worst slowdown (contended over sole-tenant makespan of the "
          f"independent plan): {({'/'.join(k): v for k, v in worst.items()})!r}"
          f"; min_max_slowdown <= makespan objective's: "
          f"{worst['joint', 'min_max_slowdown'] <= worst['joint', 'makespan']}")
    _, warm = plan("joint", "makespan")
    print(f"joint solve {n_restarts}x{steps}, {n_jobs} jobs: first {first:.3f}"
          f" s, warm {warm:.3f} s")
    if device.type == "cuda":  # 50 steps, as phase 4: a profile's
        # post-processing grows with its host events
        from torch.profiler import ProfilerActivity, profile

        plan("joint", "makespan", steps=PROFILE_STEPS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            plan("joint", "makespan", steps=PROFILE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy_us, n_events, _ = device_activity(prof)
        label = f"joint solve profile {n_restarts}x{PROFILE_STEPS}"
        if n_events:
            print(f"{label}: wall {wall!r} s  device busy {busy_us / 1e6!r} s"
                  f"  busy share {busy_us / 1e6 / wall!r}  device events "
                  f"{n_events} ({n_events / PROFILE_STEPS!r} per step, the "
                  "independent solve's included)")
        else:
            print(f"{label}: wall {wall!r} s, device time not measured (the "
                  "profiler recorded no device activity)")
    return jobs, joint, launches


def traced_online_setup(jobs, joint):
    """Phase 12b's substrate and traffic, fixed by the frozen joint plan:
    the two shuffle links carrying most of its traffic into its busiest
    reducer step down 250x at half its simulated makespan, a fifth job
    (job 0's layout rotated by 2) arrives at a quarter of it, and the
    mapper with the most planned map input dies at 40% of it."""
    import numpy as np
    from repro_torch.api import GeoJob
    from repro_torch.core import (BARRIERS_GGL, CapacityTrace, FailureEvent,
                                  SimConfig)
    from repro_torch.core.makespan import analytic_volumes

    frozen = joint.simulate().makespan_sim
    sub = joint.substrate
    plans = joint.planned.plans  # the jobs' own results are the last plan's
    vols = [analytic_volumes(j.platform.D, plan.x, plan.y, j.platform.alpha,
                             xp=np) for j, plan in zip(jobs, plans)]
    shuffle = sum(v[2] for v in vols)
    busiest = int(np.argmax(shuffle.sum(axis=0)))
    links = [int(m) for m in np.argsort(shuffle[:, busiest])[::-1][:2]]
    mapper = int(np.argmax(sum(v[1] for v in vols)))
    t_drift, t_arrival, t_fail = 0.5 * frozen, 0.25 * frozen, 0.4 * frozen
    traced = sub.with_traces({
        f"shuffle[m{m}->r{busiest}]": CapacityTrace.step(
            float(sub.B_mr[m, busiest]), float(sub.B_mr[m, busiest]) / 250.0,
            t_drift)
        for m in links
    })
    tjobs = [GeoJob(traced.view(j.platform.D, j.platform.alpha,
                                name=j.platform.name), device=j.device)
             .with_plan(plan, BARRIERS_GGL) for j, plan in zip(jobs, plans)]
    p0 = jobs[0].platform
    late = traced.view(np.roll(p0.D, 2), p0.alpha, name="late")
    cfg = SimConfig(barriers=BARRIERS_GGL,
                    failures=[FailureEvent.mapper_kill(mapper, t_fail)])
    print(f"frozen joint schedule simulated {frozen!r} s; shuffle links "
          f"m{links}->r{busiest} step down 250x at {t_drift!r} s; a fifth "
          f"job arrives at {t_arrival!r} s; mapper {mapper} dies at "
          f"{t_fail!r} s")
    return traced, tjobs, late, t_arrival, cfg, frozen


def stack_never_rises(decisions):
    """Whether, at every decision point where a shared stack was adopted,
    the stack's largest modeled remaining did not rise."""
    groups = {}
    for d in decisions:
        if d.action != "inject":
            groups.setdefault((d.time, d.event), []).append(d)
    return all(
        max(d.modeled_after for d in group)
        <= max(d.modeled_before for d in group)
        for group in groups.values() if any(d.action == "swap" for d in group)
    )


def phase_online(device, jobs, joint, n_restarts=ONLINE_RESTARTS,
                 steps=ONLINE_STEPS):
    """Phase 12b: ``run_online`` under every built-in policy, with the
    measured solve charge; then a 20-job incremental co-replan."""
    import numpy as np
    import repro_torch.api as api
    from repro_torch.api import Arrival, GeoJob, GeoSchedule
    from repro_torch.core import (BARRIERS_GGL, OnlineConfig, SimConfig,
                                  available_online_policies, get_online_config,
                                  open_schedule, replan_schedule,
                                  simulate_schedule, solver_cache_stats)
    from repro_torch.core.optimize import _INCREMENTAL_STACK_CAP
    from repro_torch.core.plan import validate_plan

    print("== phase 12b: online control (run_online, every built-in policy)",
          flush=True)
    traced, tjobs, late, t_arrival, cfg, frozen = traced_online_setup(
        jobs, joint)
    sched = GeoSchedule(tjobs, device=device).with_plans()
    late_job = GeoJob(late, device=device)

    real_ema = api.SolveTimeEMA
    api.SolveTimeEMA = recorded = recording_ema(real_ema)

    def run(policy):
        extra = ({"replan_dt": 0.1 * frozen}
                 if policy.startswith("horizon") else {})
        recorded.made.clear()
        calls = solver_cache_stats()["calls"]
        t = time.perf_counter()
        report = sched.run_online(
            policy, arrivals=[Arrival(late_job, t_arrival)], cfg=cfg,
            n_restarts=n_restarts, steps=steps, **extra)
        wall = time.perf_counter() - t
        return (report, wall, solver_cache_stats()["calls"] - calls,
                recorded.made[0])

    try:
        runs = {policy: run(policy) for policy in available_online_policies()}
    finally:
        api.SolveTimeEMA = real_ema
    reports = {}
    for policy, (report, wall, solves, ema) in runs.items():
        reports[policy] = report
        warm = [s for s, compiled in ema.observed if not compiled]
        cold = [s for s, compiled in ema.observed if compiled]
        for value in (report.makespan_online, report.makespan_static):
            check(np.isfinite(value), f"{policy}: makespan {value}")
        for plan in report.plans:
            validate_plan(plan.x, plan.y)
        print(f"{policy:21s} wall {wall:.3f} s  online "
              f"{report.makespan_online!r} s  static "
              f"{report.makespan_static!r} s  decisions "
              f"{len(report.decisions)}  swaps {len(report.swaps)}  rejects "
              f"{len(report.rejected)}  solver calls {solves}  warm solve s "
              f"{warm!r}  first-call solve s {cold!r}  EMA charge "
              f"{ema.charge_s()!r} s  charged {report.charged_s!r} s")
        if get_online_config(policy).shared:
            check(stack_never_rises(report.decisions),
                  f"{policy}: an adopted stack's modeled remaining rose")
            continue
        worse = [d for d in report.swaps
                 if d.modeled_after >= d.modeled_before]
        check(all(d.time >= cfg.failures[0].time for d in worse),
              f"{policy}: a swap before the failure is modeled worse: "
              f"{worse}")
        if worse:
            print(f"  {len(worse)} swaps at or after the failure are modeled "
                  "worse than 'before', which is priced on the live view "
                  "while 'after' is priced with the dead mapper collapsed "
                  "(the reference's record)")
    static = reports["static"]
    entries = [(j.platform, j.planned.plan, cfg) for j in sched.jobs]
    frozen_sim = simulate_schedule(
        entries + [(late, late_job.planned.plan,
                    dataclasses.replace(cfg, start_time=t_arrival))],
        substrate=traced)
    check(static.sim.as_dict() == frozen_sim.as_dict()
          and static.static_sim.as_dict() == frozen_sim.as_dict(),
          "static differs from the frozen simulate_schedule")
    calls = solver_cache_stats()["calls"]
    inert = sched.run_online(
        "reactive", arrivals=[Arrival(late_job, t_arrival)], cfg=cfg,
        n_restarts=n_restarts, steps=steps,
        online=OnlineConfig(shared=True, hysteresis=float("inf")))
    check(solver_cache_stats()["calls"] == calls,
          "hysteresis=inf called a solver")
    a, b = inert.as_dict(), static.as_dict()
    a.pop("policy"), b.pop("policy")
    check(json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True),
          "reactive with hysteresis=inf differs from static")
    print("static equals the frozen simulate_schedule; reactive with "
          "hysteresis=inf equals static in as_dict() and called no solver")

    # the 20-job co-replan: five copies of the four layouts, mid-run
    crowd = [(traced.view(j.platform.D, j.platform.alpha,
                          name=f"{j.platform.name}/{c}"), j.planned.plan,
              SimConfig(barriers=BARRIERS_GGL))
             for c in range(5) for j in tjobs]
    eng = open_schedule(crowd, substrate=traced)
    eng.run_until(0.1 * frozen)
    snap = eng.snapshot()
    live = [jp for jp in snap.jobs if not jp.done]
    check(len(live) > _INCREMENTAL_STACK_CAP,
          f"{len(live)} live jobs: not past the stack cap")
    t = time.perf_counter()
    res = replan_schedule(traced.at(snap.time), [e[1] for e in crowd], snap,
                          barriers=BARRIERS_GGL, n_restarts=n_restarts,
                          steps=steps, incremental=True, device=device)
    _sync(device)
    wall = time.perf_counter() - t
    check(res.makespan <= max(res.before), "the co-replan is modeled worse")
    changed = sum(p is not e[1] for p, e in zip(res.plans, crowd))
    print(f"replan_schedule incremental, {len(live)} live jobs (stack cap "
          f"{_INCREMENTAL_STACK_CAP}): {wall:.3f} s  modeled remaining "
          f"{max(res.before)!r} -> {res.makespan!r} s  plans changed "
          f"{changed}")
    return sched, late_job, t_arrival, cfg


def _held(label, got, want, atol, rtol=0.0):
    """max |got - want| of two tensors, after checking it is within
    ``atol + rtol·|want|``."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    err = (got - want).abs()
    check(bool(torch.all(err <= atol + rtol * want.abs())),
          f"{label}: max |err| {float(err.max())} over atol {atol} rtol "
          f"{rtol}")
    return float(err.max())


def phase_card_vs_cpu(device, jobs, joint, sched, late_job, t_arrival, cfg,
                      steps=25):
    """Phase 12c: the three schedule solvers for ``steps`` steps from the
    same logits on the card and on the CPU, then ``reactive_shared`` with
    the charge pinned on both devices."""
    import numpy as np
    import torch
    from repro_torch.api import Arrival, GeoSchedule
    from repro_torch.core import (BARRIERS_GGL, JobProgress, get_online_config,
                                  makespan, open_schedule, uniform_plan)
    from repro_torch.core import optimize as O

    print("== phase 12c: the schedule solvers on the card against the CPU",
          flush=True)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    sub = joint.substrate
    J, nS, nM, nR = len(jobs), sub.nS, sub.nM, sub.nR
    R = N_RESTARTS
    D = np.stack([j.platform.D for j in jobs])
    refs = [makespan(j.platform, r.plan, BARRIERS_GGL)
            for j, r in zip(jobs, joint.planned.results)]
    # the temperature's unit as the joint policy sets it: job 0's uniform
    # plan; the joint plan's own makespan is a sharper one, run unchecked
    scales = {"uniform": makespan(jobs[0].platform,
                                  uniform_plan(jobs[0].platform),
                                  BARRIERS_GGL),
              "planned": refs[0]}
    joint_in = [D, [j.platform.alpha for j in jobs], sub.B_sm, sub.B_mr,
                sub.C_m, sub.C_r, rng.normal(0, 1.5, size=(R, J, nS, nM)),
                rng.normal(0, 1.5, size=(R, J, nR)), scales["uniform"], refs]
    kappa = max(1e-3 * float(D.sum()) / nM, 1e-9)
    eng = open_schedule([(j.platform, j.planned.plan, cfg) for j in sched.jobs],
                        substrate=sched.substrate)
    eng.run_until(t_arrival)
    progs = [jp for jp in eng.snapshot().jobs if not jp.done]
    check(len(progs) == J, "a job finished before the snapshot")
    caps = [np.stack([O._degraded_caps(sub, jp)[c] for jp in progs])
            for c in range(4)]
    spans = O.score_residual_shared(sub, progs,
                                    [j.planned.plan for j in sched.jobs],
                                    BARRIERS_GGL)
    Rr = ONLINE_RESTARTS
    resid = list(JobProgress.stack(progs))
    alpha = [jp.alpha for jp in progs]
    lx, ly = rng.normal(0, 1.5, size=(Rr, J, nS, nM)), \
        rng.normal(0, 1.5, size=(Rr, J, nR))
    # the shared solve's inputs as replan_schedule builds them for 4 live
    # jobs (all annealed, so no background demand; kappa from the
    # residual, in half-decade buckets)
    shapes = ((nS, nM), (nM,), (nM, nR), (nR,))
    kappa_r = max(1e-3 * sum(jp.remaining_mb()["reduce"] for jp in progs)
                  / nM, 1e-9)
    kappa_r = float(10.0 ** (round(np.log10(kappa_r) * 2.0) / 2.0))

    def joint_solve(dev):
        return O._solve_joint_batch(
            *(O._f32(a, dev) for a in joint_in), kappa=kappa,
            barriers=BARRIERS_GGL, steps=steps)

    def batch_solve(dev):
        t = lambda a: O._f32(a, dev)  # noqa: E731
        return O._solve_residual_batch_many(
            tuple(map(t, resid)), tuple(map(t, caps)), t(alpha),
            t(lx.swapaxes(0, 1)), t(ly.swapaxes(0, 1)), t(spans),
            barriers=BARRIERS_GGL, steps=steps)

    def shared_solve(dev, bg, kappa=kappa_r):
        t = lambda a: O._f32(a, dev)  # noqa: E731
        return O._solve_residual_shared_batch(
            tuple(map(t, resid)), tuple(map(t, caps)), t(alpha),
            tuple(map(t, bg)), t(lx), t(ly), t(max(spans)), kappa=kappa,
            barriers=BARRIERS_GGL, steps=steps)

    def diff(solve, *args):
        return [(a.cpu() - b).abs().max().item()
                for a, b in zip(solve(device, *args), solve(cpu, *args))]

    no_bg = [np.zeros(shape) for shape in shapes]
    for name, solve, args in (
            ("_solve_joint_batch", joint_solve, ()),
            ("_solve_residual_batch_many", batch_solve, ()),
            ("_solve_residual_shared_batch", shared_solve, (no_bg,))):
        (gx, gy, ge), (wx, wy, we) = solve(device, *args), solve(cpu, *args)
        errs = (_held(f"{name} x", gx, wx, 1e-4),
                _held(f"{name} y", gy, wy, 1e-4),
                _held(f"{name} exact", ge, we, 0.0, 1e-4))
        print(f"{name} {steps} steps, card against CPU: max |err| x "
              f"{errs[0]!r}, y {errs[1]!r}, exact {errs[2]!r} (x, y atol "
              "1e-4; exact rtol 1e-4)")
    # findings, not checks: inputs no path builds, where more gradient
    # entries sit at rounding level (Adam's g/sqrt(v) scales each to a
    # full step whatever its size)
    joint_in[8] = scales["planned"]
    print(f"unchecked: _solve_joint_batch {steps} steps at the joint plan's "
          f"makespan as the temperature unit ({scales['planned']!r} s, the "
          f"policy's is {scales['uniform']!r} s), card against CPU: max "
          f"|err| x, y, exact {diff(joint_solve)!r}")
    busy = [rng.uniform(0.0, 50.0, size=shape) for shape in shapes]
    for kappa in (kappa_r, 10.0 ** 0.5):
        print(f"unchecked: _solve_residual_shared_batch {steps} steps with a "
              f"random background demand (U(0, 50) MB a resource), kappa "
              f"{kappa!r} MB (the path's is {kappa_r!r}), card against CPU: "
              f"max |err| x, y, exact {diff(shared_solve, busy, kappa)!r}")

    pinned = dataclasses.replace(get_online_config("reactive_shared"),
                                 solver_cost_s=1.0)
    timelines = {}
    for dev in (device, cpu):
        t = time.perf_counter()
        report = GeoSchedule(sched.jobs, device=dev).with_plans().run_online(
            "reactive_shared", arrivals=[Arrival(late_job, t_arrival)],
            cfg=cfg, online=pinned)
        timelines[dev.type] = report
        print(f"reactive_shared on {dev.type} (charge pinned to 1 s): wall "
              f"{time.perf_counter() - t:.3f} s  online "
              f"{report.makespan_online!r} s")
        print(report.timeline())
    card, host = timelines[device.type], timelines["cpu"]
    key = lambda d: (d.time, d.event, d.job, d.action)  # noqa: E731
    differ = sum(key(a) != key(b) for a, b in zip(card.decisions,
                                                  host.decisions))
    differ += abs(len(card.decisions) - len(host.decisions))
    print(f"reactive_shared decisions that differ, card against CPU: "
          f"{differ} of {max(len(card.decisions), len(host.decisions))}")


# ---------------------------------------------------------------------------
# multi-stage pipelines (phase 13)
# ---------------------------------------------------------------------------

def count_chain(words, n_stages=PIPE_STAGES):
    """numpy's word-count chain: stage 0 counts the words, each later stage
    counts the masked counts of the one before."""
    import numpy as np

    out, values = [], words
    for _ in range(n_stages):
        out.append(np.unique(values & COUNT_MASK, return_counts=True))
        values = out[-1][1]
    return out


def check_chain(report, expect, label):
    """Every stage's outputs, concatenated over reducers, equal numpy's."""
    import numpy as np

    for k, (job, (ek, ec)) in enumerate(zip(report.jobs, expect)):
        keys = np.concatenate([k_ for k_, _ in job.outputs])
        vals = np.concatenate([v for _, v in job.outputs])
        order = np.argsort(keys, kind="stable")
        check(np.array_equal(keys[order], ek)
              and np.array_equal(vals[order], ec),
              f"{label}: stage {k}'s outputs differ from numpy's chain")


def counting_word_count(device, calls):
    """Word count whose reduce appends, for each reducer it is handed, the
    ``segment_sum`` launches that reducer made."""
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.mapreduce.apps import word_count

    wc = word_count(device=device)

    def reduce_fn(keys, values):
        before = segment_sum.launches
        out = wc.reduce_fn(keys, values)
        calls.append(segment_sum.launches - before)
        return out

    return dataclasses.replace(wc, reduce_fn=reduce_fn)


def timed_plan(pipe, device, *args, **kwargs):
    """One ``GeoPipeline.plan`` between two synchronizations; seconds."""
    _sync(device)
    t = time.perf_counter()
    pipe.plan(*args, **kwargs)
    _sync(device)
    return time.perf_counter() - t


def phase_pipeline(device, n_docs=N_DOCS, words_per_doc=WORDS_PER_DOC,
                   vocab=VOCAB, n_restarts=N_RESTARTS, steps=STEPS,
                   pair_opt=PIPE_PAIR_OPT, profile_steps=PROFILE_STEPS):
    """Phase 13a: a 3-stage word-count chain through ``GeoPipeline``;
    returns (measured alphas, out_scales, the end_to_end solver's
    recorded call, launches)."""
    import numpy as np
    import torch
    from repro_torch.api import GeoJob, GeoPipeline, split_sources
    from repro_torch.core import (BARRIERS_GGL, Substrate, planetlab_platform,
                                  uniform_plan)
    from repro_torch.core import optimize as O
    from repro_torch.core.plan import validate_plan
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.mapreduce.apps import generate_documents

    print(f"== phase 13a: a {PIPE_STAGES}-stage word-count chain "
          "(GeoPipeline)", flush=True)
    base = planetlab_platform(8, alpha=1.0, seed=0)
    sub = Substrate.of(base)
    t0 = time.perf_counter()
    keys, vals = generate_documents(n_docs=n_docs, words_per_doc=words_per_doc,
                                    vocab=vocab, seed=0)
    expect = count_chain(vals)
    sources = split_sources(keys, vals, base.nS)
    print(f"corpus: {vals.size} words; numpy's chain "
          f"{[int(k.size) for k, _ in expect]} distinct keys by stage, made "
          f"in {time.perf_counter() - t0:.3f} s")
    calls = []
    app = counting_word_count(device, calls)
    root = GeoJob(base, app, device=device).calibrate(sources).platform

    def stages(alphas):
        return [GeoJob(root, app, device=device)] + [
            GeoJob(sub.view(np.zeros(sub.nS), a, name=f"stage{k + 1}"), app,
                   device=device)
            for k, a in enumerate(alphas)]

    def execute(pipe, label):
        calls.clear()
        segment_sum.launches = 0
        t = time.perf_counter()
        report = pipe.execute(sources)
        _sync(device)
        wall = time.perf_counter() - t
        check_chain(report, expect, label)
        check(len(calls) and min(calls) >= 1,
              f"{label}: a non-empty reducer launched segment_sum "
              f"{min(calls, default=0)} times")
        launched = segment_sum.launches
        check(launched == sum(calls), f"{label}: launches outside a reduce")
        # reducers run stage by stage: split the calls at each stage's
        # non-empty reducers
        cuts = np.cumsum([sum(1 for k, _ in job.outputs if k.shape[0])
                          for job in report.jobs])
        check(cuts[-1] == len(calls), f"{label}: a reducer was not counted")
        by_stage = [int(sum(c)) for c in np.split(np.array(calls), cuts[:-1])]
        return report, wall, (launched, by_stage)

    # the probe: uniform plans, the downstream alphas and out_scales guessed
    # at 1, measured from the run
    probe = stages([1.0] * (PIPE_STAGES - 1))
    for job in probe:
        job.with_plan(uniform_plan(job.platform), BARRIERS_GGL)
    rep, wall, _ = execute(GeoPipeline(probe, device=device).with_plans(),
                           "probe")
    alphas = [job.stats.alpha_measured for job in rep.jobs]
    out_scales = [
        sum(k.shape[0] for k, _ in job.outputs) * app.record_bytes / 1e6
        / max(float(job.stats.volumes_mb()[3].sum()), 1e-12)
        for job in rep.jobs]
    print(f"probe (uniform plans): execute {wall:.3f} s; measured alpha by "
          f"stage {alphas!r}; out_scale by stage {out_scales!r}")

    pipe = GeoPipeline(stages(alphas[1:]), out_scales=out_scales,
                       device=device)
    kw = dict(stage_mode="e2e_multi", barriers=BARRIERS_GGL,
              n_restarts=n_restarts, steps=steps)
    results = {}
    recorded = []
    real_solve = O._solve_pipeline_batch

    def recording_solve(*args, **kwargs):  # end_to_end's solver inputs
        recorded.append((args, kwargs))
        return real_solve(*args, **kwargs)

    for mode in ("stagewise", "end_to_end"):
        O._solve_pipeline_batch = recording_solve
        try:
            wall = timed_plan(pipe, device, mode, **kw)
        finally:
            O._solve_pipeline_batch = real_solve
        for res in pipe.planned.results:
            validate_plan(res.plan.x, res.plan.y)
        sim = pipe.simulate()
        report, exec_wall, launched = execute(pipe, mode)
        errors = [job.model_error() for job in report.jobs]
        spans = (report.makespan_modeled, float(sim.makespan_sim),
                 report.makespan_measured)
        for name, value in zip(("modeled", "simulated", "measured"), spans):
            check(np.isfinite(value), f"{mode}: {name} makespan {value}")
        check(all(np.isfinite(e) for e in errors),
              f"{mode}: model_error {errors}")
        results[mode] = (spans, wall, launched[0])
        print(f"{mode:10s} plan {n_restarts}x{steps} {wall:.3f} s  modeled "
              f"{spans[0]!r} s  simulated {spans[1]!r} s  measured "
              f"{spans[2]!r} s  stage model_error {errors!r}  execute "
              f"{exec_wall:.3f} s  segment_sum launches {launched[0]}, by "
              f"stage {launched[1]} (reducers "
              f"{[len(j.outputs) for j in report.jobs]} by stage)")
    check(results["end_to_end"][0][0] <= results["stagewise"][0][0] + 1e-9,
          "end_to_end is modeled worse than stagewise")
    check(len(recorded) == 1, f"{len(recorded)} end_to_end solver calls")
    warm = timed_plan(pipe, device, "end_to_end", **kw)
    print(f"end_to_end plan {n_restarts}x{steps}, {PIPE_STAGES} stages: first "
          f"{results['end_to_end'][1]:.3f} s, warm {warm:.3f} s (each between "
          "two synchronizations)")
    args, statics = recorded[0]
    if device.type == "cuda":  # 50 steps, as phase 4
        from torch.profiler import ProfilerActivity, profile

        short = dict(statics, steps=profile_steps)
        O._solve_pipeline_batch(*args, **short)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            O._solve_pipeline_batch(*args, **short)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy_us, n_events, _ = device_activity(prof)
        label = (f"_solve_pipeline_batch profile {n_restarts}x{profile_steps},"
                 f" {PIPE_STAGES} stages")
        if n_events:
            print(f"{label}: wall {wall!r} s  device busy {busy_us / 1e6!r} s"
                  f"  busy share {busy_us / 1e6 / wall!r}  device events "
                  f"{n_events} ({n_events / profile_steps!r} per step)")
        else:
            print(f"{label}: wall {wall!r} s, device time not measured (the "
                  "profiler recorded no device activity)")
    launches = sum(r[2] for r in results.values())
    phase_pipeline_pair(device, **pair_opt)
    return alphas, out_scales, recorded[0], launches


def pipeline_pair():
    """The two-node ``pipeline_pair`` substrate of examples/geo_pipeline.py:
    node 0 hosts the fast reducer behind 4 MB/s exits, node 1 a slow
    reducer behind fast ones."""
    import numpy as np
    from repro_torch.core import Substrate

    return Substrate(
        B_sm=np.array([[4.0, 4.0], [200.0, 200.0]]),
        B_mr=np.full((2, 2), 200.0),
        C_m=np.array([100.0, 100.0]),
        C_r=np.array([300.0, 60.0]),
        cluster_s=np.array([0, 1]),
        cluster_m=np.array([0, 1]),
        cluster_r=np.array([0, 1]),
        name="pipeline_pair",
    )


def phase_pipeline_pair(device, n_restarts, steps):
    """The example's 3-stage chain on ``pipeline_pair``, both modes on the
    card: end_to_end no worse modeled, at least 20% below stagewise
    simulated (the example's own asserts)."""
    import numpy as np
    from repro_torch.api import GeoJob, GeoPipeline
    from repro_torch.core import BARRIERS_GGL

    sub = pipeline_pair()
    reports = {}
    for mode in ("stagewise", "end_to_end"):
        stages = [GeoJob(sub.view(np.array([0.0, 6000.0]), 1.0,
                                  name="ingest")),
                  GeoJob(sub.view(np.zeros(2), 1.0, name="transform")),
                  GeoJob(sub.view(np.zeros(2), 0.5, name="aggregate"))]
        t = time.perf_counter()
        rep = GeoPipeline(stages, name=f"chain_{mode}", device=device).plan(
            mode, stage_mode="e2e_multi", barriers=BARRIERS_GGL,
            n_restarts=n_restarts, steps=steps).simulate()
        reports[mode] = rep
        print(f"pipeline_pair {mode:10s} {n_restarts}x{steps}: "
              f"{time.perf_counter() - t:.3f} s  modeled "
              f"{rep.makespan_modeled!r} s  simulated "
              f"{float(rep.makespan_sim)!r} s  reduce split "
              f"{[[round(float(v), 3) for v in p.y] for p in rep.plans]}")
    sw, e2e = reports["stagewise"], reports["end_to_end"]
    gain = 1 - e2e.makespan_sim / sw.makespan_sim
    check(e2e.makespan_modeled <= sw.makespan_modeled + 1e-9,
          "pipeline_pair: end_to_end modeled worse than stagewise")
    check(gain >= 0.20, f"pipeline_pair: simulated gain {gain} below 20%")
    print(f"pipeline_pair: end_to_end {gain:.1%} below stagewise simulated")


def phase_pipeline_schedule(device, jobs, alphas, out_scales,
                            n_restarts=N_RESTARTS, steps=STEPS,
                            online_restarts=ONLINE_RESTARTS,
                            online_steps=ONLINE_STEPS):
    """Phase 13b: 13a's first two stages on tenant 0's corpus, inside a
    ``GeoSchedule`` with tenants 1 and 2: planned joint / end_to_end,
    simulated, refused by ``execute``, then ``run_online`` static and
    reactive through a 250x drift of the links into the pipeline's
    stage-1 busiest reducer."""
    import numpy as np
    from repro_torch.api import GeoJob, GeoPipeline, GeoSchedule
    from repro_torch.core import (BARRIERS_GGL, CapacityTrace, SimConfig,
                                  Substrate)
    from repro_torch.core.makespan import analytic_volumes
    from repro_torch.core.plan import validate_plan
    from repro_torch.mapreduce.apps import word_count

    print("== phase 13b: a pipeline inside a schedule (GeoSchedule)",
          flush=True)
    wc = word_count(device=device)

    def members(sub):
        stage0 = GeoJob(sub.view(jobs[0].platform.D, jobs[0].platform.alpha,
                                 name="pipe/stage0"), wc, device=device)
        stage1 = GeoJob(sub.view(np.zeros(sub.nS), alphas[1],
                                 name="pipe/stage1"), wc, device=device)
        pipe = GeoPipeline([stage0, stage1], out_scales=out_scales[:2],
                           name="pipe", device=device)
        plain = [GeoJob(sub.view(j.platform.D, j.platform.alpha,
                                 name=j.platform.name), wc, device=device)
                 for j in jobs[1:3]]
        return pipe, plain

    sub = Substrate.of(jobs[0].platform)
    pipe, plain = members(sub)
    sched = GeoSchedule([pipe] + plain, device=device)
    _sync(device)
    t = time.perf_counter()
    sched.plan("joint", barriers=BARRIERS_GGL, pipeline_mode="end_to_end",
               n_restarts=n_restarts, steps=steps)
    _sync(device)
    wall = time.perf_counter() - t
    for job in sched.jobs:
        validate_plan(job.planned.plan.x, job.planned.plan.y)
    cfg = SimConfig(barriers=BARRIERS_GGL)
    frozen = sched.simulate(cfg)
    frozen_s = float(frozen.makespan_sim)
    check(np.isfinite(frozen_s), f"13b: frozen makespan {frozen_s}")
    print(f"joint + end_to_end plan {n_restarts}x{steps}, flat stack of "
          f"{len(sched.jobs)} (links {sched._links}): {wall:.3f} s  modeled "
          f"{sched.planned.makespan!r} s  simulated {frozen_s!r} s"
          f"  per job modeled {[r.makespan for r in sched.planned.results]!r}")
    try:
        sched.execute([[]] * len(sched.jobs))
    except RuntimeError as err:
        check("GeoPipeline.execute" in str(err), f"13b: execute said {err}")
    else:
        fail("13b: execute ran a schedule holding a pipeline")
    print("execute refused: the schedule holds a pipeline")

    t = time.perf_counter()
    static = sched.run_online(policy="static", cfg=cfg)
    static_wall = time.perf_counter() - t
    check(abs(static.makespan_online - frozen_s) <= 1e-9
          and abs(static.makespan_static - frozen_s) <= 1e-9,
          f"13b: static {static.makespan_online} differs from the frozen "
          f"{frozen_s}")
    print(f"static: wall {static_wall:.3f} s  online "
          f"{float(static.makespan_online)!r} s = frozen")

    # the drift: the two links carrying most of stage 1's shuffle into its
    # busiest reducer step down 250x at half the frozen makespan
    plans = sched.planned.plans
    s1 = sched.jobs[1]
    v = analytic_volumes(s1.platform.D, plans[1].x, plans[1].y,
                         s1.platform.alpha, xp=np)[2]
    busiest = int(np.argmax(v.sum(axis=0)))
    links = [int(m) for m in np.argsort(v[:, busiest])[::-1][:2]]
    t_drift = 0.5 * frozen_s
    traced = sub.with_traces({
        f"shuffle[m{m}->r{busiest}]": CapacityTrace.step(
            float(sub.B_mr[m, busiest]), float(sub.B_mr[m, busiest]) / 250.0,
            t_drift)
        for m in links})
    tpipe, tplain = members(traced)
    for job, plan in zip(tpipe.stages + tplain, plans):
        job.with_plan(plan, BARRIERS_GGL)
    tpipe.with_plans()
    tsched = GeoSchedule([tpipe] + tplain, device=device).with_plans()
    release = float(frozen.sims[0].reduce_end)
    print(f"shuffle links m{links}->r{busiest} (the pipeline's stage-1 "
          f"busiest reducer) step down 250x at {t_drift!r} s; stage 1 "
          f"(job 1) is fed until stage 0's reduce ends at {release!r} s "
          "in the frozen run")
    t = time.perf_counter()
    report = tsched.run_online(policy="reactive", cfg=cfg,
                               n_restarts=online_restarts, steps=online_steps)
    online_wall = time.perf_counter() - t
    for value in (report.makespan_online, report.makespan_static):
        check(np.isfinite(value), f"13b reactive: makespan {value}")
    for plan in report.plans:
        validate_plan(plan.x, plan.y)
    waiting = [d for d in report.decisions if d.job == 1 and d.time < release]
    print(f"reactive: wall {online_wall:.3f} s  online "
          f"{float(report.makespan_online)!r} s  static "
          f"{float(report.makespan_static)!r} s"
          f"  decisions {len(report.decisions)}  swaps {len(report.swaps)}  "
          f"rejects {len(report.rejected)}  charged {report.charged_s!r} s  "
          f"decisions on stage 1 before its upstream reduce ended "
          f"{len(waiting)}")
    print(report.timeline())
    for d in report.swaps:
        print(f"  swap: t={float(d.time)!r} job {d.job} remaining "
              f"{float(d.modeled_before)!r} -> {float(d.modeled_after)!r} s")


def phase_pipeline_card_vs_cpu(device, recorded, steps=25):
    """Phase 13c: ``_solve_pipeline_batch`` for ``steps`` steps from the
    inputs 13a's end_to_end path built, on the card and on the CPU.  The
    float64 trajectories are held to the solver bar; the float32 ones are
    printed with their distance from the float64 one (at these inputs the
    reference's own float32 trajectory is further than the bar from it:
    tests/test_torch_pipeline.py)."""
    import torch
    from repro_torch.core import optimize as O

    print("== phase 13c: the pipeline solver on the card against the CPU",
          flush=True)
    args, statics = recorded
    cpu = torch.device("cpu")

    def solve(dev, dtype, n=steps, inputs=args):
        moved = [tuple(a.to(dev, dtype) for a in arg) if isinstance(arg, tuple)
                 else arg.to(dev, dtype) for arg in inputs]
        return [t.cpu() for t in O._solve_pipeline_batch(
            *moved, **dict(statics, steps=n))]

    def dist(a, b):
        return ((a[0] - b[0]).abs().max().item(),
                (a[1] - b[1]).abs().max().item(),
                ((a[2] - b[2]).abs() / b[2].abs()).max().item())

    card64, cpu64 = solve(device, torch.float64), solve(cpu, torch.float64)
    errs = (_held("_solve_pipeline_batch float64 x", card64[0], cpu64[0],
                  1e-4),
            _held("_solve_pipeline_batch float64 y", card64[1], cpu64[1],
                  1e-4),
            _held("_solve_pipeline_batch float64 exact", card64[2], cpu64[2],
                  0.0, 1e-4))
    print(f"_solve_pipeline_batch {steps} steps in float64 from the inputs of "
          f"13a's end_to_end path (temperature unit {float(args[6])!r} s, "
          f"the stagewise stack's price), card against CPU: max |err| x "
          f"{errs[0]!r}, y {errs[1]!r}, exact {errs[2]!r} s (x, y atol 1e-4;"
          " exact rtol 1e-4)")
    card32, cpu32 = solve(device, torch.float32), solve(cpu, torch.float32)
    print(f"unchecked: in float32, as the path runs it, max |err| x, y, exact "
          f"relative: card against CPU {dist(card32, cpu32)!r}; card against "
          f"the float64 CPU run {dist(card32, cpu64)!r}; CPU against it "
          f"{dist(cpu32, cpu64)!r}")
    # the CPU's float32 run with every logit one ulp up or down (seeded
    # choices): how far rounding alone moves these trajectories
    lx = args[4].cpu()
    for seed in range(ULP_SEEDS):
        gen = torch.Generator().manual_seed(seed)
        up = torch.rand(lx.shape, generator=gen) < 0.5
        nudged = list(args)
        nudged[4] = torch.nextafter(lx, torch.where(up, torch.inf, -torch.inf))
        print(f"unchecked: the CPU's float32 run with each logit moved one ulp"
              f" (seed {seed}) against the CPU's: "
              f"{dist(solve(cpu, torch.float32, inputs=nudged), cpu32)!r}")
    long = 4 * steps
    far = dist(solve(device, torch.float32, long),
               solve(cpu, torch.float32, long))
    print(f"unchecked: {long} steps in float32, card against CPU: {far!r}")


# ---------------------------------------------------------------------------
# phase 14: the paper's planner in multi-device training, on a one-rank
# NCCL mesh
# ---------------------------------------------------------------------------

#: the example's cross-pod reduction: llama4-scout's float32 gradients per
#: chip of a 256-chip pod, one pod's inter-pod link at a quarter
XPOD_ARCH, XPOD_BW, XPOD_SLOW = "llama4-scout-17b-a16e", (6400, 6400, 1600, 6400), 2
#: the example's MoE dispatch: 8 expert groups on 2 pods, one pod throttled
MOE_PLAN_EXAMPLE = dict(tokens_mb_per_shard=64.0, n_token_shards=8,
                        group_pod=[0] * 4 + [1] * 4, shard_pod=[0] * 4 + [1] * 4,
                        top_k=1, expert_flops_rate_mbps=[25000] * 4 + [10000] * 4)
#: the planners' bar, card against CPU (the port's solver bar), and the
#: step counts around the solve's own whose CPU plans span the band the
#: card is held to: where Adam ends the anneal on a cycle (the MoE
#: example: 0.0056146-0.0057390 s over 296-304 steps on the CPU), the step
#: a solve stops at, and float32 rounding, pick the point of the cycle
PLAN_RTOL = 1e-3
PLAN_BAND_STEPS = 4
#: Granite's 40 experts in 4 groups of 10, two groups a pod, the second
#: pod's experts at a third of the rate: the dispatch plan 14b loads
GRANITE_GROUPS = 4
GRANITE_PLAN = dict(tokens_mb_per_shard=64.0, n_token_shards=4,
                    group_pod=[0, 0, 1, 1], shard_pod=[0, 0, 1, 1],
                    expert_flops_rate_mbps=[25000, 25000, 8000, 8000])
#: depth of the full-width cuts of phase 14 (Granite in 14b, Qwen3 in 14d)
MESH_DEPTH = 4
MESH_PROMPTS = (3000, 17)
MESH_TRAIN_STEPS = 3
MESH_LOSS_RTOL = 1e-5


def one_rank_world(device):
    """Join a one-rank process group (NCCL on the card, gloo on the CPU)
    through a ``FileStore`` in a temporary directory; returns the function
    that leaves it."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    if device.type == "cuda":
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=device)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)

    def leave():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    return leave


def _mesh_label(mesh) -> str:
    import torch.distributed as dist

    return (f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"{dist.get_backend()}")


def timed_solve(device, fn, **kwargs):
    """(the plan, host seconds between two synchronizations of ``device``)."""
    from repro_torch._device import synchronize

    synchronize(device)
    t = time.perf_counter()
    out = fn(**kwargs, device=device)
    synchronize(device)
    return out, time.perf_counter() - t


def phase_training_planners(device, n_restarts=8, steps=300):
    """Phase 14a: the two training planners on the card, first and warm,
    each held to the CPU: its est within ``PLAN_RTOL`` of the band that the
    CPU's plans at the same call's steps +- ``PLAN_BAND_STEPS`` span (a
    band of one point where the anneal settles)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.collective_plan import plan_cross_pod_reduction
    from repro_torch.core.moe_plan import plan_moe_dispatch

    print("== phase 14a: plan_cross_pod_reduction and plan_moe_dispatch on "
          "the card against the CPU", flush=True)
    cfg = get_config(XPOD_ARCH)
    xpod = dict(grad_mb=cfg.n_params() * 4 / 1e6 / 256,
                n_elements=cfg.n_params() // 256, n_restarts=n_restarts,
                steps=steps)
    cases = [("cross-pod reduction, pod 2 at 1600 Mb/s",
              plan_cross_pod_reduction, dict(xpod, pod_dcn_bw_mbps=list(XPOD_BW))),
             ("cross-pod reduction, homogeneous pods", plan_cross_pod_reduction,
              dict(xpod, pod_dcn_bw_mbps=[XPOD_BW[0]] * len(XPOD_BW))),
             ("MoE dispatch, the example's 8 groups", plan_moe_dispatch,
              dict(MOE_PLAN_EXAMPLE, n_restarts=n_restarts, steps=steps))]
    cpu_dev = torch.device("cpu")
    for label, fn, kwargs in cases:
        plan, first = timed_solve(device, fn, **kwargs)
        plan, warm = timed_solve(device, fn, **kwargs)
        cpu, cpu_s = timed_solve(cpu_dev, fn, **kwargs)
        rel = abs(plan.est_time_s - cpu.est_time_s) / cpu.est_time_s
        band = [fn(**dict(kwargs, steps=kwargs["steps"] + d),
                   device=cpu_dev).est_time_s
                for d in range(-PLAN_BAND_STEPS, PLAN_BAND_STEPS + 1)]
        lo, hi = min(band) * (1 - PLAN_RTOL), max(band) * (1 + PLAN_RTOL)
        check(lo <= plan.est_time_s <= hi, f"14a {label}: est_time_s "
              f"{plan.est_time_s} on the card, outside the CPU's {band} at "
              f"{kwargs['steps']} +- {PLAN_BAND_STEPS} steps widened by "
              f"{PLAN_RTOL}")
        check(plan.est_time_s <= plan.uniform_time_s + 1e-12,
              f"14a {label}: the plan is worse than uniform")
        shares = getattr(plan, "fractions", getattr(plan, "group_fractions",
                                                    None))
        if fn is plan_cross_pod_reduction:
            check(int(plan.segment_sizes.sum()) == plan.n_elements,
                  f"14a {label}: segments do not partition the elements")
            if len(set(kwargs["pod_dcn_bw_mbps"])) > 1:
                check(shares[XPOD_SLOW] < 0.15, f"14a {label}: the slow pod "
                      f"owns {shares[XPOD_SLOW]}, not under 0.15")
        print(f"14a {label}: solve on the card first {first!r} s, warm "
              f"{warm!r} s (CPU {cpu_s!r} s); est {plan.est_time_s!r} s vs "
              f"uniform {plan.uniform_time_s!r} s ({plan.speedup_vs_uniform!r}x;"
              f" CPU est {cpu.est_time_s!r}, {rel!r} relative, within "
              f"{PLAN_RTOL}: {rel <= PLAN_RTOL}; the CPU at {kwargs['steps']} "
              f"+- {PLAN_BAND_STEPS} steps spans {min(band)!r}-{max(band)!r} "
              f"s); shares {np.round(shares, 4).tolist()}")


def _with_moe_plan(params, bias, capacity):
    """``params`` with every MoE FFN's ``plan_bias`` and ``plan_capacity``
    replaced by ``bias`` and ``capacity`` (per expert, in the leaves' own
    dtype and stacking)."""
    import torch

    def load(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: load(v) for k, v in tree.items()}
        if "plan_bias" in tree:
            for name, value in (("plan_bias", bias), ("plan_capacity", capacity)):
                leaf = tree[name]
                out[name] = torch.as_tensor(value, device=leaf.device).to(
                    leaf.dtype).expand(leaf.shape).clone()
        return out

    return load(params)


def dropped_share(routes, cfg, capacity):
    """The share of (token, k) assignments that the capacity rule drops,
    over every recorded MoE call: a token's choice of expert e is kept if
    fewer than ``round(capacity[e] * C)`` earlier choices went to e, the
    product rounded in ``capacity``'s dtype as the model rounds it."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops

    dropped = total = 0
    for ids in routes:
        n, k = ids.shape
        c = max(int(np.ceil(n * k / cfg.n_experts * cfg.capacity_factor)), k)
        flat = ids.reshape(-1)
        slots = kops.compute_slots(flat, cfg.n_experts)
        cap_e = torch.clamp(torch.round(capacity * c), min=1).to(torch.int32)
        dropped += int((slots >= cap_e[flat]).sum())
        total += flat.numel()
    return dropped / total


def phase_moe_mesh(device, mesh, depth=MESH_DEPTH, prompts=MESH_PROMPTS,
                   max_len=SERVE_MAX_LEN, cfg=None):
    """Phase 14b: Granite at full width through the expert-parallel
    ``moe_fwd(mesh=)`` against ``mesh=None``, both with the kernels; then
    with a ``plan_moe_dispatch`` plan loaded.  Returns the LM kernels'
    launches by name in (the expert-parallel prefills, the one-device
    prefills they are compared with)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe_plan import plan_moe_dispatch
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg or get_config(GRANITE_ARCH), n_layers=depth)
    print(f"== phase 14b: {cfg.name} at full width and depth {depth} in "
          f"bfloat16, expert parallel on a {_mesh_label(mesh)} mesh against one "
          f"device, prompts {prompts}", flush=True)
    kernels = _lm_kernels()
    gen = torch.Generator(device=device).manual_seed(14)
    params = M.init(cfg, gen, device=device, dtype=torch.bfloat16)
    rng = np.random.default_rng(14)
    n_moe = expected_launches(cfg)["moe_dispatch"][0]
    atol, rtol = MODEL_TOL
    launched = {True: dict.fromkeys(kernels, 0), False: dict.fromkeys(kernels, 0)}

    def prefill(p, tokens, on_mesh):
        """(logits, moe_dispatch launches, routes, synchronized wall s)."""
        calls, restore = _routing_recorder()
        before = {k: w.launches for k, w in kernels.items()}
        _sync(device)
        t = time.perf_counter()
        try:
            logits, _, _ = M.prefill(cfg, p, {"tokens": tokens},
                                     max_cache_len=max_len, use_kernels=True,
                                     mesh=mesh if on_mesh else None)
            _sync(device)
        finally:
            restore()
        wall = time.perf_counter() - t
        for k, w in kernels.items():
            launched[on_mesh][k] += w.launches - before[k]
        return (logits, kernels["moe_dispatch"].launches - before["moe_dispatch"],
                calls, wall)

    for t_len in prompts:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, t_len)),
                                 device=device)
        one, n_one, _, _ = prefill(params, tokens, False)
        ep, n_ep, _, _ = prefill(params, tokens, True)
        check(n_ep == n_one == n_moe, f"14b T={t_len}: moe_dispatch launched "
              f"{n_ep} times expert parallel, {n_one} on one device, wanted "
              f"{n_moe}")
        same_tokens = torch.equal(ep.argmax(-1), one.argmax(-1))
        ok, err = _close(ep, one, atol, rtol)
        check(same_tokens and ok and bool(torch.isfinite(ep).all()),
              f"14b T={t_len}: greedy tokens equal {same_tokens}, logits max "
              f"|err| {err} (atol {atol}, rtol {rtol})")
        print(f"14b T={t_len}: expert parallel vs one device: greedy tokens "
              f"equal, logits max |err| {err!r} (bit for bit: "
              f"{torch.equal(ep, one)}); moe_dispatch {n_ep} launches each")
    # walls at the longest prompt, warm, without and with the plan
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, max(prompts))),
                             device=device)
    plan, solve_s = timed_solve(device, plan_moe_dispatch, top_k=cfg.top_k,
                                **GRANITE_PLAN)
    per = cfg.n_experts // GRANITE_GROUPS
    bias = np.repeat(plan.router_bias, per)
    capacity = np.repeat(plan.capacity_factor, per)
    planned = _with_moe_plan(params, bias, capacity)
    cap_leaf = planned["groups"]["blk0"]["ffn"]["plan_capacity"][0]
    stats = {}
    for label, p, cap in (("identity plan", params, torch.ones_like(cap_leaf)),
                          ("planned", planned, cap_leaf)):
        prefill(p, tokens, True)  # warm
        _, n, routes, wall = prefill(p, tokens, True)
        check(n == n_moe, f"14b {label}: {n} moe_dispatch launches")
        stats[label] = (wall, dropped_share(routes, cfg, cap))
        print(f"14b {label}: {max(prompts)}-token prefill wall {wall!r} s, dropped "
              f"(token, k) assignments {stats[label][1]!r}", flush=True)
    print(f"14b plan_moe_dispatch over {GRANITE_GROUPS} groups of {per} experts "
          f"(solved on the card in {solve_s!r} s): group fractions "
          f"{np.round(plan.group_fractions, 4).tolist()}, capacity factors "
          f"{np.round(plan.capacity_factor, 4).tolist()}, router bias "
          f"{np.round(plan.router_bias, 4).tolist()}, modeled "
          f"{plan.est_time_s!r} s vs uniform {plan.uniform_time_s!r} s")
    del params, planned
    return launched[True], launched[False]


def phase_allreduce_mesh(device, mesh, arch=TRAIN_ARCH, cfg=None):
    """Phase 14c: ``hierarchical_allreduce`` over a tree with ``arch``'s
    parameter shapes in float32 on a one-rank (pod, data) mesh: the result
    is the input bit for bit; its wall and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.collective_schedule import (flat_size,
                                                       hierarchical_allreduce)
    from repro_torch.train.optim import tree_get

    cfg = cfg or get_config(arch)
    print(f"== phase 14c: hierarchical_allreduce over {cfg.name}'s parameter "
          f"shapes in float32 on a {_mesh_label(mesh)} mesh", flush=True)
    tree = M.init(cfg, torch.Generator(device=device).manual_seed(15),
                  device=device, dtype=torch.float32)
    n = flat_size(tree)
    _sync(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if on_card else 0
    t = time.perf_counter()
    out = hierarchical_allreduce(tree, mesh, mean=True)
    _sync(device)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) - base if on_card else 0
    same = []
    M._tree_map(lambda path, a: same.append(torch.equal(
        a, tree_get(tree, path)) and a.dtype == torch.float32), out)
    check(all(same), "14c: the one-rank all-reduce changed the tree")
    print(f"14c: {n} elements ({n * 4 / 1e9!r} GB): result equal to the input "
          f"bit for bit; wall {wall!r} s, {n * 4 / wall / 1e9!r} GB/s of the "
          f"tree; peak above the tree {peak / 1e9!r} GB (the flat copy, the "
          "scattered chunk and the gathered vector: the reference's design)")
    del tree, out


def phase_train_mesh(device, arch=TRAIN_ARCH, depth=MESH_DEPTH,
                     steps=MESH_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     reduced=False, extra=(), phase="14d"):
    """Phase 14d (and 15c, with ``extra`` = ``--compression int8``):
    ``launch.train --mesh 1x1`` against the run without a mesh, ``arch``
    at full width and depth ``depth``, both with the flags ``extra``: the
    same losses."""
    import dataclasses

    from repro_torch.launch import train as launch_train

    print(f"== phase {phase}: {arch} at full width and depth {depth} through "
          f"launch.train {' '.join(extra)}, --mesh 1x1 against no mesh "
          f"({steps} AdamW steps of {batch} x {seq} tokens, bf16, remat)",
          flush=True)
    real = launch_train.get_config
    launch_train.get_config = lambda name: dataclasses.replace(real(name),
                                                               n_layers=depth)
    runs = {}
    try:
        for label, mesh in (("no mesh", ()), ("--mesh 1x1", ("--mesh", "1x1"))):
            records = []
            argv = _train_argv(arch, reduced, steps, batch, seq, "--dtype",
                               "bfloat16", "--remat", "--warmup", "1",
                               "--device", str(device), *extra, *mesh)
            _, lines = _run_launcher(argv, records, device)
            check(lines[-1] == "[train] done" and len(records) == steps,
                  f"{phase} {label}: {len(records)} steps, last line "
                  f"{lines[-1]!r}")
            runs[label] = records
    finally:
        launch_train.get_config = real
    want = [r["loss"] for r in runs["no mesh"]]
    got = [r["loss"] for r in runs["--mesh 1x1"]]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(worst <= MESH_LOSS_RTOL, f"{phase}: losses on the mesh {got} "
          f"against {want} without, {worst} relative (over {MESH_LOSS_RTOL})")
    for label, records in runs.items():
        warm = [r["s"] for r in records[1:]]
        print(f"{phase} {label}: losses {[r['loss'] for r in records]!r}; "
              f"first step {records[0]['s']!r} s, warm steps {warm!r} s "
              f"(median {statistics.median(warm)!r} s)")
    print(f"{phase}: losses agree to {worst!r} relative")
    return runs


def phase_multidevice(device):
    """Phase 14: 14a the planners; on a one-rank NCCL world, 14b the
    expert-parallel MoE, 14c the hierarchical all-reduce and 14d the
    launcher's ``--mesh``.  Returns 14b's LM kernel launches by name (expert
    parallel, one device) and 14d's records of the ``--mesh 1x1`` steps."""
    from repro_torch.launch.mesh import make_mesh

    t = time.perf_counter()
    phase_training_planners(device)
    leave = one_rank_world(device)
    try:
        launches = phase_moe_mesh(device, make_mesh((1, 1), ("data", "model"),
                                                    device.type))
        free_device_memory(device)
        phase_allreduce_mesh(device, make_mesh((1, 1), ("pod", "data"),
                                               device.type))
        free_device_memory(device)
        train_runs = phase_train_mesh(device)
        free_device_memory(device)
    finally:
        leave()
    print(f"phase 14: {time.perf_counter() - t:.1f} s")
    return launches, train_runs["--mesh 1x1"]


# ---------------------------------------------------------------------------
# phase 15: the dry run at the production meshes, held to the card
# ---------------------------------------------------------------------------

#: 15a's production cells: (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", False),
                ("granite-moe-3b-a800m", "prefill_32k", False),
                ("falcon-mamba-7b", "decode_32k", False),
                ("llama4-scout-17b-a16e", "train_4k", True))
#: 15b: the dry run's peak against ``max_memory_allocated`` of the real step
DRYRUN_MEM_RTOL = 0.10
#: 15b's cells: phase 14d's Qwen3 step and phase 14b's Granite prefill
DRYRUN_TRAIN = ("dryrun_train", TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, "train")
DRYRUN_PREFILL = ("dryrun_prefill", GRANITE_ARCH, max(MESH_PROMPTS), 1,
                  "prefill")


def _finite_numbers(tree) -> bool:
    import math

    if isinstance(tree, dict):
        return all(_finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite_numbers(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return math.isfinite(tree)
    return True


#: the reference's layout on the same cells: (per-device bytes, flops a
#: device) from its own dry run (``python -m repro.launch.dryrun --arch A
#: --shape S --multi-pod M``: XLA's ``memory_analysis`` and
#: ``cost_analysis``, shape arithmetic compiled for the CPU, no TPU; its
#: chunked attention's inner scans stay rolled and are counted once);
#: Llama4-Scout's analysis build fails, so it has no flops
REFERENCE_DRYRUN = {
    ("qwen3-1.7b", "train_4k", False): (24.20e9, 6.07e13),
    ("granite-moe-3b-a800m", "prefill_32k", False): (5.44e9, 1.016e13),
    ("falcon-mamba-7b", "decode_32k", False): (0.557e9, 1.548e10),
    ("llama4-scout-17b-a16e", "train_4k", True): (42.49e9, None),
}
#: 15a: these cells fit in one card in the tensor-parallel layout
DRYRUN_MUST_FIT = (("qwen3-1.7b", "train_4k", False),
                   ("llama4-scout-17b-a16e", "train_4k", True))
#: 15a: Qwen3-1.7B ``train_4k``'s flops a device at most this many times
#: the reference's
DRYRUN_FLOPS_RATIO = 1.25


def phase_dryrun_production(device, cells=DRYRUN_CELLS, reduced=False):
    """Phase 15a: ``launch.dryrun.run_cell`` of each cell at its production
    mesh (a fake world of 256 or 512 ranks, stand-ins on the meta device,
    ``device`` the card the step would run on): every trace finishes, every
    count is finite, every cell communicates (each tensor-parallel layer
    all-reduces over ``"model"``), no byte is allocated on the card, the
    cells of ``DRYRUN_MUST_FIT`` fit in one card and Qwen3-1.7B
    ``train_4k``'s flops a device are at most ``DRYRUN_FLOPS_RATIO`` times
    the reference's.  Each cell's bytes and flops are printed beside the
    reference's (``REFERENCE_DRYRUN``; not checked for a reduced config).
    Returns the reports."""
    import torch
    from repro_torch.launch.dryrun import CARD_BYTES, COLLECTIVE_KINDS, run_cell

    print("== phase 15a: the dry run at the production meshes, on stand-ins "
          f"for {device}", flush=True)
    on_card = device.type == "cuda"
    before = torch.cuda.memory_allocated(device) if on_card else 0
    reports = []
    for arch, shape, multi_pod in cells:
        t = time.perf_counter()
        rep = run_cell(arch, shape, multi_pod, reduced=reduced, device=device)
        wall = time.perf_counter() - t
        label = f"15a {arch} {shape} {rep['mesh']}"
        check(_finite_numbers(rep), f"{label}: a count is not finite")
        coll = rep["collectives_per_device_bytes"]
        check(coll["total"] > 0, f"{label}: no collective traced")
        ref_bytes, ref_flops = REFERENCE_DRYRUN.get((arch, shape, multi_pod),
                                                    (None, None))
        if not reduced:
            if (arch, shape, multi_pod) in DRYRUN_MUST_FIT:
                check(rep["fits_card"], f"{label}: {rep['per_device_bytes']} "
                      f"bytes a device do not fit in {CARD_BYTES:.0f}")
            if (arch, shape) == ("qwen3-1.7b", "train_4k"):
                check(rep["flops_per_device"] <= DRYRUN_FLOPS_RATIO * ref_flops,
                      f"{label}: flops {rep['flops_per_device']} over "
                      f"{DRYRUN_FLOPS_RATIO} x the reference's {ref_flops}")
        if ref_bytes is not None and not reduced:
            print(f"{label} beside the reference's layout: per-device bytes "
                  f"{rep['per_device_bytes'] / 1e9!r} GB against "
                  f"{ref_bytes / 1e9!r} GB "
                  f"({rep['per_device_bytes'] / ref_bytes!r}x); flops a "
                  f"device {rep['flops_per_device']} against "
                  f"{ref_flops!r} ("
                  f"{rep['flops_per_device'] / ref_flops if ref_flops else None!r}"
                  "x)", flush=True)
        print(f"{label}: per_device_bytes {rep['per_device_bytes']} "
              f"({rep['per_device_bytes'] / 1e9!r} GB; arguments "
              f"{rep['argument_size_in_bytes'] / 1e9!r} GB), fits in one "
              f"card ({CARD_BYTES / 1e9:.0f} GB): {rep['fits_card']}; "
              f"flops_per_device {rep['flops_per_device']} (the reference's "
              f"analytic attention flops for the whole mesh "
              f"{rep['attn_flops_total']!r}); collective bytes per device "
              f"{ {k: coll[k] for k in COLLECTIVE_KINDS + ('total',)} } in "
              f"{rep['collectives_per_device_count']}; "
              f"{rep['ops_per_device']} ops traced in {rep['trace_s']} s, "
              f"wall {wall:.1f} s", flush=True)
        reports.append(rep)
    after = torch.cuda.memory_allocated(device) if on_card else 0
    check(after == before, f"15a: the dry run allocated {after - before} "
          "bytes on the card")
    print(f"15a: device memory allocated {before} bytes before the dry "
          f"runs, {after} after")
    return reports


def _with_cell(name, arch, seq, batch, kind, depth, reduced=False):
    """Register ``arch`` (``reduced``: its smoke config) at depth ``depth``
    and the shape ``(seq, batch, kind)`` under ``name`` in the port's own
    registries (this process only); returns the config."""
    import dataclasses

    from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              n_layers=depth)
    ARCHS[name] = cfg
    SHAPES[name] = ShapeSpec(name, seq, batch, kind)
    return cfg


def _dry_against_real(device, mesh, label, name, run_real):
    """Phase 15b, one cell: the dry run of ``name`` on ``mesh`` against
    ``run_real()`` on the card from a reset of the peak (its flops counted
    by ``FlopCounterMode``): the flops equal, the peak within
    ``DRYRUN_MEM_RTOL``."""
    import torch
    from repro_torch.launch.dryrun import run_cell
    from torch.utils.flop_counter import FlopCounterMode

    dry = run_cell(name, name, False, mesh=mesh, device=device)
    _sync(device)
    base = torch.cuda.memory_allocated(device)
    args = run_real(None)  # the real step's state, parameters and batch
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    counter = FlopCounterMode(display=False)
    t = time.perf_counter()
    with counter:
        out = run_real(args)
        _sync(device)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) - base
    del out, args
    flops = counter.get_total_flops()
    gap = abs(dry["per_device_bytes"] - peak) / peak
    print(f"15b {label}: flops dry {dry['flops_per_device']} / real "
          f"{flops} (gap {dry['flops_per_device'] - flops}); peak bytes "
          f"dry {dry['per_device_bytes']} / real {peak} (max_memory_allocated"
          f" from a reset, less the {base} bytes allocated before the step's "
          f"arguments), gap {gap!r}; arguments dry "
          f"{dry['argument_size_in_bytes']}; real step wall {wall!r} s, dry "
          f"trace {dry['trace_s']} s", flush=True)
    check(dry["flops_per_device"] == flops, f"15b {label}: flops differ")
    check(gap <= DRYRUN_MEM_RTOL, f"15b {label}: the dry run's peak is "
          f"{gap} from the card's (over {DRYRUN_MEM_RTOL})")
    return {"flops_gap": dry["flops_per_device"] - flops, "memory_gap": gap}


def phase_dryrun_vs_card(device, mesh, depth=MESH_DEPTH, train=DRYRUN_TRAIN,
                         prefill=DRYRUN_PREFILL, reduced=False):
    """Phase 15b: on ``mesh`` (one rank), phase 14d's Qwen3 train step and
    phase 14b's Granite prefill at full width and depth ``depth``, each as
    a dry run and for real on the card, plain PyTorch (``use_kernels``
    off, as the dry run): equal flops, peaks within ``DRYRUN_MEM_RTOL``."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step, place_state,
                                              state_shardings)

    print(f"== phase 15b: the dry run held to the card on a "
          f"{_mesh_label(mesh)} mesh, depth {depth}", flush=True)
    name, _, seq, batch, _ = train
    cfg = _with_cell(*train, depth, reduced)
    step = make_train_step(cfg, TrainConfig(compute_dtype=torch.bfloat16,
                                            remat=True, use_kernels=False),
                           mesh=mesh)
    rng = np.random.default_rng(15)

    def train_step(args):
        if args is None:
            gen = torch.Generator(device=device).manual_seed(15)
            state = init_state(cfg, M.init(cfg, gen, device=device))
            with axis_rules(mesh, DEFAULT_RULES):
                state = place_state(state, state_shardings(cfg, state, mesh))
            toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                size=(batch, seq + 1)),
                                   dtype=torch.int32, device=device)
            return state, {"tokens": toks[:, :-1].contiguous(),
                           "labels": toks[:, 1:].contiguous()}
        with axis_rules(mesh, DEFAULT_RULES):
            return step(*args)

    gaps = {"train": _dry_against_real(device, mesh, f"{cfg.name} train step "
                                       f"{batch} x {seq}", name, train_step)}
    free_device_memory(device)
    name, _, seq, batch, _ = prefill
    gcfg = _with_cell(*prefill, depth, reduced)

    def prefill_step(args):
        if args is None:
            gen = torch.Generator(device=device).manual_seed(16)
            params = M.init(gcfg, gen, device=device, dtype=torch.bfloat16)
            toks = torch.as_tensor(rng.integers(0, gcfg.vocab,
                                                size=(batch, seq)),
                                   dtype=torch.int32, device=device)
            return params, {"tokens": toks}
        with axis_rules(mesh, DEFAULT_RULES):
            return M.prefill(gcfg, args[0], args[1], max_cache_len=seq,
                             mesh=mesh)

    gaps["prefill"] = _dry_against_real(device, mesh, f"{gcfg.name} prefill "
                                        f"{batch} x {seq}", name, prefill_step)
    free_device_memory(device)
    return gaps


def phase_dryrun(device):
    """Phase 15: 15a the dry run at the production meshes; on a one-rank
    NCCL world, 15b the dry run held to the card and 15c ``launch.train
    --mesh 1x1 --compression int8`` against no mesh.  Returns 15a's
    reports and 15b's gaps."""
    from repro_torch.launch.mesh import make_mesh

    t = time.perf_counter()
    reports = phase_dryrun_production(device)
    leave = one_rank_world(device)
    try:
        gaps = phase_dryrun_vs_card(device, make_mesh((1, 1),
                                                      ("data", "model"),
                                                      device.type))
        phase_train_mesh(device, extra=("--compression", "int8"),
                         phase="15c")
        free_device_memory(device)
    finally:
        leave()
    print(f"phase 15: {time.perf_counter() - t:.1f} s")
    return reports, gaps


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism on the card, two ranks on one H100
# ---------------------------------------------------------------------------

#: phase 16's mesh: (data 1, model 2), one process a rank on the one card,
#: over gloo (NCCL refuses two ranks on one device)
TP_MESH = (1, 2)
#: 16a: the float32 cut's depth and tokens, the bf16 steps' depth
TP_CUT_DEPTH, TP_CUT_SEQ, TP_STEPS_DEPTH = 2, 256, 4
#: 16b: (arch, depth) served through ServeEngine(mesh=), float32 with
#: kernels (RecurrentGemma: one pattern group plus the tail, the least depth
#: its config allows), the prompt and the decode steps
TP_SERVE = ((SERVE_ARCH, None), (MAMBA_ARCH, 4))
TP_PROMPT, TP_DECODE = 3000, 3
TP_TIMEOUT_S = 600
#: the kernels a tensor-parallel prefill or decode step launches
TP_KERNELS = ("flash_attention", "rglru_scan", "mamba_scan")


def _tp_join(rank, workdir, device_type="cuda"):
    """Join phase 16's gloo world of ``TP_MESH`` ranks on the card (or, to
    rehearse, the CPU); returns (the device, the mesh)."""
    import math
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    device = torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device(device_type)
    store = dist.FileStore(os.path.join(workdir, "store"), math.prod(TP_MESH))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=math.prod(TP_MESH))
    return device, make_mesh(TP_MESH, ("data", "model"), device_type)


def tp_float32_cut(device, mesh, depth=TP_CUT_DEPTH, seq=TP_CUT_SEQ,
                   cfg=None):
    """16a, on this rank: ``TRAIN_ARCH`` at full width and depth ``depth``,
    float32 without TF32, B=1: the loss on the mesh against one device's,
    and this rank's shard of every gradient against the same shard of one
    device's.  Returns (loss gap, worst gradient gap over the leaf's
    largest entry, leaves)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config, padded_for_tp
    from repro_torch.models import model as M
    from repro_torch.models.sharding import (DEFAULT_RULES, axis_rules,
                                             local_shard)
    from repro_torch.train.optim import tree_get

    torch.set_float32_matmul_precision("highest")
    cfg = padded_for_tp(dataclasses.replace(cfg or get_config(TRAIN_ARCH),
                                            n_layers=depth), TP_MESH[1])
    params = M.init(cfg, torch.Generator(device=device).manual_seed(3),
                    device=device)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(1, seq + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
             "labels": torch.as_tensor(toks[:, 1:], device=device)}
    want_loss, want = _grads(cfg, params, batch)
    with axis_rules(mesh, DEFAULT_RULES):
        placed = M.place_params(cfg, params, mesh)
    leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), placed)
    loss, _ = M.loss_fn(cfg, leaves, batch, mesh=mesh)
    paths, flat = [], []
    M._tree_map(lambda p, a: (paths.append(p), flat.append(a)), leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    worst = 0.0
    for path, g in zip(paths, grads):
        w = want[path]
        if w is None or g is None:
            check(w is None and g is None, f"16a {'/'.join(path)}: reached "
                  "on one side only")
            continue
        # this rank's shard of one device's gradient: no communication
        w_local = local_shard(w, mesh, tree_get(placed, path).placements)
        scale = float(w.abs().max())
        worst = max(worst, float((g.to_local() - w_local).abs().max()) / scale)
    gap = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    del params, placed, leaves, grads, want
    return gap, worst, len(paths)


def tp_train_steps(device, mesh, depth=TP_STEPS_DEPTH, steps=MESH_TRAIN_STEPS,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, cfg=None):
    """16a, on this rank: ``steps`` AdamW steps of ``TRAIN_ARCH`` at full
    width and depth ``depth`` in bf16 over float32 masters with remat, the
    state at rest on the mesh: (losses, each step's wall, the peak bytes
    allocated on the card by this process)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config, padded_for_tp
    from repro_torch.models import model as M
    from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step, place_state,
                                              state_shardings)

    cfg = padded_for_tp(dataclasses.replace(cfg or get_config(TRAIN_ARCH),
                                            n_layers=depth), TP_MESH[1])
    state = init_state(cfg, M.init(cfg, torch.Generator(device=device)
                                   .manual_seed(4), device=device,
                                   tp=TP_MESH[1]))
    with axis_rules(mesh, DEFAULT_RULES):
        state = place_state(state, state_shardings(cfg, state, mesh))
    free_device_memory(device)
    on_card = device.type == "cuda"
    if on_card:  # from the state at rest on
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(cfg, TrainConfig(compute_dtype=torch.bfloat16,
                                            remat=True), mesh=mesh)
    rng = np.random.default_rng(4)
    losses, walls = [], []
    for _ in range(steps):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(batch, seq + 1)),
                               dtype=torch.int32, device=device)
        _sync(device)
        t = time.perf_counter()
        with axis_rules(mesh, DEFAULT_RULES):
            state, metrics = step(state, {"tokens": toks[:, :-1],
                                          "labels": toks[:, 1:]})
        loss = _metric(metrics["loss"])
        _sync(device)
        walls.append(time.perf_counter() - t)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del state
    return losses, walls, peak


def _width_recorder():
    """Wrap the kernels as ``kernels.ops`` calls them so that each launch's
    local width is recorded: the query and kv heads of ``flash_attention``,
    the channels of the scans.  Returns (the record, a function that
    unwraps)."""
    from repro_torch.kernels import ops

    seen = {name: set() for name in TP_KERNELS}
    real = {name: getattr(ops, name) for name in TP_KERNELS}

    def attention(q, k, *args, **kwargs):
        seen["flash_attention"].add((q.shape[1], k.shape[1]))
        return real["flash_attention"](q, k, *args, **kwargs)

    def channels(name):
        def run(x, *args, **kwargs):
            seen[name].add(x.shape[-1])
            return real[name](x, *args, **kwargs)
        return run

    ops.flash_attention = attention
    ops.rglru_scan = channels("rglru_scan")
    ops.mamba_scan = channels("mamba_scan")

    def restore():
        for name, fn in real.items():
            setattr(ops, name, fn)

    return seen, restore


def _logits_recorder():
    """Wrap ``model.prefill`` and ``model.decode_step`` so that the logits
    the serving engine samples from are kept (on a mesh this rank's vocab
    shard): the prefill's last row, each decode step's.  Returns (the
    list, a function that unwraps)."""
    from repro_torch.models import model as M

    real, rows = (M.prefill, M.decode_step), []

    def prefill(cfg, params, batch, *args, **kwargs):
        out = real[0](cfg, params, batch, *args, **kwargs)
        rows.append(out[0][0, batch["tokens"].shape[1] - 1].clone())
        return out

    def decode_step(*args, **kwargs):
        out = real[1](*args, **kwargs)
        rows.append(out[0][0, -1].clone())
        return out

    M.prefill, M.decode_step = prefill, decode_step

    def restore():
        M.prefill, M.decode_step = real

    return rows, restore


def tp_serving(device, mesh, arch, depth=None, prompt_len=TP_PROMPT,
               steps=TP_DECODE, cfg=None):
    """16b, on this rank: ``arch`` at full width and depth ``depth``
    (default: one pattern group plus the tail), padded for the mesh's
    ``"model"`` ranks on both sides, float32 with kernels: one request of
    ``prompt_len`` tokens and ``steps`` decode steps through
    ``ServeEngine(mesh=)`` and through the one-device engine on the same
    weights.  Returns what the parent checks."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config, padded_for_tp
    from repro_torch.models import model as M
    from repro_torch.models.sharding import local_range
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    base = cfg or get_config(arch)
    depth = depth or len(base.pattern) + len(base.tail)
    cfg = padded_for_tp(dataclasses.replace(base, n_layers=depth), TP_MESH[1])
    params = M.init(cfg, torch.Generator(device=device).manual_seed(16),
                    device=device, dtype=torch.float32)
    prompt = np.random.default_rng(16).integers(0, cfg.vocab, size=prompt_len)
    scfg = ServeConfig(slots=1, max_len=prompt_len + steps + 1,
                       compute_dtype=torch.float32, use_kernels=True)
    kernels = _lm_kernels()
    out = {}
    for label, on_mesh in (("one device", None), ("mesh", mesh)):
        rows, unwrap = _logits_recorder()
        seen, unwrap_widths = _width_recorder()
        for w in kernels.values():
            w.launches = 0
        try:
            engine = ServeEngine(cfg, params, scfg, device=device,
                                 mesh=on_mesh)
            engine.submit(Request(0, prompt, 1 + steps))
            done = engine.run()
            _sync(device)
        finally:
            unwrap()
            unwrap_widths()
        out[label] = {"tokens": done[0].output, "rows": rows,
                      "launches": {k: kernels[k].launches
                                   for k in TP_KERNELS},
                      "widths": {k: sorted(v) for k, v in seen.items()}}
        del engine
    lo, hi = local_range(out["mesh"]["rows"][0].shape[-1], mesh)
    atol, rtol = MODEL_TOL
    errs, oks = [], []
    for got, want in zip(out["mesh"]["rows"], out["one device"]["rows"]):
        ok, err = _close(got, want[lo:hi], atol, rtol)
        oks.append(ok and bool(torch.isfinite(got).all()))
        errs.append(err)
    per_call = expected_launches(cfg)
    expect = {k: per_call[k][0] + steps * per_call[k][1] for k in TP_KERNELS}
    del params
    free_device_memory(device)
    return {"arch": cfg.name, "depth": depth, "vocab_shard": [lo, hi],
            "tokens": out["mesh"]["tokens"],
            "tokens_one_device": out["one device"]["tokens"],
            "logits_ok": oks, "logits_err": errs,
            "launches": out["mesh"]["launches"], "expected": expect,
            "widths": out["mesh"]["widths"],
            "widths_one_device": out["one device"]["widths"]}


def tp_rank_main(rank: int, workdir: str) -> None:
    """One rank of phase 16, in a process of its own: 16a and 16b, the
    results written to ``workdir``/``rank<R>.json``."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    import repro_torch

    device, mesh = _tp_join(rank, workdir)
    repro_torch.set_default_device(device)
    try:
        t = time.perf_counter()
        gap, worst, n = tp_float32_cut(device, mesh)
        free_device_memory(device)
        losses, walls, peak = tp_train_steps(device, mesh)
        free_device_memory(device)
        t16a = time.perf_counter() - t
        serving = [tp_serving(device, mesh, arch, depth)
                   for arch, depth in TP_SERVE]
        result = {"rank": rank, "loss_gap": gap, "worst_grad": worst,
                  "leaves": n, "losses": losses, "walls": walls,
                  "peak": peak, "t16a": t16a,
                  "t16b": time.perf_counter() - t - t16a,
                  "serving": serving,
                  "torch": torch.__version__}
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def phase_tensor_parallel(device, mesh_14d=None):
    """Phase 16: the mesh layout on the card, ``TP_MESH`` = (data 1, model
    2): two processes on the one H100 over gloo with CUDA tensors (NCCL
    refuses two ranks on one device), each running :func:`tp_rank_main`.
    16a: Qwen3-1.7B's float32 depth-2 cut on the mesh against one device
    (loss rtol ``TRAIN_LOSS_RTOL``, every gradient shard atol
    ``TRAIN_GRAD_TOL`` of the leaf's largest entry, phase 11b's bar), then
    bf16 AdamW steps at depth 4 (losses finite, walls and peak per rank
    beside phase 14d's); 16b: RecurrentGemma and Falcon-Mamba through
    ``ServeEngine(mesh=)`` with kernels against one device (the same
    greedy tokens, logits at ``MODEL_TOL``, every kernel launched on every
    rank in every layer that has one).  Returns the mesh runs' launches by
    kernel, summed over the ranks."""
    import math
    import os
    import shutil
    import tempfile

    print(f"== phase 16: tensor parallelism on the card, a (data, model) = "
          f"{TP_MESH} mesh of {math.prod(TP_MESH)} processes on one card "
          "over gloo", flush=True)
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs, logs = [], []
    try:
        for r in range(math.prod(TP_MESH)):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--tp-rank",
                 str(r), workdir], stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + TP_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results = []
    for r, p in enumerate(procs):
        text = open(os.path.join(workdir, f"rank{r}.log")).read()
        if p.returncode != 0:
            print(f"-- phase 16 rank {r} (rc {p.returncode}):\n{text[-8000:]}")
        check(p.returncode == 0, f"16: rank {r} exited {p.returncode}")
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: 0 for k in TP_KERNELS}
    for res in results:
        r = res["rank"]
        check(res["loss_gap"] <= TRAIN_LOSS_RTOL, f"16a rank {r}: loss "
              f"{res['loss_gap']} from one device's (over {TRAIN_LOSS_RTOL})")
        check(res["worst_grad"] <= TRAIN_GRAD_TOL, f"16a rank {r}: a gradient "
              f"shard {res['worst_grad']} of its leaf's largest entry from "
              f"one device's (over {TRAIN_GRAD_TOL})")
        check(all(math.isfinite(v) for v in res["losses"]),
              f"16a rank {r}: losses {res['losses']}")
        print(f"16a rank {r} (torch {res['torch']}): float32 depth "
              f"{TP_CUT_DEPTH} loss {res['loss_gap']!r} relative from one "
              f"device's, {res['leaves']} gradient shards, worst "
              f"{res['worst_grad']!r} of the leaf's largest entry; bf16 "
              f"depth {TP_STEPS_DEPTH}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
              f"losses {res['losses']!r}, step walls {res['walls']!r} s, "
              f"peak {res['peak'] / 1e9!r} GB allocated by this rank; "
              f"16a {res['t16a']:.1f} s, 16b {res['t16b']:.1f} s", flush=True)
        for srv in res["serving"]:
            label = f"16b rank {r} {srv['arch']} depth {srv['depth']}"
            check(srv["tokens"] == srv["tokens_one_device"],
                  f"{label}: tokens {srv['tokens']} on the mesh, "
                  f"{srv['tokens_one_device']} on one device")
            check(all(srv["logits_ok"]), f"{label}: logits max |err| "
                  f"{srv['logits_err']} over {MODEL_TOL}")
            check(srv["launches"] == srv["expected"], f"{label}: launches "
                  f"{srv['launches']}, every layer's kernels "
                  f"{srv['expected']}")
            check(any(srv["launches"].values()), f"{label}: no kernel launched")
            print(f"{label}: tokens {srv['tokens']} (one device "
                  f"{srv['tokens_one_device']}); logits (vocab shard "
                  f"{srv['vocab_shard']}) max |err| {srv['logits_err']!r} "
                  f"(atol, rtol {MODEL_TOL}); launches {srv['launches']} "
                  f"(every layer: {srv['expected']}); local widths "
                  f"{srv['widths']} (one device {srv['widths_one_device']})",
                  flush=True)
            for k in TP_KERNELS:
                launches[k] += srv["launches"][k]
    losses = [res["losses"] for res in results]
    check(all(v == losses[0] for v in losses),
          f"16a: the ranks' losses differ: {losses}")
    if mesh_14d:
        warm = [rec["s"] for rec in mesh_14d[1:]]
        print(f"16a beside 14d (--mesh 1x1, one process, the same depth and "
              f"tokens): 14d warm step walls {warm!r} s")
    print(f"phase 16: {time.perf_counter() - t:.1f} s; mesh launches summed "
          f"over the ranks {launches}", flush=True)
    return launches


def free_device_memory(device) -> None:
    """Return what the finished phases held to the card."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"device memory allocated after freeing: "
              f"{torch.cuda.memory_allocated(device) / 1e9!r} GB")


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
    flash_build = phase_environment()
    reducer_inputs, launches = phase_main_path(device)
    entries = [phase_segment_sum(device, reducer_inputs, launches)]
    phase_batched_solver(device)
    solver_device_share(device)
    served = phase_serving(device)
    entries += phase_lm_kernels(device, served)
    phase_model_kernels_vs_plain(device)
    free_device_memory(device)
    served = phase_serving(device, MAMBA_ARCH, fixed=MAMBA_PROMPTS, phase="7")
    entries.append(phase_mamba_kernel(device, served))
    phase_model_kernels_vs_plain(device, MAMBA_ARCH, depth=4, phase="8b")
    free_device_memory(device)
    granite = phase_serving(device, GRANITE_ARCH, fixed=GRANITE_PROMPTS,
                            phase="9")
    moe, flash_granite = phase_moe_kernel(device, granite)
    entries.append(moe)
    phase_moe_model(device)
    free_device_memory(device)
    phase_training(device)
    free_device_memory(device)
    phase_training_float32_cut(device)
    phase_checkpoint_resume(device)
    phase_grad_guard(device)
    free_device_memory(device)
    jobs, joint, schedule_launches = phase_schedule(device)
    online = phase_online(device, jobs, joint)
    phase_card_vs_cpu(device, jobs, joint, *online)
    t13 = time.perf_counter()
    alphas, out_scales, recorded, pipeline_launches = phase_pipeline(device)
    phase_pipeline_schedule(device, jobs, alphas, out_scales)
    phase_pipeline_card_vs_cpu(device, recorded)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    free_device_memory(device)
    moe["launches_by_path"] = {GRANITE_ARCH: moe["launches"],
                               "expert parallel (14b)": 0}
    for w in _lm_kernels().values():
        w.launches = 0
    (ep_launches, one_launches), mesh_14d = phase_multidevice(device)
    counted = {k: w.launches for k, w in _lm_kernels().items()}
    check(counted == {k: ep_launches[k] + one_launches[k] for k in counted}
          and ep_launches["moe_dispatch"] > 0, f"phase 14 counted {counted} "
          f"launches, its prefills {ep_launches} expert parallel and "
          f"{one_launches} on one device")
    free_device_memory(device)
    phase_dryrun(device)
    free_device_memory(device)
    tp_launches = phase_tensor_parallel(device, mesh_14d)
    moe["launches_by_path"]["expert parallel (14b)"] = ep_launches["moe_dispatch"]
    moe["launches"] += ep_launches["moe_dispatch"]
    segsum = entries[0]
    segsum["launches_by_path"] = {"GeoJob": segsum["launches"],
                                  "GeoSchedule": schedule_launches,
                                  "GeoPipeline": pipeline_launches}
    segsum["launches"] += schedule_launches + pipeline_launches
    flash = next(e for e in entries if e["name"] == "flash_attention")
    flash["launches_by_path"] = {SERVE_ARCH: flash["launches"],
                                 GRANITE_ARCH: granite["flash_attention"]}
    flash["launches"] += granite["flash_attention"]
    flash["launches_by_path"]["expert parallel (14b)"] = \
        ep_launches["flash_attention"]
    flash["launches"] += ep_launches["flash_attention"]
    flash["max_abs_err"] = max(flash["max_abs_err"], flash_granite["max_abs_err"])
    flash["granite_prefill"] = flash_granite
    flash["bf16_tensor_core_build"] = flash_build
    for e in entries:
        if e["name"] in tp_launches:
            e.setdefault("launches_by_path", {"serving": e["launches"]})
            e["launches_by_path"]["tensor parallel (16b)"] = \
                tp_launches[e["name"]]
            e["launches"] += tp_launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":
        tp_rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
