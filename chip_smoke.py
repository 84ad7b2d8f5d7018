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
   just after.
3. ``segment_sum`` against its plain version on the card, at the shapes the
   main path gave it (every reducer's input, recorded) and at stress
   shapes: unsorted and out-of-range ids, ids and values at storage
   offsets that are not 16 bytes, one id for a million rows, a reducer
   without in-mapper combining (a hot id), and wide rows in float32 and
   bfloat16; with the kernel's ``ptxas`` registers and spills.  Times are
   CUDA-event medians, the wrapper's taken in turns with its PyTorch call's,
   the device's also queued behind a sleep kernel.
4. Batched solver: 64 PlanetLab platforms planned in one batched solve;
   every plan valid and never worse than uniform.  (Phase 22, which runs
   next, profiles a solve: its busy share and device events a step.)
5. Serving, the LM path: RecurrentGemma-9B at full width and depth (38
   layers, d_model 4096, vocab 256000), random bfloat16 weights from a
   seeded generator (in the whole script phase 20a's float32 weights,
   cast), through ``ServeEngine`` (4 slots, max_len 4096): 8
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
   them in a process of its own (both at the prefill, the rescan alone
   at a decode step), and times (for
   ``flash_attention`` also one call alone: CUDA events around a single
   launch after a synchronize, median of 20; the launches queued on the
   card behind a sleep kernel; and the CUDA-core kernel that served bf16
   before, called through its C entry).  The full-width float32 model,
   kernels against plain versions, is phase 20a's full-depth hold (it
   took the place of phase 6b's cut to depth 5, whose function
   ``phase_model_kernels_vs_plain`` the other cuts run).
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
    are held to the model tolerance at every position: as run where no
    choice differs, else with the plain run's choices pinned (a flipped
    choice moves other tokens' capacity slots).

11. Training, after Granite's weights are freed: Qwen3-1.7B at full width
    and depth (28 layers, d_model 2048, vocab 151,936, 1.72 B parameters)
    through ``repro_torch.launch.train``: 8 AdamW steps of 4 x 2048 tokens
    from the Zipf(1.3) synthetic stream, bf16 compute over float32 masters,
    remat, the geo-planned ingest solved on the card (11a).  Every loss and
    grad norm must be finite, the mean of the last two losses below the
    first, peak device memory under 80 GB; it prints the step walls,
    tokens/s and ``train_mfu`` (``phase_training(profile=True)`` also
    profiles a warm step and times the float32 chunked attention's share
    alone; PERF.md holds those, and the whole script leaves them out).
    Then a
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
    ``min_max_slowdown``) at 24 x 50, simulated and executed: word counts
    exact, every non-empty reducer of every job launching ``segment_sum``
    (counted from 0), every plan valid, joint's modeled aggregate no worse
    than independent's, the fair objective's worst slowdown no worse than
    independent's; the joint solve's first wall.  12b: on the same
    substrate, two shuffle links into the frozen joint plan's busiest reducer step down 250x at half its
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
    probe run; planned ``stagewise`` and ``end_to_end`` at 24 x 50,
    simulated and executed: every stage's outputs equal numpy's chain,
    every non-empty reducer of every stage launches ``segment_sum``
    (counted from 0), every plan valid, ``end_to_end`` no worse modeled,
    every makespan finite; the ``end_to_end`` plan's first wall; then the
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
    ``plan_moe_dispatch`` (the example's 8 groups) at 8 x 300 on the card
    (the first call's wall): never worse than uniform, the slow pod's
    share under 0.15, and each est within 1e-3 of the band the CPU's plans at 296-304
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
16. The tensor-parallel layout on two processes sharing the card (see
    :func:`phase_tensor_parallel`).
17. The port's examples on the card, each run in this process through
    ``runpy`` with its own ``sys.argv`` and ``--device`` set to the card.
    17a ``examples/port_multijob.py``: every plan valid, ``joint`` no worse
    modeled than ``independent``, the modeled and simulated makespans
    within 1e-3 of the reference's.  17b ``port_online.py``: the frozen,
    static, reactive, horizon and solo makespans within 1e-3 of the
    reference's, ``reactive_shared`` and ``shared, no hysteresis`` within
    the reference's own spread there, 3.8e-3 (its co-replan has not
    settled: another seed moves it that far),
    ``reactive`` below the frozen joint plan, ``reactive_incremental``
    (the card's measured solve charge) finite with swaps no more than
    decisions.  17c ``port_pipeline.py``: its two asserts, the makespans
    within the reference's own spread of the reference's (its anneal has
    not settled either: 1e-7 or 1e-6 of one bandwidth moves stagewise by
    up to 4.3e-3, end_to_end by up to 1.2e-3).
    17d ``port_planner_service.py``: none of 8 incremental replans modeled
    worse than its incumbent, the solver counters the reference's, the
    walls printed.  17e ``port_serve_lm.py`` (reduced Qwen3, float32): 12
    requests of 16 tokens in the vocabulary, ``flash_attention`` launched
    once per attention layer per admission and no other kernel, each
    launch's output (the float32 Dh-16 kernel) within the float32 kernel
    tolerance of ``attention_ref`` on its inputs.  17f
    ``port_train_lm.py`` for 60 steps, then for 110 in the same
    checkpoint directory: the second run resumes from step 60, every loss
    finite, its last two losses below the first run's first, no kernel
    launched.

18. First (18w) bf16 ``flash_attention`` at head widths off the 64-column
    grid (``FLASH_WIDTH_CASES``): Dh 40, 80, 96 and 192 must resolve the
    ``wgmma`` kernel and Dh 36 the CUDA-core one, one launch each, held to
    the plain version at ``KERNEL_TOL`` with causal and windowed masks,
    ``q_offset``s, GQA and T and S off the tiles.  Then the six model
    families no earlier phase runs, each at full width
    (``CARD_ARCHS``), the card's memory freed between them: 18a OLMo-1B
    (non-parametric LayerNorm, tied embeddings, Dh 128), 18b StableLM-1.6B
    (LayerNorm with bias, Dh 64), 18c Mistral-NeMo-12B (GQA 32:8, Dh 128),
    18d Llama4-Scout-17B-A16E at depth 8 (two iRoPE groups: windowed RoPE
    layers at 8192 and a global NoPE layer; a top-1 MoE over 16 experts),
    18e Phi-3-vision-4.2B (Dh 96, ``wgmma`` padded to 128) and 18f
    MusicGen-large (GELU MLP; both take stub-frontend ``embeds``).  Each
    is served in bfloat16 with the kernels: the token-in archs through
    ``ServeEngine`` as phase 9 (4 slots, prompts of 1, 17, 2048 and 3000
    tokens; Llama4-Scout 1, 17, 3000 and 9000 at ``max_len`` 9216, past
    its window; 32 new tokens each), the two others by ``model.prefill``
    of 3000 seeded embeds and 32 ``model.decode_step`` calls.  Tokens in
    the vocabulary, finite logits, ``flash_attention`` (and Llama4's
    ``moe_dispatch``) launches exact per admission and per step, every
    launch resolving the expected C entry (``flash_attention_bf16_wgmma``
    at every served width, Dh 96 included), init and serving peaks
    under 80 GB.  Then ``flash_attention`` at each arch's prefill shape in
    both dtypes (Llama4-Scout with and without its window) and
    ``moe_dispatch`` at Llama4-Scout's, against their plain versions and
    timed as in phases 6a and 10a; a float32 cut (depth 2; NeMo 1;
    Llama4-Scout 4 with a 9000-token prefill, held as phase 10b) against
    the plain versions; OLMo and MusicGen trained as phase 11a (8 AdamW
    steps of 4 x 2048; MusicGen at a peak lr of 3e-5, where 3e-4
    diverges), and OLMo, StableLM, Phi-3 and MusicGen's float32 training
    cut as phase 11b.  Each arch's reckoned bytes at full width
    are printed and must be under 80 GB.
19. The reference's long shapes (``configs.SHAPES``: ``prefill_32k``,
    ``decode_32k``, ``long_500k``), each sub-phase right after its arch's
    serving phase on the same bf16 weights: 19a RecurrentGemma-9B (after
    5), 19b Falcon-Mamba-7B (after 7), 19c Granite-MoE-3B-A800M (after 9),
    at full width and depth with the kernels.  Served through
    ``ServeEngine`` (4 slots, ``max_len`` 32,800): prompts of 32,768, 17,
    2049 and 3000 tokens, 32 new tokens each, checked as phase 5, with the
    32,768-token prefill and a decode step profiled.  Then each kernel the
    arch's layers launch at its 32k shape in bfloat16 and float32, against
    its plain version at ``KERNEL_TOL`` (``flash_attention`` on 512-row
    query slices through ``q_offset``; ``mamba_scan`` on every 65th
    channel, on a CPU copy; ``moe_dispatch``'s 262,144 rows into (40,
    8192, 1536) bit for bit), its bound and its time in the served
    prefill beside the plain version's (its own times at these shapes are
    in PERF.md).  For the two sub-quadratic archs, ``long_500k`` as the
    reference's dry run lowers it: a zeroed float32 cache of 524,288
    positions whose bytes equal ``cache_specs``' stand-in's, 8 decode
    steps at positions 524,280-524,287 (tokens, finite logits, launches
    each step), and a float32 cut (RecurrentGemma depth 3 without the
    tail, Falcon-Mamba depth 2) through the same steps, kernels against
    plain versions at the model tolerance.  A prefill of 524,288 tokens
    does not fit one card (PERF.md), and neither package continues a
    prefill from a cache.
20. The reference's default serving dtype, float32, at full width and
    depth: 20a RecurrentGemma-9B (before phase 5), 20b Falcon-Mamba-7B
    (before 7), 20c Granite-MoE-3B-A800M (before 9), 20d Qwen3-1.7B (after
    10).  Each runs ``repro_torch.launch.serve.main(["--arch", arch])`` as
    a user does, at the reference launcher's defaults (8 requests of 4-23
    tokens, 4 slots, ``max_len`` 256, 16 new tokens, seed 0): tokens in the
    vocabulary, finite logits, launches per admission and per decode step
    as ``expected_launches`` gives, each launch on its kernel's float32 C
    entry, float32 matmuls without TF32, init and serving peaks under 80
    GB, with the tokens/s, decode steps and a profiled decode step.  On
    the launcher's weights (kept by a wrapper of ``model.init``), the
    full-depth hold: a prefill (3000 tokens; Falcon-Mamba 512) and three
    decode steps, kernels against plain versions at the model tolerance
    (Granite under phase 10b's routing rule), each layer's hidden-state
    gap printed; then the prefill as the engine runs it, profiled.  The
    weights' bf16 cast, which equals ``bf16_weights``' bit for bit, serves
    phases 5, 7 and 9 and their long shapes (19).
21. Training through the reference's launcher on the three block families
    no earlier phase trains (after phase 11), each at full width, the card's
    memory freed between them (``TRAIN_ARCHS``): 21a Granite-MoE-3B-A800M
    at full depth (the MoE FFN: router, top-8 gates, capacity drops,
    dispatch and combine, z-loss), 21b Falcon-Mamba-7B at 24 of 64 layers
    with ``--remat`` (the Mamba block), 21c RecurrentGemma-9B at 8 of 38
    (two RG-LRU, RG-LRU, local attention groups and the RG-LRU tail).  Each
    calls ``repro_torch.launch.train.main`` at the reference launcher's
    defaults (``--batch 8 --seq 128 --lr 3e-4``, float32) for 6 steps after
    2 warm-up steps, its config cut by depth alone: the step's bytes are
    reckoned from the config first (``train_bytes``: state, AdamW's
    temporaries, logits, kept activations) and must be under 80 GB; every
    loss and grad norm finite, the mean of the last two losses below the
    first, the peak under 80 GB, no LM kernel launched (counted from 0);
    the init's wall, step walls, tokens/s and the peak printed.  21d: each
    arch's float32 cut, loss and every gradient on the card against the
    CPU at B = 1, T = 128 and phase 11b's bars (Granite and Falcon-Mamba
    at depth 2, RecurrentGemma at depth 3 without the tail: one group, one
    local attention layer), Granite's (token, layer) routing choices that
    differ between the two counted, and where any do, held with the CPU
    run's choices pinned on both sides.
22. The paper's own evaluation (after phase 4), as the reference's
    ``benchmarks/paper_figures.py`` runs it: 16 restarts x 400 steps, seed
    0, each planner mode under a barrier setting one ``optimize_plan_batch``
    call on the card.  22a (Figs 5, 6, 8): ``myopic_multi`` (its push round,
    then its shuffle round from the push round's x, on the card),
    ``e2e_push``, ``e2e_shuffle`` and ``e2e_multi`` under all-global
    barriers over 13 PlanetLab platforms (1, 2, 4 and 8 sites at alpha
    0.1, 1 and 10, and 8 sites at alpha 2), ``uniform`` and ``local_push``
    through the same front door, and a warm repeat of ``e2e_multi``'s call.
    22b (Fig 7): ``e2e_multi`` under PGG, GPG, GGP and PPP at 8 sites.  22c
    (Fig 4): 22a's 8-site ``e2e_multi`` plans at alpha 0.1, 1 and 2 and
    ``uniform``, each priced through ``GeoJob.with_plan`` under GPL, PPL,
    PGL and GGL and simulated at 32 MB chunks; R^2 and slope printed beside
    the reference's.  22d (Fig 9): word count (phase 2's run), then
    sessionization (gap 1000) of 4M log entries of 40,000 users and the
    full inverted index of a 4M-word corpus, each calibrated, then executed
    under ``uniform``, ``local_push`` and ``e2e_multi`` at GGL (the two
    calibrated platforms and Fig 10's planned in one batched call).  22e
    (Fig 10): the GGL plan at 8 sites and alpha 1 and ``local_push`` under
    a mapper slowed 4x, static, with speculation and with stealing too,
    printed beside the reference's.  Every modeled makespan within 1e-3 of
    the reference's (``PAPER_REF``), or where the reference's anneal has
    not settled within its plans' band (``PAPER_BAND``, ``paper_bar``); none
    worse than uniform; the one-site modes all equal; ``e2e_multi`` within
    1% of every other mode and each relaxed optimum within 1% of the
    all-global one; each solver call's 25 steps on the card against the CPU
    from its own inputs (x, y atol 1e-4, the exact objective rtol 1e-4);
    the sessions' cut points and the postings equal numpy's over the whole
    corpus in every execution, ``model_error`` finite, the optimized plan's
    measured makespan below both baselines'.  It prints each batched call's
    wall, the busy share and device events a step of a 25-step solve, each
    app's walls and the paper's reductions beside the card's.
23. The control plane at the reference's scale (beside 14 to 16), as the
    reference's ``benchmarks/paper_figures.py`` builds its scenarios, at
    its ``--quick`` budget of 6 restarts x 200 steps (``CONTROL_OPT``).
    23a: Fig 12's three DES runs (local_push with 1, 2 and 3 replicas),
    equal to the reference's bit for bit; ``schedule_failover`` (a reducer
    killed mid-shuffle, then a cluster partitioned until 400 s, 2
    replicas, audited) under ``reactive_shared`` and ``reactive_failover``,
    and ``schedule_online_shared`` (a late job stuck on a reducer, a drift,
    two nuisance steps) under ``reactive``, ``reactive_shared`` and
    hysteresis-free co-replanning, each online run with the solve charge
    pinned (``CONTROL_CHARGE_S``; its frozen, online and static makespans
    within 1e-3 of the reference's, ``REF_CONTROL``, or where the
    reference's anneals have not settled within its own spread over other
    ``run_online`` seeds and a 1e-7 move of one bandwidth,
    ``REF_CONTROL_SPREAD``) and with the measured
    EMA's (printed with its swaps, rejections and charge); every plan
    valid, and at no adopted decision anything modeled worse than what it
    replaced.  23b: the planner service (``bench_planner``): a cold and 8
    warm solves at 6 x 203, a B = 8 ``optimize_plan_batch``, and
    ``replan_batch`` full and incremental at 6 x 500, best of 3, each
    timed between two synchronizations: every plan never worse than
    uniform, no replan worse than its incumbent, the solver counters the
    reference's; alone, the process's first solve split into its parts in
    a fresh process (``--first-solve``; CUDA's lazy module loading and
    eager).  23c: ``online_1000``, 996 nodes (480 edges, 336 mappers, 180
    reducers), 100 fluid jobs, a backbone-wide reducer brownout to 5% at
    250 s, 90 jobs live and 10 arriving at 300 s and 480 s,
    ``reactive_shared`` co-replanning incrementally (4 restarts x the 16
    most-behind jobs x 8 steps a decision) at a pinned 5 s charge: its
    decisions and swaps the reference's or within their range over other
    seeds (``REF_SCALE_SPREAD``), its makespan within its bar, a positive
    online margin, every plan valid, the wall against the reference's 60 s
    budget and the peak device memory printed; one decision's anneal at
    full size held on the card against the CPU in float64 (x, y atol
    1e-4, the exact objective rtol 1e-4; float32 rounding alone moves x
    past 1e-4 there, so the float32 distances are printed) and profiled:
    busy share and device events a step.  No kernel launches in phase 23.
    In the whole script its three parts run at once, each in a process of
    its own (``--control-part``), started before phase 14 and waited for
    after phase 16; alone (``scripts/run_phases.py 23``) in turn.

After the phases, one ``{"kernels": [...]}`` line lists every kernel; the
scans' entries time the float32 prefill inputs the bf16 models now give
them (the bf16 prefill beside), and ``moe_dispatch``'s and
``flash_attention``'s launches add those of 14b's expert-parallel
prefills (``flash_attention``'s also 17e's) and of phase 18's serving,
with phase 18's shapes' errors (``card_archs``; their times are in
PERF.md) and ``llama4-scout-17b-a16e_prefill``; each LM kernel's add
those of phase 19's serving and ``long_500k`` steps, with its 32k shapes' errors and
times (``long_32k``, by arch), and those of phase 20's float32 serving
through the launcher, with each kernel's device ms a launch in the
float32 prefill (``float32_in_place_ms``, by arch).

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
#: when the script started
_T0 = time.perf_counter()

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor
#: core) operations/s and dense bfloat16 tensor-core operations/s, at the
#: full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: dense TF32 tensor-core operations/s (same data sheet); float32 attention
#: at float32 accuracy takes three TF32 products for each one (split-TF32)
TF32_OPS_PER_S = 495e12

#: the reference's kernel tolerances (tests/test_kernels.py:19-20): the
#: kernels sum in another order than their plain versions
KERNEL_TOL = {"torch.float32": (2e-5, 1e-2), "torch.bfloat16": (2e-2, 1e-2)}
#: float32 model logits, kernels against plain versions: the same float32
#: sums in another order, carried through a cut's full-width layers (phase
#: 20: every layer) and the unembedding
MODEL_TOL = (1e-3, 1e-3)

#: main-path scale: the paper's 8-DC testbed and a 20M-word corpus
N_DOCS, WORDS_PER_DOC, VOCAB = 20_000, 1_000, 1 << 20
N_RESTARTS, STEPS = 24, 500
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
#: its peak learning rate, after 2 warm-up steps
TRAIN_LR = "3e-4"
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
#: multi-job schedules (phase 12): four tenants, every built-in schedule
#: policy (joint under both objectives); online re-planning at run_online's
#: default 8 restarts, at the steps below
SCHED_JOBS = 4
SCHED_POLICIES = (("independent", "makespan"), ("sequential", "makespan"),
                  ("joint", "makespan"), ("joint", "min_max_slowdown"))
ONLINE_RESTARTS, ONLINE_STEPS = 8, 50
#: the schedules' and pipelines' plans (phases 12 and 13): the paper's 24
#: restarts at a tenth of its 500 steps (so that a slow host's whole run,
#: phase 21's training included, stays under 1150 s), and run_online
#: (above) at a quarter of its default 200 steps.  The solves are
#: host-bound, their walls in proportion to the steps; their checks hold
#: by construction at any count.  The main path (phase 2) and the batched
#: solver (phase 4) keep 24 x 500.
SCHED_RESTARTS, SCHED_STEPS = 24, 50
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


def trace_complete(recorded, counted) -> bool:
    """Whether a profiler session's trace holds every launch of a kernel:
    ``recorded`` is the launches it recorded by kernel name, ``counted``
    the launches the wrapper counted over the same calls.  A call launches
    each of its kernels once, or one of them not at all (``rglru_scan``'s
    chunk pass where one chunk covers T, ``moe_dispatch``'s small path), so
    each name holds ``counted`` launches or none, and one name holds
    ``counted``.  A trace with fewer is partial: no device time is read
    from it."""
    return counted > 0 and all(n in (0, counted) for n in recorded.values()) \
        and max(recorded.values(), default=0) == counted


def kernel_device_ms(fn, names, *, wrapper, calls: int = 20,
                     recorded_per_call=None, sessions: int = 3):
    """Mean device time of one call of ``fn``, from ``torch.profiler`` over
    ``calls`` calls: for each kernel name in ``names`` (a substring of the
    CUDA kernels' names; one string or several, for a call that launches
    several kernels or one of several), its device time over the launches
    the profiler recorded, summed over the names it recorded; ``None``
    where no session's trace was complete.  ``wrapper`` counts the
    launches (its ``.launches``: a kernel wrapper, or
    ``cuda_core_attention``); a session whose trace holds fewer than it
    counted over the same calls (``trace_complete``) gives no device time,
    and is made again, up to ``sessions`` in all; where none was complete,
    the calls' time queued on the card is printed instead, labelled as
    queued.  Where ``recorded_per_call`` is a dict, it gets each name's
    launches the last session recorded, over ``calls``; it stays empty
    where the profiler cannot trace.

    Each session traces a warm-up step of ``calls`` calls whose events it
    drops before the ``calls`` it keeps: a session started without one
    missed the first launches after it enabled its tracing (on an H100 it
    recorded 3 or 4 of 5 calls' launches, and once none)."""
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
                    before = wrapper.launches
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
                counted = wrapper.launches - before  # the kept step's
        except RuntimeError as exc:  # the profiler cannot trace this machine
            print(f"  profiler unavailable: {exc}")
            return None
        events = prof.key_averages()
        recorded = {name: sum(ev.count for ev in events if name in ev.key)
                    for name in names}
        if recorded_per_call is not None:
            recorded_per_call.update({name: n / calls
                                      for name, n in recorded.items()})
        if trace_complete(recorded, counted):
            break
        print(f"  profiler session {session} of {sessions} recorded "
              f"{recorded} launches in {calls} calls, where the wrapper "
              f"counted {counted}: no device time from it")
    else:
        queued = time_queued_ms(fn, calls=calls)
        print(f"  no complete trace of {' or '.join(names)}: {queued!r} ms a "
              f"call queued on the card (queued time of the whole call, not "
              f"a device time)")
        return None
    per_call = None
    for name in names:
        total_us = sum((getattr(ev, "device_time_total", None)
                        or getattr(ev, "cuda_time_total", 0.0))
                       for ev in events if name in ev.key)
        if total_us > 0:
            per_call = (per_call or 0.0) + total_us / counted / 1e3
            if len(names) > 1:
                print(f"  {name}: {total_us / recorded[name] / 1e3!r} ms a "
                      f"launch, {recorded[name]} launches recorded")
    if per_call is None:
        print(f"  the profiler recorded no device time of "
              f"{' or '.join(names)} in {calls} calls")
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
#: the float32 split-TF32 tensor-core kernel, by the name its
#: instantiations carry in the build log, the SASS and the profiler
FLASH_F32 = "flash_attention_kernel_tf32x3"
#: the CUDA-core kernel's float32 instantiations, demangled or not
FLASH_F32_BEFORE = ("flash_attention_kernel<float", "flash_attention_kernelIf")


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


def sass_counts(so: Path, opcodes=("HGMMA", "UTMALDG", "HMMA")):
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


def _template_ints(mangled: str) -> tuple:
    """The integer template arguments of a mangled name, in order."""
    import re

    return tuple(int(x) for x in re.findall(r"Li(\d+)E", mangled))


def _instance(mangled: str) -> str:
    """A flash_attention instantiation's label: its head width, and for the
    bf16 ``wgmma`` kernel (padded width, k-steps) also the k-steps of
    Q Kᵀ ("Dh 128, 6 k-steps": Dh 81 to 96)."""
    ints = _template_ints(mangled)
    label = f"Dh {ints[0]}" if ints else "Dh ?"
    return label + (f", {ints[1]} k-steps" if len(ints) > 1 else "")


def check_flash_build(so: Path):
    """Registers and spills of the tensor-core instantiations, bf16
    (``wgmma``, one per padded width and k-steps of Q Kᵀ) and float32
    (split-TF32 ``mma.sync``), and their tensor-core (HGMMA, HMMA) and TMA
    (UTMALDG) instructions; fails if a bf16 kernel has no HGMMA or a
    float32 one no HMMA.  Returns what it read, by kernel and
    instantiation."""
    from repro_torch.kernels import _build

    log = ptxas_usage(_build.build_log("flash_attention"))
    counts = sass_counts(so)
    if counts is None:
        print("cuobjdump not found next to nvcc: the SASS check of HGMMA "
              "and HMMA instructions is skipped")
    found = {}
    for kernel, op in ((FLASH_WGMMA, "HGMMA"), (FLASH_F32, "HMMA")):
        usage = {fn: u for fn, u in log.items() if kernel in fn}
        check(usage, f"the build log lists no {kernel} instantiation")
        found[kernel] = {}
        for fn, (regs, st, ld) in sorted(usage.items(),
                                         key=lambda kv: _template_ints(kv[0])):
            found[kernel][_instance(fn)] = {"registers": regs,
                                            "spill_store_bytes": st,
                                            "spill_load_bytes": ld}
            print(f"{kernel}<{_instance(fn)}>: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
        if counts is None:
            continue
        sass = {fn: c for fn, c in counts.items() if kernel in fn}
        check(sass, f"the SASS of {so.name} has no {kernel} function")
        for fn, c in sorted(sass.items(), key=lambda kv: _template_ints(kv[0])):
            print(f"{kernel}<{_instance(fn)}> SASS: {c['HGMMA']} HGMMA, "
                  f"{c['HMMA']} HMMA, {c['UTMALDG']} UTMALDG")
            check(c[op] > 0, f"{kernel}<{_instance(fn)}> has no {op} "
                  "instruction: it does not run on the tensor cores")
            found[kernel].setdefault(_instance(fn), {}).update(c)
    if counts is not None:
        core = sum(c["HGMMA"] + c["HMMA"] for fn, c in counts.items()
                   if FLASH_WGMMA not in fn and FLASH_F32 not in fn)
        print(f"HGMMA and HMMA in the CUDA-core flash_attention_kernel "
              f"instantiations: {core}")
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
    print("card (nvidia-smi name, power.limit):")
    print(card_name_and_limit())
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
    optimized run (what the kernel was given), the launch count and the
    run's Fig 9 row (phase 22d's word count)."""
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

    row = {"opt": f"e2e_multi {n_restarts}x{steps}",
           "alpha": job.platform.alpha, "uniform": uni.makespan_measured,
           "local_push": loc.makespan_measured,
           "e2e_multi": opt.makespan_measured,
           "model_error": opt.model_error()}
    return reducer_inputs, launches, row


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
        dev_ms = kernel_device_ms(run, "segment_sum_", wrapper=segment_sum)
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


def profile_breakdown(fn, label, top=8, warm=False):
    """Where one call of ``fn`` spends its time on the card: host wall,
    device busy share, the ``top`` kernels by device time, and each
    kernel's launches and device time per call in place, read only where
    the trace holds every launch its wrapper counted in the call
    (``trace_complete``).  ``fn`` runs once unprofiled first, unless
    ``warm`` (the caller has just run the same call).  Returns those
    numbers ({"wall_ms", "busy_ms", "events", "in_place": {kernel: ms per
    call}, "partial": [kernels whose trace missed launches]}), or None
    where the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wrappers = _wrappers()
    if not warm:
        fn()
    torch.cuda.synchronize()
    before = {k: w.launches for k, w in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    counted = {k: w.launches - before[k] for k, w in wrappers.items()}
    busy_us, n, by_name = device_activity(prof)
    if not n:
        print(f"profile {label}: wall {wall_us / 1e3!r} ms, device time not "
              "measured (the profiler recorded no device activity)")
        return None
    total = sum(by_name.values())
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3, "events": n,
           "in_place": {}, "partial": []}
    print(f"profile {label}: wall {wall_us / 1e3!r} ms (profiled)  device busy "
          f"{busy_us / 1e3!r} ms  busy share {busy_us / wall_us!r}  device "
          f"events {n}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:10.3f} ms  {us / total:6.1%}  {name[:110]}")
    for kernel, keys in KERNEL_NAMES.items():
        spans = {key: [e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and key in e.name] for key in keys}
        recorded = {key: len(v) for key, v in spans.items()}
        calls = counted[kernel]
        if not calls and not any(recorded.values()):
            continue
        if not trace_complete(recorded, calls):
            print(f"  in place: {kernel}: the trace recorded {recorded} "
                  f"launches where the wrapper counted {calls}: no device "
                  "time from this partial trace")
            out["partial"].append(kernel)
            continue
        us = sum(sum(v) for v in spans.values())
        print(f"  in place: {kernel} {calls} calls "
              f"({sum(recorded.values())} kernels), "
              f"{us / 1e3!r} ms ({us / total:.1%}), "
              f"{us / calls / 1e3!r} ms per call")
        out["in_place"][kernel] = us / calls / 1e3
    return out


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


def _wrappers():
    """Every kernel wrapper by name, whose ``.launches`` count."""
    from repro_torch.kernels.segment_reduce import segment_sum

    return dict(_lm_kernels(), segment_sum=segment_sum)


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


def bf16_weights(device, cfg):
    """``cfg``'s weights in bfloat16 from a seeded generator on ``device``,
    with their size and init's peak device memory printed and the peak
    held under one card's; the peak counter is reset after."""
    import torch
    from repro_torch.models import model as M

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
    return params


def _record_model_calls(device, records):
    """Wrap ``model.prefill`` and ``model.decode_step`` so that each call's
    wall, whether its logits are finite, its T and its launches by LM
    kernel go into ``records["prefill"]`` or ``records["decode"]``, and
    the last decode call's arguments into ``records["last decode"]``.
    Returns a function that unwraps."""
    import torch
    from repro_torch.models import model as M

    kernels = _lm_kernels()
    real = {"prefill": M.prefill, "decode": M.decode_step}

    def timed(kind):
        def run(*args, **kwargs):
            _sync(device)
            before = {k: w.launches for k, w in kernels.items()}
            t0 = time.perf_counter()
            logits, cache, aux = real[kind](*args, **kwargs)
            finite = bool(torch.isfinite(logits).all())
            _sync(device)
            records.setdefault(kind, []).append({
                "s": time.perf_counter() - t0, "finite": finite,
                "T": int(args[2]["tokens"].shape[1]),
                "launched": {k: w.launches - before[k]
                             for k, w in kernels.items()}})
            if kind == "decode":
                records["last decode"] = (args, kwargs)
            return logits, cache, aux
        return run

    M.prefill, M.decode_step = timed("prefill"), timed("decode")

    def restore():
        M.prefill, M.decode_step = real["prefill"], real["decode"]

    return restore


def _check_served(cfg, requests, done, new_tokens, records, launches):
    """The serving checks: every request finished with ``new_tokens``
    tokens in the vocabulary, every logit finite, one prefill a request,
    and each prefill's and decode step's launches, and the run's, as
    ``expected_launches`` gives."""
    check(len(done) == len(requests),
          f"{len(done)} of {len(requests)} requests finished")
    for r in requests:
        check(r.done and len(r.output) == new_tokens,
              f"request {r.rid}: {len(r.output)} tokens, wanted {new_tokens}")
        check(all(0 <= tok < cfg.vocab for tok in r.output),
              f"request {r.rid}: a token outside [0, {cfg.vocab})")
    pre, dec = records.get("prefill", []), records.get("decode", [])
    check(all(x["finite"] for x in pre + dec), "a logit is not finite")
    check(len(pre) == len(requests),
          f"{len(pre)} prefills for {len(requests)} requests")
    expect = expected_launches(cfg)
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


def phase_serving(device, arch=SERVE_ARCH, cfg=None, slots=SERVE_SLOTS,
                  max_len=SERVE_MAX_LEN, new_tokens=SERVE_NEW, prompts=None,
                  fixed=SERVE_PROMPTS, phase="5", params=None, profiles=None):
    """``arch`` through ServeEngine in bfloat16, on ``prompts`` (default:
    the ``fixed`` lengths and random ones), with ``params`` (bf16 weights
    of ``cfg``; default: ``bf16_weights`` makes them); returns the
    kernels' launch counts of the run.  Where ``profiles`` is a dict, it
    gets ``profile_breakdown``'s numbers of a decode step ("decode") and of
    the longest prompt's prefill ("prefill")."""
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
    if params is None:
        params = bf16_weights(device, cfg)
    elif device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
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
    for r in reqs:
        eng.submit(r)
    restore = _record_model_calls(device, records)
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
        restore()

    _check_served(cfg, reqs, done, new_tokens, records, launches)
    check(launches["segment_sum"] == 0, "serving launched segment_sum")
    pre, dec = records["prefill"], records["decode"]
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
        # the engine has just run both calls at these shapes: no warm-up
        decode = profile_breakdown(
            lambda: M.decode_step(cfg, eng.params, batch, eng.cache,
                                  use_kernels=True),
            f"decode step ({slots} slots)", warm=True)
        # the prefill as the engine runs it: the last row unembedded
        tokens = torch.as_tensor(longest[None].astype("int64"), device=device)
        prefill = profile_breakdown(
            lambda: M.prefill(cfg, eng.params, {"tokens": tokens},
                              max_cache_len=max_len, use_kernels=True,
                              last_only=True),
            f"prefill of {len(longest)} tokens", warm=True)
        if profiles is not None:
            profiles.update(decode=decode, prefill=prefill)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _close(got, want, atol, rtol, rows=None):
    """(ok, max |err|) of ``got`` against ``want`` under atol + rtol·|want|,
    over the rows (first index) where the boolean ``rows`` holds, or all.
    Taken a slab of rows at a time, so that a large float32 logits tensor
    (Llama4-Scout's 9000 x 202,048) needs no whole-size temporaries."""
    import torch

    n = got.shape[0] if got.dim() else 1
    got, want = (t.reshape(n, -1) for t in (got, want))
    step = max(1, (1 << 26) // max(1, got.shape[1]))
    ok, worst = True, 0.0
    for lo in range(0, n, step):
        g, w = got[lo:lo + step].float(), want[lo:lo + step].float()
        if rows is not None:
            keep = rows[lo:lo + step]
            g, w = g[keep], w[keep]
        if not g.numel():
            continue
        err = (g - w).abs()
        ok = ok and bool(torch.all(err <= atol + rtol * w.abs()))
        m = float(err.max())
        worst = max(worst, m) if m == m else m  # a NaN stays
    return ok, worst


def live_pairs(t_len, s_len, causal, window, q_offset):
    """(query, key) pairs that the mask lets through, for one head."""
    total = 0
    for t in range(t_len):
        hi = min(s_len - 1, t + q_offset) if causal else s_len - 1
        lo = max(0, t + q_offset - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_floors(q, k, causal, window, q_offset):
    """The floors of one call: q, k, v read once and the output written
    once at HBM rate (``bytes_ms``), and 2·Dh multiply-adds (QKᵀ and PV)
    per live pair and head at the rate of the route's arithmetic: bf16
    tensor cores (``ops_ms``); float32 as three TF32 products
    (``split_tf32_ms``, the float32 route's ``ops_ms``) and, beside it, on
    the CUDA cores (``cuda_core_ms``)."""
    B, Hq, T, Dh = q.shape
    S = k.shape[2]
    elem = q.element_size()
    n_bytes = (2 * B * Hq * T * Dh + 2 * k.numel()) * elem
    ops = 4 * Dh * B * Hq * live_pairs(T, S, causal, window, q_offset)
    floors = {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": ops}
    if elem == 2:
        floors["ops_ms"] = ops / BF16_OPS_PER_S * 1e3
    else:
        floors["split_tf32_ms"] = 3 * ops / TF32_OPS_PER_S * 1e3
        floors["cuda_core_ms"] = ops / F32_OPS_PER_S * 1e3
        floors["ops_ms"] = floors["split_tf32_ms"]
    return floors


def flash_bound_ms(q, k, causal, window, q_offset):
    """Least time: the larger of ``flash_floors``' bytes and operations
    (float32: the split-TF32 floor)."""
    f = flash_floors(q, k, causal, window, q_offset)
    return ((f["bytes_ms"], "bytes") if f["bytes_ms"] >= f["ops_ms"]
            else (f["ops_ms"], "operations"))


def cuda_core_attention(q, k, v, causal=True, window=None, q_offset=0):
    """Attention on the CUDA-core kernel, in q's dtype, its C entry called
    directly, so no wrapper counts the launch (this function's
    ``.launches`` does, for ``kernel_device_ms``): the kernel that served
    the bf16 widths before the ``wgmma`` kernel (Phi-3's 96 among them; it
    keeps the widths that are no multiple of 8) and float32 before the
    split-TF32 one (no path of the port reaches its float32 entry)."""
    import torch
    from repro_torch.kernels.flash_attention import _kernel

    entry = ("flash_attention_f32" if q.dtype == torch.float32
             else "flash_attention_bf16")
    out = torch.empty_like(q)
    B, Hq, T, Dh = q.shape
    rc = _kernel(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        k.shape[1], T, k.shape[2], Dh, int(causal),
        -1 if window is None else window, q_offset, Dh ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the CUDA-core flash_attention kernel failed: {rc}")
    cuda_core_attention.launches += 1
    return out


cuda_core_attention.launches = 0


def sdpa_backend(sdpa, out, tried=("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                                     "CUDNN_ATTENTION", "MATH")):
    """The SDPA backends of ``tried`` that, each alone, give ``out`` bit for
    bit: those of them the default dispatch may have chosen for the call
    ``sdpa``."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = []
    for name in tried:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                got = sdpa()
        except RuntimeError:  # this backend cannot serve the call
            continue
        if torch.equal(got, out):
            names.append(name)
    return "/".join(names) or "none alone"


def flash_timings(q, k, v, window, sdpa, causal=True):
    """flash_attention at a served shape, in q's dtype: the wrapper timed
    four ways (back to back, the profiler's device time per launch, one
    call alone, queued on the card); the CUDA-core kernel that served the
    shape before (``cuda_core_attention``) back to back and queued, held to
    the dtype's bar; the plain version; the library call ``sdpa`` (TF32
    off) back to back and queued, its max |err| against the plain version
    and the SDPA backend that served it; and the bound (float32: the
    split-TF32 floor, with the CUDA-core and bytes floors printed beside
    it)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = q.dtype == torch.float32

    def run():
        return flash_attention(q, k, v, causal=causal, window=window)

    def cuda_core():
        return cuda_core_attention(q, k, v, causal, window)

    want = attention_ref(q, k, v, causal=causal, window=window)
    ok, core_err = _close(cuda_core(), want, *KERNEL_TOL[str(q.dtype)])
    check(ok, f"the CUDA-core {q.dtype} kernel: max |err| {core_err}")
    library_out = sdpa()
    library_err = _close(library_out, want, 0.0, 0.0)[1]
    backend = sdpa_backend(sdpa, library_out)
    del want, library_out
    bound, bound_by = flash_bound_ms(q, k, causal, window, 0)
    times = {
        "ms": time_ms(run, runs=10, per_run=5),
        "kernel_device_ms": kernel_device_ms(
            run, FLASH_F32 if f32 else "flash_attention_kernel",
            wrapper=flash_attention, calls=5),
        "alone_ms": time_alone_ms(run),
        "queued_ms": time_queued_ms(run),
        "cuda_core_ms": time_ms(cuda_core, runs=3, per_run=3, warmup=1),
        "cuda_core_queued_ms": time_queued_ms(cuda_core, calls=5),
        "cuda_core_max_abs_err": core_err,
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                  window=window),
                            runs=5, per_run=1, warmup=1),
        "library_ms": time_ms(sdpa, runs=10, per_run=5),
        "library_queued_ms": time_queued_ms(sdpa),
        "library_max_abs_err": library_err,
        "library_backend": backend,
        "bound_ms": bound, "bound_by": bound_by,
    }
    floors = flash_floors(q, k, causal, window, 0)
    bound_text = (f"bound (split-TF32: 3 x {floors['operations']!r} operations"
                  f" at 495 TFLOP/s) {floors['split_tf32_ms']!r} ms  CUDA-core"
                  f" floor (67 TFLOP/s) {floors['cuda_core_ms']!r} ms  bytes "
                  f"floor {floors['bytes_ms']!r} ms" if f32 else
                  f"bound {bound!r} ms ({bound_by})")
    B, Hq, T, Dh = q.shape
    print(f"timing flash_attention ({B},{Hq},{T},{Dh}) Hkv {k.shape[1]} "
          f"window {window} causal {causal} {q.dtype}: wrapper "
          f"{times['ms']!r} ms  kernel (device) {times['kernel_device_ms']!r}"
          f" ms  one call alone (events) {times['alone_ms']!r} ms  queued on "
          f"the card {times['queued_ms']!r} ms  CUDA-core kernel "
          f"{times['cuda_core_ms']!r} ms (queued "
          f"{times['cuda_core_queued_ms']!r}, max |err| {core_err!r})  plain "
          f"{times['plain_ms']!r} ms  library (sdpa, TF32 off, backend "
          f"{backend}) {times['library_ms']!r} ms (queued "
          f"{times['library_queued_ms']!r}, max |err| {library_err!r})  "
          f"{bound_text}")
    return times


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
    t_len = max(lengths)
    mask = torch.ones(t_len, t_len, dtype=torch.bool, device=device).tril()
    mask &= ~torch.ones_like(mask).tril(-window)
    # SDPA on the same boolean mask, MQA as views, in both dtypes
    flash = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = timed[("flash_attention", dtype)]
        kx, vx = k.expand(q.shape), v.expand(q.shape)
        flash[dtype] = flash_timings(
            q, k, v, window,
            lambda q=q, kx=kx, vx=vx: F.scaled_dot_product_attention(
                q, kx, vx, attn_mask=mask))
    entries = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], **flash[torch.bfloat16],
        "shape": {"B": 1, "Hq": hq, "Hkv": 1, "T": t_len, "S": t_len,
                  "Dh": dh, "window": window, "dtype": "torch.bfloat16"},
        "float32": flash[torch.float32],
    }]
    profiled = rglru_profile({
        label: tuple(timed[("rglru_scan", torch.float32, label)][0].shape)
        for label in ("prefill", "decode")})
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
        # by CUDA events only.  The profiler runs in a process of its own
        # (``rglru_profile``)
        per_name, dev_ms = {}, None
        if key[1] == torch.float32:
            per_name, dev_ms = profiled[key[2]]
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
                                   "mamba_scan_kernel", wrapper=mamba_scan,
                                   calls=5)
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


def _hidden_recorder(against=None):
    """Wrap ``model._block_fwd`` so that each block's output is kept (a
    copy), or, with ``against`` (the outputs a run kept so), compared with
    that of the same call there: max |err| a call.  A forward calls the
    blocks in layer order, so a call's index modulo the depth is its
    layer.  Returns (the list, a function that unwraps)."""
    from repro_torch.models import model as M

    real, out = M._block_fwd, []

    def block(*args, **kwargs):
        x, new_cache, aux = real(*args, **kwargs)
        h = x.detach()
        out.append(h.clone() if against is None else
                   float((h.float() - against[len(out)].float()).abs().max()))
        return x, new_cache, aux

    M._block_fwd = block

    def restore():
        M._block_fwd = real

    return out, restore


def print_layer_gaps(label, gaps, depth):
    """Each layer's max |err| of the hidden state between two runs: the
    prefill's, and the largest over the decode steps'."""
    check(len(gaps) % depth == 0 and gaps,
          f"{len(gaps)} block calls recorded for {depth} layers")
    calls = [gaps[i:i + depth] for i in range(0, len(gaps), depth)]
    print(f"{label}: hidden state max |err| by layer, prefill: {calls[0]!r}")
    if len(calls) > 1:
        print(f"{label}: hidden state max |err| by layer, largest over "
              f"{len(calls) - 1} decode steps: "
              f"{[max(c[i] for c in calls[1:]) for i in range(depth)]!r}")


def phase_model_kernels_vs_plain(device, arch=SERVE_ARCH, depth=None, cfg=None,
                                 prompt_len=3000, max_len=SERVE_MAX_LEN,
                                 steps=3, phase="6b", params=None):
    """A full-width cut of ``arch`` to ``depth`` layers (default: one
    pattern group plus the tail), float32: prefill and decode logits with
    the kernels against the plain versions, on the same tokens (a
    stub-frontend arch: the same seeded N(0, 1) ``embeds``), each layer's
    hidden-state gap printed; the kernel run launches exactly
    ``expected_launches``' for one admission and ``steps`` decode steps.
    ``params``: float32 weights of the cut (default: made from seed 2)."""
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
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(2)
        params = M.init(cfg, gen, device=device, dtype=torch.float32)
    check(all(a.dtype == torch.float32 for a in _leaves(params)),
          "the float32 cut's weights are not all float32")
    rng = np.random.default_rng(2)
    if cfg.frontend == "embed":
        prompt = {"embeds": torch.as_tensor(rng.standard_normal(
            (1, prompt_len, cfg.d_model), dtype=np.float32), device=device)}
        feed = [{"embeds": torch.as_tensor(rng.standard_normal(
            (1, 1, cfg.d_model), dtype=np.float32), device=device)}
            for _ in range(steps)]
    else:
        prompt = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(1, prompt_len)), device=device)}
        feed = [{"tokens": torch.tensor([[int(tok)]], device=device)}
                for tok in rng.integers(0, cfg.vocab, size=steps)]
    expect = {k: a + steps * b for k, (a, b) in expected_launches(cfg).items()}
    atol, rtol = MODEL_TOL
    out, hidden = {}, None
    for use_kernels in (True, False):
        before = {k: w.launches for k, w in kernels.items()}
        hidden, restore = _hidden_recorder(against=hidden)
        try:
            logits, cache, _ = M.prefill(cfg, params, prompt,
                                         max_cache_len=max_len,
                                         use_kernels=use_kernels)
            # the prefill cache is float32 here, as the serving cache is,
            # and padded to max_len: decode runs on it directly
            outs = [logits]
            for i, step in enumerate(feed):  # the same decode inputs
                batch = dict(step, positions=torch.tensor(
                    [[prompt_len + i]], device=device))
                outs.append(M.decode_step(cfg, params, batch, cache,
                                          use_kernels=use_kernels)[0])
            _sync(device)
        finally:
            restore()
        launched = {k: w.launches - before[k] for k, w in kernels.items()}
        want = expect if use_kernels else dict.fromkeys(expect, 0)
        check(launched == want, f"use_kernels={use_kernels}: launched "
              f"{launched}, wanted {want}")
        out[use_kernels] = outs
        del cache
    print_layer_gaps(f"{cfg.name} depth {depth}, kernels vs plain", hidden,
                     depth)
    for i, (got, want) in enumerate(zip(out[True], out[False])):
        label = "prefill" if i == 0 else f"decode step {i}"
        ok, err = _close(got, want, atol, rtol)
        check(ok and bool(torch.isfinite(got).all()),
              f"{label}: max |err| {err} over atol {atol} rtol {rtol}")
        print(f"{cfg.name} depth {cfg.n_layers}, {label} logits "
              f"{tuple(got.shape)}: kernels vs plain max |err| {err!r} (atol "
              f"{atol}, rtol {rtol}; max |logit| {float(want.abs().max())!r})")


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
                     hq=24, hkv=8, dh=64, phase="10a", arch=GRANITE_ARCH):
    """moe_dispatch against its plain version at the served shapes of
    ``arch`` (default Granite), with times; for Granite also the silu as
    the reference rounds it and flash_attention at its prefill shape.
    Returns the moe_dispatch kernels-line entry and flash_attention's
    numbers at Granite's shape (None for another arch)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.ref import attention_ref, moe_dispatch_ref

    print(f"== phase {phase}: moe_dispatch{' and flash_attention' if arch == GRANITE_ARCH else ''}"
          f" ({arch}'s shapes) against their plain versions", flush=True)
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
            dev_ms = kernel_device_ms(run, MOE_KERNELS, wrapper=moe_dispatch)
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

    if arch != GRANITE_ARCH:
        return entry, None
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
        # SDPA with K and V repeated to the query heads beforehand, as
        # views are in 6a, and ``is_causal``
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        times = flash_timings(
            q, k, v, None,
            lambda q=q, kr=kr, vr=vr: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True))
        if dtype == torch.float32:
            flash["float32"] = times
        else:
            flash.update(times)
            flash["shape"] = {"B": 1, "Hq": hq, "Hkv": hkv, "T": prompt_len,
                              "S": prompt_len, "Dh": dh, "window": None,
                              "dtype": str(dtype)}
    return entry, flash


def _routing_recorder(force=None):
    """Wrap ``layers.route`` so that each MoE call's top-k expert ids are
    recorded, sorted and as chosen; with ``force`` (ids as chosen, one
    entry per call, as recorded), each call takes those ids instead, its
    top-k gates the router's own gates there, renormalized as ``route``
    does.  Returns (the sorted ids, the ids as chosen, a function that
    unwraps)."""
    import torch
    from repro_torch.models import layers as L

    real, calls, raw = L.route, [], []

    def recording(cfg, p, x2d):
        gates_all, top_gates, top_ids = real(cfg, p, x2d)
        if force is not None:
            top_ids = force[len(raw)]
            top_gates = torch.gather(gates_all, 1, top_ids)
            top_gates = top_gates / torch.clamp(
                top_gates.sum(dim=-1, keepdim=True), min=1e-9)
        raw.append(top_ids)
        calls.append(top_ids.sort(dim=-1).values)
        return gates_all, top_gates, top_ids

    L.route = recording

    def restore():
        L.route = real

    return calls, raw, restore


def _kept(ids, cfg):
    """(N, k) booleans: which of a MoE call's choices ``ids`` the capacity
    rule keeps at a plan capacity of 1 (C slots an expert, filled in
    token order)."""
    import numpy as np
    from repro_torch.kernels import ops as kops

    n, k = ids.shape
    c = max(int(np.ceil(n * k / cfg.n_experts * cfg.capacity_factor)), k)
    return (kops.compute_slots(ids.reshape(-1), cfg.n_experts) < c).view(n, k)


def phase_moe_model(device, arch=GRANITE_ARCH, depth=4, cfg=None,
                    prompt_len=3000, max_len=SERVE_MAX_LEN, steps=3,
                    phase="10b", walls=True, params=None):
    """A full-width float32 cut of an MoE arch (Granite): (a) the
    moe_dispatch kernel against its plain version with the same attention,
    bit for bit; (b) all kernels against all plain versions: routing flips
    counted, and the logits held at every position, as run where no
    choice flipped, else on a run with the plain run's routing pinned (a
    flip moves other tokens' capacity slots, so a position whose own
    routing agreed may still see another token dropped); then, with
    ``walls``, the prefill's wall on the float32 attention kernel and
    on the one before.  Each layer's hidden-state gap between the held
    run and the plain one is printed.  ``params``: float32 weights of the
    cut (default: made from seed 2)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_dispatch_ref
    from repro_torch.models import model as M

    base = cfg or get_config(arch)
    cfg = dataclasses.replace(base, n_layers=depth)
    print(f"== phase {phase}: {cfg.name} at full width and depth {depth}, "
          "kernels against plain versions (float32)", flush=True)
    kernels = _lm_kernels()
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(2)
        params = M.init(cfg, gen, device=device, dtype=torch.float32)
    check(all(a.dtype == torch.float32 for a in _leaves(params)),
          "the float32 cut's weights are not all float32")
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, prompt_len)),
                             device=device)
    feed = rng.integers(0, cfg.vocab, size=steps)
    hidden = {}

    def run(use_kernels, force=None, keep=None):
        """(logits of the prefill and each decode step, routing per MoE
        call (sorted ids, and as chosen), launches by kernel); ``force``:
        the routing each MoE call takes (``_routing_recorder``); ``keep``:
        the key in ``hidden`` the blocks' outputs are kept under."""
        before = {k: w.launches for k, w in kernels.items()}
        calls, raw, restore = _routing_recorder(force)
        recorded, unwrap = (_hidden_recorder() if keep
                            else (None, lambda: None))
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
            unwrap()
        if keep:
            hidden[keep] = recorded
        return outs, (calls, raw), {k: w.launches - before[k]
                                    for k, w in kernels.items()}

    n_moe = expected_launches(cfg)["moe_dispatch"][0]
    with_kernels, (routes_k, raw_k), launched = run(True, keep="as run")
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
    del plain_dispatch  # one set of logits less on the card
    # (b) every kernel against every plain version
    plain, (routes_p, raw_p), launched = run(False, keep="plain")
    check(sum(launched.values()) == 0, f"plain run launched {launched}")
    # routing: one (N, k) record per MoE call, the prefill's depth first
    differ = [(a != b).any(dim=-1) for a, b in zip(routes_k, routes_p)]
    n_choices = sum(x.numel() for x in differ)
    n_flips = int(sum(int(x.sum()) for x in differ))
    print(f"routing: {n_flips} of {n_choices} (token, layer) choices differ "
          f"between kernels and plain versions")
    check(n_flips <= ROUTING_FLIPS_MAX * n_choices,
          f"{n_flips} of {n_choices} routing choices differ, over "
          f"{ROUTING_FLIPS_MAX:.0%}")
    atol, rtol = MODEL_TOL
    held, how, key = with_kernels, "as run", "as run"
    if n_flips:
        # a flip moves the capacity slots of the tokens after it on both
        # experts: one whose own routing agreed may be dropped or kept
        # where it was not, and every later position attends to the
        # changed ones.  Where, and how far the logits moved there:
        flipped = torch.stack(differ[:depth]).any(dim=0)
        moved = torch.stack([(_kept(a, cfg) != _kept(b, cfg)).any(dim=-1)
                             for a, b in zip(raw_k[:depth], raw_p[:depth])]
                            ).any(dim=0) & ~flipped
        first = int(flipped.nonzero()[0, 0]) if bool(flipped.any()) else None
        _, err_agreed = _close(with_kernels[0][0], plain[0][0], atol, rtol,
                               rows=~flipped)
        before_first = (torch.arange(prompt_len, device=device)
                        < (prompt_len if first is None else first))
        _, err_before = _close(with_kernels[0][0], plain[0][0], atol, rtol,
                               rows=before_first)
        print(f"the prefill's routing flipped at positions "
              f"{flipped.nonzero()[:, 0].tolist()}; capacity kept or dropped "
              f"another choice at {int(moved.sum())} positions whose own "
              f"routing agreed (first {moved.nonzero()[:1, 0].tolist()}); "
              f"as run, kernels vs plain max |err| {err_agreed!r} where the "
              f"position's own routing agreed, {err_before!r} before the "
              f"first flip (unchecked: other choices differ in their past)")
        # every choice pinned to the plain run's: the same tokens dropped
        # and kept, so every position is held
        del with_kernels
        held, (routes_f, _), launched = run(True, force=raw_p, keep="pinned")
        check(launched["flash_attention"] == n_moe
              and all(torch.equal(a, b) for a, b in zip(routes_f, routes_p)),
              f"the pinned run launched {launched} or routed otherwise")
        how, key = "with the plain run's routing pinned", "pinned"
    print_layer_gaps(f"{cfg.name} depth {depth}, kernels vs plain ({how})",
                     [float((a.float() - b.float()).abs().max())
                      for a, b in zip(hidden[key], hidden["plain"])], depth)
    hidden.clear()
    for i, (got, want) in enumerate(zip(held, plain)):
        label = "prefill" if i == 0 else f"decode step {i}"
        ok, err = _close(got, want, atol, rtol)
        check(ok and bool(torch.isfinite(got).all()),
              f"{label} ({how}): max |err| {err} over atol {atol} rtol {rtol}")
        print(f"{cfg.name} depth {depth}, {label} logits {tuple(got.shape)} "
              f"({how}): kernels vs plain max |err| {err!r} (atol {atol}, "
              f"rtol {rtol}; max |logit| {float(want.abs().max())!r})")
    del held
    del plain
    if not walls:
        return

    # the float32 prefill end to end: its wall and flash_attention's device
    # ms within it, on the float32 route's kernel and, in its place through
    # kernels.ops, on the CUDA-core kernel that served float32 before
    def prefill():
        out = M.prefill(cfg, params, {"tokens": tokens}, max_cache_len=max_len,
                        use_kernels=True)
        _sync(device)
        return out

    for label, attention, name, counter in (
            ("change", ops.flash_attention, FLASH_F32,
             kernels["flash_attention"]),
            ("parent", cuda_core_attention, FLASH_F32_BEFORE,
             cuda_core_attention)):
        real = ops.flash_attention
        ops.flash_attention = attention
        try:
            prefill()
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                prefill()
                walls.append(time.perf_counter() - t)
            per_launch = {}
            dev = kernel_device_ms(prefill, name, wrapper=counter, calls=1,
                                   recorded_per_call=per_launch)
            recorded = sum(per_launch.values())
        finally:
            ops.flash_attention = real
        within = None if dev is None else dev * recorded
        print(f"{cfg.name} depth {depth} float32 {prompt_len}-token prefill, "
              f"kernels on, flash_attention's float32 route on the {label}'s "
              f"kernel ({name}): wall {statistics.median(walls)!r} s (runs "
              f"{walls!r}); flash_attention device {within!r} ms in "
              f"{recorded!r} launches ({dev!r} ms a launch)")


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
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, phase="11a", lr=TRAIN_LR,
                   profile=True):
    """Phase 11a: ``arch`` trained through ``repro_torch.launch.train`` at
    full width and depth, bf16 compute over float32 masters, remat on, the
    geo-planned ingest on (a stub-frontend arch on the launcher's seeded
    ``embeds``); checks finite, falling losses and peak memory, prints step
    walls, tokens/s, ``train_mfu`` and, with ``profile``, a profiled warm
    step and the chunked attention's share of it.  ``lr``: the peak
    learning rate (after 2 warm-up steps, cosine to the end)."""
    import math

    import torch
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    print(f"== phase {phase}: training {cfg.name} through repro_torch.launch.train "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.n_params() / 1e9:.3f} B parameters; batch {batch} x {seq}, "
          f"{steps} AdamW steps at peak lr {lr}, bf16 compute, float32 "
          "masters, remat)",
          flush=True)
    if device.type == "cuda":
        _sync(device)  # a CUDA context first, where this phase runs alone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    from repro_torch.kernels.segment_reduce import segment_sum

    kernels = dict(_lm_kernels(), segment_sum=segment_sum)
    records = []
    argv = _train_argv(arch, reduced, steps, batch, seq, "--dtype", "bfloat16",
                       "--remat", "--warmup", "2", "--lr", lr,
                       "--geo-ingest", "--device", str(device))
    for w in kernels.values():
        w.launches = 0
    t = time.perf_counter()
    state, lines = _run_launcher(
        argv, records, device,
        profile_step=steps if profile and device.type == "cuda" else None)
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
                               reduced=False, phase="11b", cfg=None):
    """Phase 11b: a full-width cut of ``arch`` (or of ``cfg``, taken as
    given) to ``depth`` layers, float32 (no TF32): ``loss_fn`` and every
    gradient on the card against the same on the CPU.  A stub-frontend
    arch takes seeded N(0, 1) ``embeds``.  For an MoE arch the (token,
    layer) routing choices that differ between the card and the CPU are
    counted and printed; where any differ, loss and gradients are held
    with the CPU run's choices pinned on both sides (phase 10b's rule: a
    flipped choice moves other tokens' capacity slots).  Returns (the
    worst gradient gap, relative to its leaf's largest entry; the routing
    flips, None without experts)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.set_float32_matmul_precision("highest")
    base = cfg or (get_config(arch).reduced() if reduced else get_config(arch))
    cfg = dataclasses.replace(base, n_layers=depth)
    print(f"== phase {phase}: {cfg.name} at full width and depth {depth} "
          f"({cfg.n_groups} x {len(cfg.pattern)} and a tail of "
          f"{len(cfg.tail)}), loss and gradients on the card against the "
          f"CPU (float32, B=1, T={seq})", flush=True)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(3),
                    device=device)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(1, seq + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    if cfg.frontend == "embed":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (1, seq, cfg.d_model), dtype=np.float32))
    on_card = {k: v.to(device) for k, v in batch.items()}

    def routed_grads(params, batch, force=None):
        """``_grads`` and each MoE call's top-k ids (sorted, and as
        chosen), or those of ``force`` taken (``_routing_recorder``)."""
        calls, raw, restore = _routing_recorder(force)
        try:
            return (*_grads(cfg, params, batch), calls, raw)
        finally:
            restore()

    t = time.perf_counter()
    loss, grads, routes, _ = routed_grads(params, on_card)
    _sync(device)
    walls = {"card": time.perf_counter() - t}
    t = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_params = M.cast_params(params, torch.float32, cpu)
    walls["copy"] = time.perf_counter() - t
    t = time.perf_counter()
    want_loss, want, want_routes, chosen = routed_grads(cpu_params, batch)
    walls["cpu"] = time.perf_counter() - t
    flips, how = None, ""
    if cfg.n_experts:
        differ = [(a.cpu() != b).any(dim=-1)
                  for a, b in zip(routes, want_routes)]
        flips = int(sum(int(x.sum()) for x in differ))
        print(f"routing: {flips} of {sum(x.numel() for x in differ)} (token, "
              "layer) choices differ between the card and the CPU")
        if flips:
            del grads
            loss, grads, *_ = routed_grads(
                params, on_card, [r.to(device) for r in chosen])
            want_loss, want, *_ = routed_grads(cpu_params, batch, chosen)
            how = " (the CPU run's routing pinned on both sides)"
    check(bool(torch.isfinite(loss)) and abs(float(loss) - float(want_loss))
          <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
          f"loss {float(loss)} on the card, {float(want_loss)} on the CPU{how}")
    t = time.perf_counter()
    worst = 0.0
    for path, g in grads.items():
        w = want[path]
        if w is None or g is None:
            check(w is None and g is None, f"{path}: reached on one side only")
            continue
        # held on the card: float32 differences, magnitudes and maxima are
        # exact, so the numbers are the CPU's
        w = w.to(g.device)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        check(err <= TRAIN_GRAD_TOL * scale,
              f"{'/'.join(path)}: gradient max |err| {err} over "
              f"{TRAIN_GRAD_TOL} x {scale}{how}")
        worst = max(worst, err / scale)
    walls["held"] = time.perf_counter() - t
    print(f"loss card {float(loss)!r} cpu {float(want_loss)!r} (rtol "
          f"{TRAIN_LOSS_RTOL}); {len(grads)} gradient leaves, worst max |err| "
          f"{worst!r} of the leaf's largest entry (bar {TRAIN_GRAD_TOL}){how}; "
          "walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    del params, grads
    return worst, flips


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
                   vocab=VOCAB, n_restarts=SCHED_RESTARTS, steps=SCHED_STEPS,
                   n_jobs=SCHED_JOBS):
    """Phase 12a: four word-count tenants on the 8-DC platform through
    ``GeoSchedule``; returns (jobs, per_source, joint schedule, launches)."""
    import numpy as np
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
    print(f"joint solve {n_restarts}x{steps}, {n_jobs} jobs: first "
          f"{first:.3f} s")
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
                   vocab=VOCAB, n_restarts=SCHED_RESTARTS, steps=SCHED_STEPS,
                   pair_opt=PIPE_PAIR_OPT):
    """Phase 13a: a 3-stage word-count chain through ``GeoPipeline``;
    returns (measured alphas, out_scales, the end_to_end solver's
    recorded call, launches)."""
    import numpy as np
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
    print(f"end_to_end plan {n_restarts}x{steps}, {PIPE_STAGES} stages: first "
          f"{results['end_to_end'][1]:.3f} s (between two synchronizations)")
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
                            n_restarts=SCHED_RESTARTS, steps=SCHED_STEPS,
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
    """Phase 14a: the two training planners on the card (a first call),
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
        print(f"14a {label}: solve on the card first {first!r} s (CPU "
              f"{cpu_s!r} s); est {plan.est_time_s!r} s vs "
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
        calls, _, restore = _routing_recorder()
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

    def keeping(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            rows.append(out[0][0, -1].clone())
            return out
        return run

    M.prefill, M.decode_step = keeping(real[0]), keeping(real[1])

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


#: seconds a process of ``rglru_profile`` may take, the card reached and
#: the built kernels loaded included
RGLRU_PROFILE_TIMEOUT_S = 180


def rglru_profile(shapes, tries: int = 3):
    """For each label's float32 (B, T, D) in ``shapes``: each
    ``rglru_scan`` kernel's launches a call and the device ms of a call,
    as ``torch.profiler`` recorded them in a process of its own
    (``rglru_profile_main``), the first sessions of that process: in this
    one, after the profiler sessions of the phases before, every session
    at the decode step once recorded no launch of either kernel (H100).
    A process whose profiler recorded no launch at some shape is made
    again, up to ``tries`` in all; the last one's result is returned."""
    for attempt in range(1, tries + 1):
        try:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--rglru-profile", json.dumps(shapes)],
                capture_output=True, text=True,
                timeout=RGLRU_PROFILE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"rglru_scan profile: the process took over "
                 f"{RGLRU_PROFILE_TIMEOUT_S} s")
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-8000:], file=sys.stderr)
            fail(f"rglru_scan profile: the process exited {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        profiled = {label: (per_name, dev_ms)
                    for label, (per_name, dev_ms) in result.items()}
        if all(any(per_name.values()) for per_name, _ in profiled.values()):
            break
        print(f"  rglru_scan profile: process {attempt} of {tries} recorded "
              f"no launch at some shape: {profiled}")
    return profiled


def rglru_profile_main(shapes: str) -> None:
    """The process of ``rglru_profile``: float32 inputs at each label's
    (B, T, D), made from seed 2 as phase 6a makes its own (h0 zeros at a
    prefill), each call profiled by ``kernel_device_ms``; prints one JSON
    object, label → [launches a call by kernel, device ms a call]."""
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.rglru_scan import rglru_scan

    device = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(2)
    result = {}
    for label, (b, t_len, width) in json.loads(shapes).items():
        x = torch.randn(b, t_len, width, generator=gen).to(device)
        a = torch.sigmoid(torch.randn(b, t_len, width, generator=gen)).to(device)
        h0 = (torch.zeros(b, width, device=device) if t_len > 1
              else torch.randn(b, width, generator=gen).to(device))
        per_name = {}
        dev_ms = kernel_device_ms(lambda: rglru_scan(x, a, h0), RGLRU_KERNELS,
                                  wrapper=rglru_scan, calls=5,
                                  recorded_per_call=per_name)
        result[label] = [per_name, dev_ms]
    print(json.dumps(result), flush=True)


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


# ---------------------------------------------------------------------------
# phase 17: the port's examples on the card
# ---------------------------------------------------------------------------

#: the reference's numbers for the geo examples, recorded from its CPU run
#: of ``examples/geo_{multijob,online,pipeline,planner_service}.py`` (jax
#: is not on the card machine); ``tests/test_torch_examples.py`` holds
#: these constants to a fresh reference run
REF_MULTIJOB = {
    "modeled": {"independent": 1210.9996809605282,
                "sequential": 822.9095441966738, "joint": 810.0081759630003},
    "sim": {"independent": 1205.9996825439468,
            "sequential": 820.8126704613665, "joint": 809.9917832590688},
}
REF_ONLINE = {
    "frozen": 3575.455731114156, "static": 3670.492753261259,
    "reactive": 197.96173196169033, "horizon": 199.97839520808253,
    "frozen2": 537.8621688704163, "reactive (solo)": 462.79090062350133,
    "reactive_shared": 424.66095514042803,
    "shared, no hysteresis": 424.6611804347364,
}
REF_PIPELINE = {
    "modeled": {"stagewise": 1327.1231824736183,
                "end_to_end": 380.7547569192941},
    "sim": {"stagewise": 1327.1231824736171, "end_to_end": 380.7547569192941},
}
REF_SERVICE_STATS = {"calls": 16, "hits": 12, "misses": 4, "compiles": 4,
                     "entries": 4, "shapes": 4}
#: the reference's own spread on each line whose anneal has not settled,
#: recorded from the same CPU run: the largest relative move of its
#: makespan when one bandwidth moves by 1e-7 or 1e-6 (the pipeline's two
#: modes) or ``run_online`` takes another seed (the online co-replans).
#: There the float32 rounding of each device decides where the anneal
#: ends, so such a line is held to this spread; every other line to a
#: solver's best-objective bar (ROADMAP), ``EXAMPLE_RTOL``
REF_SPREAD = {"stagewise": 0.0043250567086112746,
              "end_to_end": 0.001168491811487371,
              "reactive_shared": 0.003816479547498197,
              "shared, no hysteresis": 0.003816231148387028}
EXAMPLE_RTOL = 1e-3
#: 17f: the training example's two runs in one checkpoint directory; the
#: launcher saves every 50 steps and at the end, so the first run's final
#: save (step 60) is the newest committed checkpoint
EXAMPLE_TRAIN_STEPS = (60, 110)


def card_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(len(smi) >= 1, "nvidia-smi listed no card")
    return smi[0]


def run_example(name, *argv):
    """``examples/port_<name>.py`` in this process with its own
    ``sys.argv`` (so the kernel wrappers' counters see it); returns the
    globals it leaves and what it printed."""
    import contextlib
    import runpy

    path = ROOT / "examples" / f"port_{name}.py"
    check(path.is_file(), f"{path} not found")
    saved = sys.argv
    sys.argv = [str(path), *argv]
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            script = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return script, "\n".join(tee.lines + [tee._part])


def _attention_recorder():
    """Wrap ``flash_attention`` as ``kernels.ops`` calls it so that each
    call's inputs, masking and output are kept (clones, on the card).
    Returns (the list, a function that unwraps)."""
    from repro_torch.kernels import ops

    real, calls = ops.flash_attention, []

    def attention(q, k, v, **kwargs):
        out = real(q, k, v, **kwargs)
        calls.append(((q.clone(), k.clone(), v.clone()), kwargs, out.clone()))
        return out

    ops.flash_attention = attention

    def restore():
        ops.flash_attention = real

    return calls, restore


def _held_rel(label, got, want, rtol):
    """:func:`_held` of a makespan against the reference's at ``rtol``,
    printed."""
    import torch

    got, want = (torch.tensor(float(x), dtype=torch.float64) for x in (got, want))
    err = _held(label, got, want, 0.0, rtol) / abs(float(want))
    print(f"{label}: port {float(got)!r} reference {float(want)!r} relative "
          f"{err!r} (bar {rtol})")


def phase_examples(device, train_steps=EXAMPLE_TRAIN_STEPS):
    """Phase 17: the six examples of this slice through ``repro_torch`` on
    the card, each with ``--device`` set to it.  Returns the
    ``flash_attention`` launches of 17e and their max |err| against the
    plain version."""
    import math
    import re
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import reset_solver_cache_stats
    from repro_torch.core.plan import validate_plan
    from repro_torch.kernels.segment_reduce import segment_sum

    dev = str(device)
    kernels = dict(_lm_kernels(), segment_sum=segment_sum)
    walls = {}
    t17 = time.perf_counter()

    def done(sub):
        _sync(device)
        walls[sub] = time.perf_counter() - t
        print(f"phase {sub}: {walls[sub]:.1f} s", flush=True)
        free_device_memory(device)

    print("== phase 17a: examples/port_multijob.py", flush=True)
    t = time.perf_counter()
    g, _ = run_example("multijob", "--device", dev)
    reports = g["reports"]
    for report in reports.values():
        for plan in report.plans:
            validate_plan(plan.x, plan.y)
    check(reports["joint"].makespan_modeled
          <= reports["independent"].makespan_modeled,
          "joint modeled worse than independent")
    for kind, attr in (("modeled", "makespan_modeled"), ("sim", "makespan_sim")):
        for policy, want in REF_MULTIJOB[kind].items():
            _held_rel(f"17a {policy} {kind}",
                      getattr(reports[policy], attr), want, EXAMPLE_RTOL)
    done("17a")

    print("== phase 17b: examples/port_online.py", flush=True)
    t = time.perf_counter()
    g, _ = run_example("online", "--device", dev)
    spans = {"frozen": g["frozen_sim"].makespan,
             "frozen2": g["frozen2_sim"].makespan}
    spans.update((k, r.makespan_online) for k, r in g["reports"].items())
    spans.update((k, r.makespan_online) for k, r in g["reports2"].items())
    for name, want in REF_ONLINE.items():
        _held_rel(f"17b {name}", spans[name], want,
                  REF_SPREAD.get(name, EXAMPLE_RTOL))
    check(spans["reactive"] < spans["frozen"],
          "reactive does not beat the frozen joint plan")
    # reactive_incremental charges each swap the card's measured solve
    # time (a first-call-excluded EMA in half-decade buckets), not the
    # CPU's: its swaps may differ from the reference's, so it is held to
    # invariants only
    inc = g["reports2"]["reactive_incremental"]
    check(math.isfinite(inc.makespan_online) and inc.makespan_online > 0,
          f"reactive_incremental makespan {inc.makespan_online}")
    check(len(inc.swaps) <= len(inc.decisions), "more swaps than decisions")
    print(f"17b reactive_incremental with the card's charge: "
          f"{inc.makespan_online!r} s, {len(inc.swaps)} swaps / "
          f"{len(inc.rejected)} rejected / {len(inc.decisions)} decisions, "
          f"{inc.charged_s!r} s charged")
    done("17b")

    print("== phase 17c: examples/port_pipeline.py", flush=True)
    t = time.perf_counter()
    g, _ = run_example("pipeline", "--device", dev)  # runs its two asserts
    for kind, attr in (("modeled", "makespan_modeled"), ("sim", "makespan_sim")):
        for mode, want in REF_PIPELINE[kind].items():
            _held_rel(f"17c {mode} {kind}", getattr(g["reports"][mode], attr),
                      want, REF_SPREAD[mode])
    done("17c")

    print("== phase 17d: examples/port_planner_service.py", flush=True)
    t = time.perf_counter()
    # the counters are process-wide: count this example's calls alone
    reset_solver_cache_stats()
    g, _ = run_example("planner_service", "--device", dev)
    check(g["worse"] == 0, f"{g['worse']}/8 modeled worse than the incumbent")
    stats = g["solver_cache_stats"]()
    check(stats == REF_SERVICE_STATS,
          f"solver counters {stats}, the reference's {REF_SERVICE_STATS}")
    print(f"17d walls s: cold {g['cold']!r} warm {g['warm']!r} batched "
          f"{g['t_batch']!r} sequential {g['t_seq']!r} full {g['t_full']!r} "
          f"incremental {g['t_inc']!r}")
    done("17d")

    print("== phase 17e: examples/port_serve_lm.py", flush=True)
    t = time.perf_counter()
    cfg = get_config("qwen3-1.7b").reduced()
    for w in kernels.values():
        w.launches = 0
    calls, unwrap = _attention_recorder()
    try:
        g, _ = run_example("serve_lm", "--device", dev)
    finally:
        unwrap()
    launched = {k: w.launches for k, w in kernels.items()}
    served = g["done"]
    check(sorted(r.rid for r in served) == list(range(12)),
          f"requests finished: {sorted(r.rid for r in served)}")
    for r in served:
        out = np.asarray(r.output)
        check(len(out) == 16 and bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"request {r.rid}: {len(out)} tokens, range "
              f"[{out.min()}, {out.max()}]")
    per_admission = expected_launches(cfg)["flash_attention"][0]
    want = {k: 0 for k in kernels}
    want["flash_attention"] = per_admission * len(served)
    check(launched == want, f"17e launches {launched}, expected {want} "
          f"({per_admission} attention layers x {len(served)} admissions)")
    print(f"17e launches {launched}")
    # each launch's output, as the path used it, against the plain version
    # on the same inputs: the float32 kernel's Dh <= 16 instance, which no
    # other phase launches
    from repro_torch.kernels.ref import attention_ref

    atol, rtol = KERNEL_TOL["torch.float32"]
    check(len(calls) == want["flash_attention"],
          f"17e recorded {len(calls)} attention calls")
    err17e, shapes = 0.0, set()
    for (q, k, v), kwargs, out in calls:
        check(q.device == device and q.dtype == torch.float32
              and q.shape[-1] == cfg.head_dim_,
              f"17e attention on {q.device} {q.dtype} Dh {q.shape[-1]}")
        ok, err = _close(out, attention_ref(q, k, v, **kwargs), atol, rtol)
        check(ok, f"17e flash_attention q {tuple(q.shape)} k "
              f"{tuple(k.shape)} {kwargs}: max |err| {err} over atol {atol} "
              f"rtol {rtol}")
        err17e = max(err17e, err)
        shapes.add((tuple(q.shape), tuple(k.shape)))
    print(f"17e flash_attention, each of its {len(calls)} launches against "
          f"attention_ref on the same inputs (float32, Dh {cfg.head_dim_}, "
          f"{len(shapes)} shapes (q, k) from {min(shapes)} to {max(shapes)}):"
          f" max |err| {err17e!r} (atol {atol}, rtol {rtol})")
    del calls
    done("17e")

    print("== phase 17f: examples/port_train_lm.py, twice in one "
          "checkpoint directory", flush=True)
    t = time.perf_counter()
    for w in kernels.values():
        w.launches = 0
    logs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as ckpt:
        for steps in train_steps:
            g, text = run_example("train_lm", "--device", dev, "--steps",
                                  str(steps), "--ckpt-dir", ckpt)
            check(int(g["state"].step) == steps,
                  f"the run ended at step {int(g['state'].step)}, not {steps}")
            logs.append(text)
            del g
    first, second = ([float(x) for x in re.findall(r"loss=(\S+)", text)]
                     for text in logs)
    print(f"17f losses: first run {first!r}, second run {second!r}")
    check("[resume]" not in logs[0], "the first run resumed")
    check(f"[resume] restored committed step {train_steps[0]}" in logs[1],
          f"the second run did not resume from step {train_steps[0]}")
    check(all(math.isfinite(x) for x in first + second), "a loss is not finite")
    check(float(np.mean(second[-2:])) < first[0],
          f"the second run's last two losses {second[-2:]} are not below the "
          f"first run's first {first[0]}")
    launched = {k: w.launches for k, w in kernels.items()}
    check(not any(launched.values()), f"17f launched kernels: {launched}")
    done("17f")

    total = time.perf_counter() - t17
    print(f"phase 17: {total:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in walls.items())}) "
          f"on {card_name_and_limit()}", flush=True)
    return want["flash_attention"], err17e


# ---------------------------------------------------------------------------
# phase 18: the model families that no earlier phase runs on the card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CardArch:
    """One arch of phase 18 and what of it runs on the card: the layers
    served (``depth``, None for all), the serving traffic (``max_len`` and
    the prompt lengths, 32 new tokens each; a stub-frontend arch is
    prefilled with the one length and decoded alone), the depth of the
    float32 cut held against the plain versions, whether it trains at
    full depth (``train``, at the peak learning rate ``train_lr``) and
    whether it runs the float32 training cut (``train_cut``)."""

    phase: str
    arch: str
    depth: int | None
    max_len: int
    prompts: tuple
    cut_depth: int
    train: bool
    train_cut: bool
    train_lr: str = TRAIN_LR


#: the six archs, each at full width.  Llama4-Scout is served at depth 8:
#: two iRoPE groups (three windowed RoPE layers, one global NoPE layer),
#: the deepest whole groups that leave room for a 9000-token prefill's
#: logits at vocab 202,048 (its 48 layers are 203 GB in bf16); the 9000
#: prompt crosses its 8192 window in prefill and decode.  Training needs
#: 16 bytes a parameter: Mistral-NeMo (195 GB) and Llama4-Scout do not
#: train; StableLM and Phi-3 add no model code to what OLMo and MusicGen
#: train, so they run the float32 training cut only.  MusicGen trains at a
#: peak lr of 3e-5: at phase 11a's 3e-4 its 48 layers on the stub
#: frontend's N(0, 1) embeds diverge from step 4 (losses 8.26, 8.05,
#: 6.83, 10.53, 17.31 ... 10.23 on an H100; the same in float32 compute,
#: so not bf16's rounding), and spike at 1e-4 and 5e-5; at 3e-5 they fall
#: step by step (8.26 to 6.79)
CARD_ARCHS = (
    CardArch("18a", "olmo-1b", None, SERVE_MAX_LEN, MAMBA_PROMPTS, 2, True, True),
    CardArch("18b", "stablelm-1.6b", None, SERVE_MAX_LEN, MAMBA_PROMPTS, 2,
             False, True),
    CardArch("18c", "mistral-nemo-12b", None, SERVE_MAX_LEN, MAMBA_PROMPTS, 1,
             False, False),
    CardArch("18d", "llama4-scout-17b-a16e", 8, 9216, (1, 17, 3000, 9000), 4,
             False, False),
    CardArch("18e", "phi-3-vision-4.2b", None, SERVE_MAX_LEN, (3000,), 2,
             False, True),
    CardArch("18f", "musicgen-large", None, SERVE_MAX_LEN, (3000,), 2, True,
             True, train_lr="3e-5"),
)
#: the reduced configs' traffic, for a rehearsal on the CPU: prompts past
#: Llama4-Scout's reduced 32-token window; the card's 8 training steps on
#: fewer tokens (at 3 steps of 2 x 32 the reduced MusicGen's loss does not
#: fall, in the reference's launcher either: its stub frontend's random
#: embeds leave only the labels' marginal to learn)
REDUCED_TRAFFIC = dict(max_len=64, prompts=(1, 17, 40), new_tokens=6,
                       train=dict(steps=TRAIN_STEPS, batch=8, seq=128,
                                  lr=TRAIN_LR),
                       cut_seq=32)


def card_arch_config(spec, reduced=False):
    """``spec``'s config, reduced for a rehearsal, cut to its depth."""
    from repro_torch.configs import get_config

    cfg = get_config(spec.arch)
    cfg = cfg.reduced() if reduced else cfg
    if spec.depth is not None and not reduced:
        cfg = dataclasses.replace(cfg, n_layers=spec.depth)
    return cfg


def card_arch_bytes(spec, slots=SERVE_SLOTS):
    """What each run of ``spec`` holds on the card at full width, reckoned
    from the config (activations aside; the runs check the measured
    peaks): serving, 2 bytes a parameter of the served depth, the longest
    prefill's logits in bf16 and float32 (6 bytes a row and vocab entry)
    and the float32 cache of every slot (one for a stub-frontend arch);
    the float32 cut, 4 bytes a parameter of its depth and two sets of its
    prefill's float32 logits (the kernels' and the plain versions');
    training, 16 bytes a parameter (float32 masters, gradients and two
    moments) where it trains at full depth."""
    from repro_torch.configs import get_config

    full = get_config(spec.arch)
    served = card_arch_config(spec)
    cut = dataclasses.replace(full, n_layers=spec.cut_depth)
    longest = max(spec.prompts)
    n_attn = expected_launches(served)["flash_attention"][0]
    rows = slots if full.frontend is None else 1
    cache = 4 * 2 * n_attn * full.n_kv_heads * full.head_dim_ * spec.max_len * rows
    out = {"serving": 2 * served.n_params() + 6 * longest * full.vocab + cache,
           "float32 cut": 4 * cut.n_params() + 2 * 4 * longest * full.vocab}
    if spec.train:
        out["training"] = 16 * full.n_params()
    return out


def _entry_recorder():
    """Record the C entry every flash_attention launch resolves
    (``kernels.flash_attention._entry``, which its check calls once a
    launch); returns (the list, a function that unwraps)."""
    import importlib

    # the module, which the package's function of the same name shadows
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    real, entries = FA._entry, []

    def entry(dtype, dh):
        name = real(dtype, dh)
        entries.append(name)
        return name

    FA._entry = entry

    def restore():
        FA._entry = real

    return entries, restore


def phase_embeds_serving(device, cfg, prompt_len=3000, steps=SERVE_NEW,
                         max_len=SERVE_MAX_LEN, phase="18e"):
    """A stub-frontend arch served through the model's own entry points
    (``ServeEngine`` takes token-in archs only, as the reference's does):
    ``M.prefill`` of seeded N(0, 1) ``embeds`` (1, T, d) in bfloat16 with
    the kernels, its cache made float32 as the engine's serving cache is,
    then ``steps`` decode steps, each fed a (1, 1, d) embed at its
    position.  Every logit finite, every greedy token in the vocabulary,
    the launches exactly ``expected_launches``' per prefill and per step,
    the init and serving peaks under 80 GB.  Returns the run's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.models import model as M

    print(f"== phase {phase}: {cfg.name} prefill and decode of embeds "
          "(model.prefill, model.decode_step, bfloat16, kernels on)",
          flush=True)
    kernels = _lm_kernels()
    expect = expected_launches(cfg)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.n_params() / 1e9:.3f} B parameters; launches "
          f"expected per prefill and per decode step {expect}")
    params = bf16_weights(device, cfg)
    rng = np.random.default_rng(0)

    def embeds(t_len):
        return torch.as_tensor(rng.standard_normal(
            (1, t_len, cfg.d_model), dtype=np.float32)).to(device, torch.bfloat16)

    prompt = {"embeds": embeds(prompt_len)}
    feed = [{"embeds": embeds(1),
             "positions": torch.tensor([[prompt_len + i]], device=device)}
            for i in range(steps)]
    calls = []

    def call(fn, *args, **kwargs):
        _sync(device)
        before = {k: w.launches for k, w in kernels.items()}
        t0 = time.perf_counter()
        logits, cache, _ = fn(*args, **kwargs)
        token = int(torch.argmax(logits[0, -1]))
        finite = bool(torch.isfinite(logits).all())
        _sync(device)
        calls.append({"s": time.perf_counter() - t0, "finite": finite,
                      "token": token,
                      "launched": {k: w.launches - before[k]
                                   for k, w in kernels.items()}})
        return cache

    for w in (*kernels.values(), segment_sum):
        w.launches = 0
    t = time.perf_counter()
    cache = call(M.prefill, cfg, params, prompt, max_cache_len=max_len,
                 use_kernels=True)
    # float32, as the serving cache is whatever the compute dtype
    cache = M._tree_map(lambda _, a: a.float(), cache)
    for batch in feed:
        call(M.decode_step, cfg, params, batch, cache, use_kernels=True)
    _sync(device)
    wall = time.perf_counter() - t
    launches = {k: w.launches for k, w in kernels.items()}
    launches["segment_sum"] = segment_sum.launches

    pre, dec = calls[0], calls[1:]
    tokens = [x["token"] for x in calls]
    check(all(x["finite"] for x in calls), "a logit is not finite")
    check(len(tokens) == steps + 1 and all(0 <= tok < cfg.vocab for tok in tokens),
          f"greedy tokens {tokens}: not {steps + 1} in [0, {cfg.vocab})")
    for kind, xs, col in (("prefill", [pre], 0), ("decode step", dec, 1)):
        want = {k: v[col] for k, v in expect.items()}
        for x in xs:
            check(x["launched"] == want,
                  f"{kind} launched {x['launched']}, wanted {want}")
    for k, (per_prefill, per_step) in expect.items():
        total = per_prefill + per_step * len(dec)
        check(launches[k] == total,
              f"{k}: {launches[k]} launches in the run, wanted {total}")
    check(launches["flash_attention"] > 0, "the prefill never launched "
          "flash_attention")
    check(launches["segment_sum"] == 0, "serving launched segment_sum")
    decode_s = [x["s"] for x in dec]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"prefill T={prompt_len}: {pre['s']!r} s; decode: {len(dec)} steps "
          f"in {sum(decode_s)!r} s: {sum(decode_s) / len(dec) * 1e3!r} ms/step "
          f"(median {statistics.median(decode_s) * 1e3!r}, first step "
          f"{decode_s[0] * 1e3!r} ms); greedy tokens {tokens}")
    print(f"wall {wall!r} s; launches {launches}; peak device memory "
          f"{peak / 1e9!r} GB")
    check(peak < CARD_BYTES, f"peak device memory {peak / 1e9} GB over "
          f"{CARD_BYTES / 1e9} GB")
    if device.type == "cuda":
        profile_breakdown(lambda: M.decode_step(cfg, params, feed[0], cache,
                                                use_kernels=True),
                          "decode step (1 row)")
        profile_breakdown(lambda: M.prefill(cfg, params, prompt,
                                            max_cache_len=max_len,
                                            use_kernels=True),
                          f"prefill of {prompt_len} embeds")
    return launches


def _windows(cfg):
    """The attention windows of ``cfg``'s layers (None: full causal)."""
    ws = {b.window for b in cfg.pattern + cfg.tail if b.mixer == "attn"}
    return sorted(ws, key=lambda w: (w is None, w or 0))


def phase_arch_attention(device, cfg, t_len, phase, seed=6):
    """flash_attention at ``cfg``'s prefill shape (1, Hq, T, Dh) with its kv
    heads, for each window its layers use, in bfloat16 and float32: held
    to ``KERNEL_TOL`` against the plain version on the same inputs (its
    times at these shapes, from ``flash_timings``, are in PERF.md).
    Returns (max |err|, {shape label: the bf16 error and shape with the
    float32 error inside})."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    print(f"== phase {phase}: flash_attention at {cfg.name}'s prefill shape "
          f"(1, {hq}, {t_len}, {dh}) Hkv {hkv}, windows {_windows(cfg)}, "
          "against its plain version", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    worst, timed = 0.0, {}
    for window in _windows(cfg):
        label = f"(1, {hq}, {t_len}, {dh}) Hkv {hkv} window {window}"
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol = KERNEL_TOL[str(dtype)]
            q, k, v = (torch.randn((1, h, t_len, dh), generator=gen)
                       .to(device, dtype) for h in (hq, hkv, hkv))
            got = flash_attention(q, k, v, causal=True, window=window)
            _sync(device)
            want = attention_ref(q, k, v, causal=True, window=window)
            ok, err = _close(got, want, atol, rtol)
            del got, want
            check(ok and err == err, f"flash_attention {label} {dtype}: max "
                  f"|err| {err} over atol {atol} rtol {rtol}")
            worst = max(worst, err)
            print(f"flash_attention {label} causal {dtype}: max |err| {err!r} "
                  f"(atol {atol}, rtol {rtol})")
            if dtype == torch.float32:
                timed[label]["float32"] = {"max_abs_err": err}
            else:
                timed[label] = {"max_abs_err": err, "shape": {
                    "B": 1, "Hq": hq, "Hkv": hkv, "T": t_len, "S": t_len,
                    "Dh": dh, "window": window, "dtype": str(dtype)}}
            del q, k, v
    return worst, timed


#: (B, Hq, Hkv, T, S, Dh, causal, window, q_offset) of the bf16 width
#: check: Dh 40, 80, 96 and 192 on the ``wgmma`` kernel, padded to 64,
#: 128, 128 and 256 (192's last box wholly past Dh), and Dh 36, off TMA's
#: 16-byte rows, on the CUDA cores; T and S no multiple of a tile, GQA and
#: MQA, windows, ``q_offset``s, two batch rows, one case not causal
FLASH_WIDTH_CASES = (
    (2, 8, 2, 200, 200, 40, True, None, 0),
    (1, 12, 4, 333, 1333, 80, True, 512, 1000),
    (1, 32, 32, 700, 700, 96, True, None, 0),
    (2, 8, 8, 150, 277, 96, True, 64, 127),
    (1, 4, 2, 77, 190, 96, False, None, 0),
    (1, 8, 1, 257, 257, 192, True, 100, 0),
    (1, 8, 2, 130, 300, 36, True, None, 170),
)


def phase_flash_widths(device, cases=FLASH_WIDTH_CASES, phase="18w"):
    """bf16 ``flash_attention`` at head widths off the 64-column grid: each
    case's launch resolves the entry the rule names (``wgmma`` at Dh % 8 ==
    0, the CUDA-core kernel otherwise), launches once, and is held to the
    plain version at ``KERNEL_TOL``.  Returns {Dh: max |err|}."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    print(f"== phase {phase}: bf16 flash_attention at Dh "
          f"{sorted({c[5] for c in cases})} against its plain version",
          flush=True)
    gen = torch.Generator(device="cpu").manual_seed(7)
    atol, rtol = KERNEL_TOL[str(torch.bfloat16)]
    errs = {}
    for b, hq, hkv, t_len, s_len, dh, causal, window, q_offset in cases:
        q, k, v = (torch.randn((b, h, n, dh), generator=gen)
                   .to(device, torch.bfloat16)
                   for h, n in ((hq, t_len), (hkv, s_len), (hkv, s_len)))
        want_entry = ("flash_attention_bf16_wgmma" if dh % 8 == 0
                      else "flash_attention_bf16")
        entries, restore = _entry_recorder()
        before = flash_attention.launches
        try:
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
            _sync(device)
        finally:
            restore()
        launched = flash_attention.launches - before
        want = attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
        ok, err = _close(got, want, atol, rtol)
        label = (f"({b},{hq},{t_len},{dh}) Hkv {hkv} S {s_len} causal {causal}"
                 f" window {window} q_offset {q_offset}")
        check(entries == [want_entry] and launched == 1,
              f"flash_attention {label}: resolved {entries} in {launched} "
              f"launches, wanted {want_entry} once")
        check(ok and err == err and got.dtype == q.dtype,
              f"flash_attention {label} bf16: max |err| {err} over atol "
              f"{atol} rtol {rtol}")
        errs[dh] = max(errs.get(dh, 0.0), err)
        print(f"flash_attention {label} bf16 -> {want_entry}: max |err| "
              f"{err!r} (atol {atol}, rtol {rtol})")
    return errs


def phase_card_arch(device, spec, reduced=False, seen_shapes=None):
    """Phase 18 for one arch (``spec``): serving with the kernels, the
    kernels at its shapes against their plain versions (``flash_attention``
    at a shape not in the set ``seen_shapes``, which gets it), a float32
    cut against the plain versions, then training where ``spec`` trains.
    Returns what it adds to the kernels line."""
    import torch
    from repro_torch.kernels.flash_attention import _entry

    t = time.perf_counter()
    seen_shapes = set() if seen_shapes is None else seen_shapes
    cfg = card_arch_config(spec, reduced)
    traffic = (REDUCED_TRAFFIC if reduced else
               dict(max_len=spec.max_len, prompts=spec.prompts,
                    new_tokens=SERVE_NEW,
                    train=dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, lr=spec.train_lr), cut_seq=256))
    prompts = (traffic["prompts"] if cfg.frontend is None
               else (max(traffic["prompts"]),))
    reckoned = card_arch_bytes(spec)
    print(f"== phase {spec.phase}: {spec.arch} on the card (depth served "
          f"{spec.depth or 'all'}, prompts {prompts}, max_len "
          f"{traffic['max_len']}); reckoned at full width: "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in reckoned.items()),
          flush=True)
    check(all(v < CARD_BYTES for v in reckoned.values()),
          f"{spec.arch}: a run reckons over {CARD_BYTES / 1e9} GB: {reckoned}")
    out = {"arch": spec.arch}

    # serving, the kernels counted from 0 and the entries they resolve
    entries, restore = _entry_recorder()
    try:
        if cfg.frontend is None:
            launched = phase_serving(
                device, cfg=cfg, max_len=traffic["max_len"],
                new_tokens=traffic["new_tokens"], phase=spec.phase,
                prompts=serve_prompts(cfg.vocab, fixed=prompts, n_random=0))
        else:
            launched = phase_embeds_serving(
                device, cfg, prompt_len=prompts[0],
                steps=traffic["new_tokens"], max_len=traffic["max_len"],
                phase=spec.phase)
    finally:
        restore()
    want = _entry(torch.bfloat16, cfg.head_dim_)
    check(len(entries) >= launched["flash_attention"] > 0
          and set(entries) == {want},
          f"{spec.arch}: flash_attention resolved {sorted(set(entries))} in "
          f"{len(entries)} launches, wanted {want} in each")
    print(f"{spec.arch}: every flash_attention launch ({len(entries)}, "
          f"{launched['flash_attention']} while counted) took {want} at Dh "
          f"{cfg.head_dim_}")
    out["launches"], out["entry"] = launched, want
    free_device_memory(device)

    # the kernels at the served shapes, against their plain versions
    longest = max(prompts)
    shape = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, longest,
             tuple(_windows(cfg)))
    if shape not in seen_shapes:
        out["flash_err"], out["flash"] = phase_arch_attention(
            device, cfg, longest, f"{spec.phase} kernels")
        seen_shapes.add(shape)
    else:
        print(f"{spec.arch}: flash_attention's shape {shape} was held above")
    if cfg.n_experts:
        out["moe"], _ = phase_moe_kernel(
            device, launched, prompt_len=longest, d=cfg.d_model,
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, phase=f"{spec.phase} kernels",
            arch=spec.arch)
    free_device_memory(device)

    # the float32 cut (of the served config, to cut_depth layers): kernels
    # against plain versions
    f32 = dict(cfg=cfg, depth=spec.cut_depth, prompt_len=longest,
               max_len=traffic["max_len"], phase=f"{spec.phase} float32")
    if cfg.n_experts:
        phase_moe_model(device, walls=False, **f32)
    else:
        phase_model_kernels_vs_plain(device, **f32)
    free_device_memory(device)

    if spec.train:
        phase_training(device, spec.arch, reduced=reduced, profile=False,
                       phase=f"{spec.phase} training", **traffic["train"])
        free_device_memory(device)
    if spec.train_cut:
        phase_training_float32_cut(device, spec.arch, depth=2,
                                   seq=traffic["cut_seq"], reduced=reduced,
                                   phase=f"{spec.phase} training float32")
        free_device_memory(device)
    out["s"] = time.perf_counter() - t
    print(f"phase {spec.phase} ({spec.arch}): {out['s']:.1f} s", flush=True)
    return out


def phase_card_archs(device, archs=CARD_ARCHS, reduced=False):
    """Phase 18: each of ``archs`` through :func:`phase_card_arch`, the
    card's memory freed between them.  Returns their results by arch."""
    t = time.perf_counter()
    seen, done = set(), {}
    for spec in archs:
        done[spec.arch] = phase_card_arch(device, spec, reduced, seen)
    print(f"phase 18: {time.perf_counter() - t:.1f} s ("
          + ", ".join(f"{r['arch']} {r['s']:.1f} s" for r in done.values())
          + f") on {card_name_and_limit()}", flush=True)
    return done


# ---------------------------------------------------------------------------
# phase 19: the reference's long shapes
# ---------------------------------------------------------------------------

#: phase 19's archs, at full width and depth in bfloat16, with the depth of
#: each one's long_500k float32 cut: one pattern group without the tail
#: (RecurrentGemma's with its local attention layer), or None for an arch
#: that is not sub-quadratic, where the reference has no long_500k cell
LONG_ARCHS = (("19a", SERVE_ARCH, 3), ("19b", MAMBA_ARCH, 2),
              ("19c", GRANITE_ARCH, None))
#: the short prompts served beside the prefill_32k one, so that decode runs
#: with the decode_32k cache length live next to short neighbours
LONG_NEIGHBOURS = (17, 2049, 3000)
#: long_500k's decode steps, at the last positions of its cache
LONG_STEPS = 8
#: the query rows of each slice that the 32k attention check holds to the
#: plain version (whose whole (B, Hq, T, S) float32 scores would be 69 GB
#: at RecurrentGemma's shape and 103 GB at Granite's)
LONG_ROWS = 512
#: mamba_scan's channels held to its plain version at 32k: every 65th,
#: which meets every lane of the kernel's 32-channel tiles; on a CPU copy,
#: where its 32,768-step loop runs faster than on the card
LONG_MAMBA_CHANNELS = 65


def once_ms(fn, device):
    """(``fn()``, its milliseconds): CUDA events around one call on the
    card, the host clock around one on the CPU."""
    import torch

    if device.type != "cuda":
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _share(bound, device_ms):
    return None if not device_ms else bound / device_ms


def long_flash(device, cfg, t_len, in_place, seed=19):
    """flash_attention at ``cfg``'s 32k prefill shape (1, Hq, T, Dh) with
    its kv heads and window, in bfloat16 and float32: the output held to
    ``attention_ref`` at ``KERNEL_TOL`` on ``LONG_ROWS``-row slices of the
    queries (the first, one in the middle off the 64-row tiles, the last),
    each against the keys it can see (cut at the slice's last row and,
    under a window, at its first visible key; ``q_offset`` places the
    slice).  Beside it the plain version's time on the last slice, the
    kernel's time in the served prefill (``in_place``) and the bound; the
    kernel's own times at this shape and SDPA's are in PERF.md.  Returns
    the bf16 numbers with the float32 ones under "float32"."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    (window,) = _windows(cfg)
    label = f"(1, {hq}, {t_len}, {dh}) Hkv {hkv} window {window}"
    starts = (0, t_len // 2 - LONG_ROWS // 2 + 37, t_len - LONG_ROWS)
    print(f"-- flash_attention at {cfg.name}'s 32k shape {label}, query rows "
          f"{[(q0, q0 + LONG_ROWS) for q0 in starts]} held to the plain "
          "version", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {"shape": {"B": 1, "Hq": hq, "Hkv": hkv, "T": t_len, "S": t_len,
                     "Dh": dh, "window": window}, "max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = KERNEL_TOL[str(dtype)]
        q, k, v = (torch.randn((1, h, t_len, dh), generator=gen, device=device)
                   .to(dtype) for h in (hq, hkv, hkv))

        got = flash_attention(q, k, v, causal=True, window=window)
        _sync(device)

        def plain(q0):
            lo = 0 if window is None else max(0, q0 - window + 1)
            hi = q0 + LONG_ROWS
            return attention_ref(q[:, :, q0:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                                 causal=True, window=window, q_offset=q0 - lo)

        err = 0.0
        for q0 in starts:
            ok, e = _close(got[:, :, q0:q0 + LONG_ROWS], plain(q0), atol, rtol)
            check(ok and e == e and got.dtype == dtype,
                  f"flash_attention {label} {dtype} rows {q0}..{q0 + LONG_ROWS}:"
                  f" max |err| {e} over atol {atol} rtol {rtol}")
            err = max(err, e)
        del got
        _, plain_ms = once_ms(lambda: plain(starts[-1]), device)
        bound, bound_by = flash_bound_ms(q, k, True, window, 0)
        times = {"plain_ms": plain_ms, "plain_rows": LONG_ROWS,
                 "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}
        if dtype == torch.bfloat16:
            times["in_place_ms"] = in_place.get("flash_attention")
        print(f"flash_attention {label} {dtype}: max |err| {err!r} (atol "
              f"{atol}, rtol {rtol}); in the served prefill "
              f"{times.get('in_place_ms')!r} ms  bound {bound!r} ms "
              f"({bound_by})  plain on {LONG_ROWS} rows {plain_ms!r} ms",
              flush=True)
        if dtype == torch.float32:
            out["float32"] = times
        else:
            out.update(times, dtype=str(dtype))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del q, k, v
    return out


def long_rglru(device, width, t_len, in_place, seed=19):
    """rglru_scan at the 32k prefill (1, T, width), h0 zeros as a prefill
    starts, in bfloat16 and with float32 inputs (as the bf16 model gives
    them), held to the plain version at ``KERNEL_TOL``: the plain version
    takes every input in float32, so its one run on the float32 inputs
    (the bf16 values) gives both dtypes' want, the bf16 one rounded as it
    rounds it.  Beside it as ``long_flash``; returns the float32 inputs'
    numbers with the bf16 ones under "bf16"."""
    import torch
    from repro_torch.kernels.ref import rglru_scan_ref
    from repro_torch.kernels.rglru_scan import _geometry, chunking, rglru_scan

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((1, t_len, width), generator=gen, device=device).to(
        torch.bfloat16)
    a = torch.sigmoid(torch.randn((1, t_len, width), generator=gen,
                                  device=device)).to(torch.bfloat16)
    h0 = torch.zeros(1, width, device=device)
    (y_ref, h_ref), plain_ms = once_ms(
        lambda: rglru_scan_ref(x.float(), a.float(), h0), device)
    chunk, n_chunks = chunking(1, t_len, width, *_geometry(device.index or 0))
    out = {"shape": {"B": 1, "T": t_len, "D": width}, "max_abs_err": 0.0,
           "chunks": n_chunks, "chunk": chunk}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = KERNEL_TOL[str(dtype)]
        xs, gs = x.to(dtype), a.to(dtype)

        y, h_t = rglru_scan(xs, gs, h0)
        _sync(device)
        ok_y, err_y = _close(y, y_ref.to(dtype), atol, rtol)
        ok_h, err_h = _close(h_t, h_ref, atol, rtol)
        check(ok_y and ok_h and y.dtype == dtype,
              f"rglru_scan (1,{t_len},{width}) {dtype}: max |err| y {err_y} "
              f"h_T {err_h} over atol {atol} rtol {rtol}")
        del y, h_t
        bound, bound_by = rglru_bound_ms(xs, True)
        times = {"plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                 "max_abs_err": max(err_y, err_h), "library_ms": None}
        if dtype == torch.float32:
            times["in_place_ms"] = in_place.get("rglru_scan")
        print(f"rglru_scan (1,{t_len},{width}) {dtype}, {n_chunks} chunks of "
              f"{chunk} steps: max |err| y {err_y!r} h_T {err_h!r} (atol "
              f"{atol}, rtol {rtol}); in the served prefill "
              f"{times.get('in_place_ms')!r} ms  bound {bound!r} ms "
              f"({bound_by})  plain (float32 inputs, on the card) "
              f"{plain_ms!r} ms", flush=True)
        if dtype == torch.float32:
            out.update(times, dtype=str(dtype))
        else:
            out["bf16"] = times
        out["max_abs_err"] = max(out["max_abs_err"], err_y, err_h)
    return out


def long_mamba(device, d_inner, d_state, t_len, in_place, seed=19):
    """mamba_scan at the 32k prefill (1, T, d_inner, d_state) with A and D
    bfloat16 as the model holds them and a random h0, in bfloat16 and with
    float32 inputs, the whole shape on the card, held to the plain version
    at ``KERNEL_TOL`` on every ``LONG_MAMBA_CHANNELS``-th channel, run on
    a CPU copy (one run gives both dtypes' want, as in ``long_rglru``).
    Beside it as ``long_flash``; returns the float32 inputs' numbers with
    the bf16 ones under "bf16"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ref import mamba_scan_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    A = -torch.arange(1, d_state + 1, dtype=torch.float32, device=device
                      ).expand(d_inner, d_state).to(torch.bfloat16)
    D = normal(d_inner).to(torch.bfloat16)
    x = normal(1, t_len, d_inner).to(torch.bfloat16)
    delta = F.softplus(normal(1, t_len, d_inner)).to(torch.bfloat16)
    Bc = normal(1, t_len, d_state).to(torch.bfloat16)
    Cc = normal(1, t_len, d_state).to(torch.bfloat16)
    h0 = normal(1, d_inner, d_state)
    sl = torch.arange(0, d_inner, LONG_MAMBA_CHANNELS, device=device)
    cpu = torch.device("cpu")
    plain_args = [t.float().to(cpu) for t in (
        x[..., sl], delta[..., sl], A[sl], Bc, Cc, D[sl], h0[:, sl])]
    (y_ref, h_ref), plain_ms = once_ms(lambda: mamba_scan_ref(*plain_args), cpu)
    out = {"shape": {"B": 1, "T": t_len, "Di": d_inner, "Ds": d_state,
                     "A_D_dtype": "torch.bfloat16"},
           "plain_channels": f"every {LONG_MAMBA_CHANNELS}th of {d_inner} "
                             f"({sl.numel()}), on the CPU",
           "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = KERNEL_TOL[str(dtype)]
        args = (x.to(dtype), delta.to(dtype), A, Bc.to(dtype), Cc.to(dtype),
                D, h0)

        y, h_t = mamba_scan(*args)
        _sync(device)
        ok_y, err_y = _close(y[..., sl].cpu(), y_ref.to(dtype), atol, rtol)
        ok_h, err_h = _close(h_t[:, sl].cpu(), h_ref, atol, rtol)
        check(ok_y and ok_h and y.dtype == dtype,
              f"mamba_scan (1,{t_len},{d_inner},{d_state}) {dtype} on "
              f"{out['plain_channels']}: max |err| y {err_y} h_T {err_h} over "
              f"atol {atol} rtol {rtol}")
        del y, h_t
        bound, bound_by, sfu = mamba_bound_ms(1, t_len, d_inner, d_state,
                                              args[0].element_size(), 2, True)
        times = {"plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                 "exp_sfu_ms": sfu, "max_abs_err": max(err_y, err_h),
                 "library_ms": None}
        if dtype == torch.float32:
            times["in_place_ms"] = in_place.get("mamba_scan")
        print(f"mamba_scan (1,{t_len},{d_inner},{d_state}) {dtype}: max |err| "
              f"y {err_y!r} h_T {err_h!r} on {out['plain_channels']} (atol "
              f"{atol}, rtol {rtol}); in the served prefill "
              f"{times.get('in_place_ms')!r} ms  bound {bound!r} ms "
              f"({bound_by}; exp on the SFUs {sfu!r} ms)  plain on those "
              f"channels {plain_ms!r} ms", flush=True)
        if dtype == torch.float32:
            out.update(times, dtype=str(dtype))
        else:
            out["bf16"] = times
        out["max_abs_err"] = max(out["max_abs_err"], err_y, err_h)
    return out


def long_moe(device, cfg, t_len, in_place, seed=19):
    """moe_dispatch at the 32k prefill: ``t_len`` tokens' top-k rows into
    (E, C, d_model) at the prefill's capacity, every kept (expert, slot)
    pair unique, in bfloat16 (served) and float32 (the same values), held
    to the plain version bit for bit.  Beside it as ``long_flash``
    (``index_add_``'s times are in PERF.md); returns the bf16 numbers with
    the float32 ones under "float32"."""
    import torch
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.ref import moe_dispatch_ref

    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    c = moe_capacity(t_len, k, e, cfg.capacity_factor)
    tokens, ids, slot_ids = _routed(t_len, k, e, c, d, torch.bfloat16,
                                    "unique", device, seed)
    kept = int((slot_ids < c).sum())
    out = {"shape": {"T": tokens.shape[0], "D": d, "E": e, "C": c,
                     "kept": kept}, "max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        toks = tokens.to(dtype)

        got = moe_dispatch(toks, ids, slot_ids, e, c)
        want, plain_ms = once_ms(
            lambda: moe_dispatch_ref(toks, ids, slot_ids, e, c), device)
        check(torch.equal(got, want) and tuple(got.shape) == (e, c, d),
              f"moe_dispatch T={tokens.shape[0]} into ({e}, {c}, {d}) {dtype}: "
              "not equal bit for bit to the plain version")
        del got, want
        bound, bound_by = moe_bound_ms(kept, tokens.shape[0], d, e, c,
                                       toks.element_size())
        times = {"plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                 "max_abs_err": 0.0}
        if dtype == torch.bfloat16:
            times["in_place_ms"] = in_place.get("moe_dispatch")
        print(f"moe_dispatch T={tokens.shape[0]} D={d} E={e} C={c} {dtype}: "
              f"kept {kept}, equal bit for bit to the plain version; in the "
              f"served prefill {times.get('in_place_ms')!r} ms  bound "
              f"{bound!r} ms ({bound_by})  plain {plain_ms!r} ms", flush=True)
        if dtype == torch.float32:
            out["float32"] = times
        else:
            out.update(times, dtype=str(dtype))
        del toks
    return out


def phase_long_kernels(device, cfg, t_len, in_place):
    """Each LM kernel that ``cfg``'s layers launch, at its 32k prefill
    shape, against its plain version; ``in_place`` holds each
    kernel's device ms a call in the served prefill.  Returns the numbers
    by kernel name."""
    mixers = {b.mixer for b in cfg.pattern + cfg.tail}
    out = {}
    if "attn" in mixers:
        out["flash_attention"] = long_flash(device, cfg, t_len, in_place)
    if "rglru" in mixers:
        out["rglru_scan"] = long_rglru(device, cfg.rglru_width, t_len, in_place)
    if "ssm" in mixers:
        out["mamba_scan"] = long_mamba(device, cfg.ssm_d_inner, cfg.ssm_state,
                                       t_len, in_place)
    if cfg.n_experts:
        out["moe_dispatch"] = long_moe(device, cfg, t_len, in_place)
    return out


def phase_long_500k(device, cfg, params, cut_depth, phase, steps=LONG_STEPS):
    """long_500k as the reference's dry run lowers it: ``steps`` decode
    steps at the last positions of a zeroed float32 cache of 524,288
    positions (B = 1), ``cfg`` at full width and depth in bfloat16 with the
    kernels (``params``): the cache's bytes and leaves equal those of
    ``configs.cache_specs``' stand-in exactly, every greedy token lies in
    the vocabulary, every logit is finite and each step launches
    ``expected_launches``' per step.  Then a float32 cut of ``cut_depth``
    layers (one pattern group, no tail) through the same positions on
    seeded tokens, the kernels against the plain versions at
    ``MODEL_TOL``.  Returns the bf16 steps' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, cache_specs
    from repro_torch.models import model as M

    spec = SHAPES["long_500k"]
    n_pos, rows = spec.seq_len, spec.global_batch
    positions = range(n_pos - steps, n_pos)
    print(f"== phase {phase} long_500k: {cfg.name} decode at positions "
          f"{positions[0]}..{positions[-1]} from a zeroed float32 cache of "
          f"{n_pos} (B = {rows})", flush=True)
    kernels = _lm_kernels()
    expect = {k: v[1] for k, v in expected_launches(cfg).items()}

    def layout(tree):
        return [(tuple(a.shape), a.dtype) for a in _leaves(tree)]

    def nbytes(tree):
        return sum(a.numel() * a.element_size() for a in _leaves(tree))

    stand_in = cache_specs(cfg, "long_500k", torch.float32)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cache = M.init_cache(cfg, rows, n_pos, dtype=torch.float32, device=device)
    check(nbytes(cache) == nbytes(stand_in)
          and layout(cache) == layout(stand_in),
          f"the long_500k cache holds {nbytes(cache)} bytes, cache_specs' "
          f"stand-in {nbytes(stand_in)}")
    print(f"long_500k cache: {nbytes(cache)} bytes ({nbytes(cache) / 1e9!r} GB)"
          f", equal to cache_specs(cfg, 'long_500k', float32)'s")
    rng = np.random.default_rng(19)
    token, tokens, walls = int(rng.integers(0, cfg.vocab)), [], []
    for w in kernels.values():
        w.launches = 0
    for pos in positions:
        batch = {"tokens": torch.tensor([[token]], device=device),
                 "positions": torch.tensor([[pos]], device=device)}
        before = {k: w.launches for k, w in kernels.items()}
        _sync(device)
        t = time.perf_counter()
        logits, _, _ = M.decode_step(cfg, params, batch, cache, use_kernels=True)
        finite = bool(torch.isfinite(logits).all())
        token = int(torch.argmax(logits[0, -1]))
        walls.append(time.perf_counter() - t)
        launched = {k: w.launches - before[k] for k, w in kernels.items()}
        check(finite and 0 <= token < cfg.vocab,
              f"long_500k step at {pos}: finite {finite}, token {token}")
        check(launched == expect, f"long_500k step at {pos} launched "
              f"{launched}, wanted {expect}")
        tokens.append(token)
    launches = {k: w.launches for k, w in kernels.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"long_500k bf16, {steps} steps: {statistics.median(walls) * 1e3!r} "
          f"ms a step (median; first {walls[0] * 1e3!r} ms, last "
          f"{walls[-1] * 1e3!r} ms); greedy tokens {tokens}; launches "
          f"{launches}; peak device memory {peak / 1e9!r} GB")
    check(peak < CARD_BYTES, f"long_500k peak device memory {peak / 1e9} GB")
    del cache

    cut = dataclasses.replace(cfg, n_layers=cut_depth, tail=())
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    weights = M.init(cut, gen, device=device, dtype=torch.float32)
    feed = [int(t) for t in rng.integers(0, cfg.vocab, size=steps)]
    outs = {}
    for use_kernels in (True, False):
        cache = M.init_cache(cut, rows, n_pos, dtype=torch.float32,
                             device=device)
        before = sum(w.launches for w in kernels.values())
        outs[use_kernels] = [
            M.decode_step(cut, weights, {
                "tokens": torch.tensor([[tok]], device=device),
                "positions": torch.tensor([[pos]], device=device)},
                cache, use_kernels=use_kernels)[0]
            for tok, pos in zip(feed, positions)]
        _sync(device)
        launched = sum(w.launches for w in kernels.values()) - before
        check((launched > 0) == use_kernels,
              f"long_500k cut use_kernels={use_kernels}: {launched} launches")
        del cache
    atol, rtol = MODEL_TOL
    worst = 0.0
    for pos, got, want in zip(positions, outs[True], outs[False]):
        ok, err = _close(got, want, atol, rtol)
        check(ok and bool(torch.isfinite(got).all()),
              f"long_500k float32 cut, step at {pos}: max |err| {err} over "
              f"atol {atol} rtol {rtol}")
        worst = max(worst, err)
    print(f"long_500k float32 cut to depth {cut_depth} ({[b.mixer for b in cut.pattern]},"
          f" no tail), {steps} steps at positions {positions[0]}..{positions[-1]}:"
          f" kernels vs plain max |err| {worst!r} (atol {atol}, rtol {rtol}; "
          f"max |logit| {max(float(w.abs().max()) for w in outs[False])!r})")
    return launches


def phase_long_context(device, phase, arch, cut_depth, params=None):
    """Phase 19 for one arch at full width and depth in bfloat16 with the
    kernels (``params``; default: ``bf16_weights`` makes them): serving at
    32k (``ServeEngine``, 4 slots of ``max_len`` prefill_32k + 32, the
    32,768-token prompt beside ``LONG_NEIGHBOURS``, 32 new tokens each,
    checked as phase 5), each kernel its layers launch at its 32k shape
    against its plain version (``phase_long_kernels``), and for a
    sub-quadratic arch long_500k (``phase_long_500k``).  Returns the
    serving's and long_500k's launches, the kernels' numbers and the
    wall."""
    from repro_torch.configs import SHAPES, get_config

    t = time.perf_counter()
    cfg = get_config(arch)
    prompt_len = SHAPES["prefill_32k"].seq_len
    check(SHAPES["decode_32k"].seq_len == prompt_len,
          "decode_32k's cache is not the prefill_32k prompt's length")
    print(f"== phase {phase}: {arch}'s long shapes (prefill_32k, decode_32k"
          f"{', long_500k' if cut_depth else ''}) at full width and depth, "
          "bfloat16, kernels on", flush=True)
    if params is None:
        params = bf16_weights(device, cfg)
    profiles = {}
    launches = phase_serving(
        device, cfg=cfg, params=params, max_len=prompt_len + SERVE_NEW,
        prompts=serve_prompts(cfg.vocab, fixed=(prompt_len,) + LONG_NEIGHBOURS,
                              n_random=0),
        phase=f"{phase} 32k", profiles=profiles)
    in_place = (profiles.get("prefill") or {}).get("in_place", {})
    free_device_memory(device)
    kernels = phase_long_kernels(device, cfg, prompt_len, in_place)
    free_device_memory(device)
    if cut_depth is not None:
        for k, n in phase_long_500k(device, cfg, params, cut_depth,
                                    phase).items():
            launches[k] += n
        free_device_memory(device)
    s = time.perf_counter() - t
    print(f"phase {phase} ({arch}): {s:.1f} s", flush=True)
    return {"arch": arch, "launches": launches, "kernels": kernels, "s": s}


# ---------------------------------------------------------------------------
# phase 20: the reference's default serving dtype at full width and depth
# ---------------------------------------------------------------------------

#: (sub-phase, arch, the full-depth hold's prompt): Falcon-Mamba's is
#: shorter, as its plain scan at 3000 tokens would take 64 x 0.73 s (phase
#: 8b holds the 3000-token prompt at depth 4)
FLOAT32_ARCHS = (("20a", SERVE_ARCH, 3000), ("20b", MAMBA_ARCH, 512),
                 ("20c", GRANITE_ARCH, 3000), ("20d", "qwen3-1.7b", 3000))
#: the profiled float32 prefill's prompt: the longest that phases 5, 7 and
#: 9 serve
FLOAT32_PREFILL = 3000
#: the C entry of each LM kernel's float32 route
FLOAT32_ENTRIES = {"flash_attention": "flash_attention_f32_tc",
                   "rglru_scan": "rglru_scan_f32",
                   "mamba_scan": "mamba_scan_f32",
                   "moe_dispatch": "moe_dispatch_f32"}
#: the launcher's defaults, the reference's (src/repro/launch/serve.py):
#: 8 requests of 4-23 tokens, 16 new tokens each, 4 slots, max_len 256
LAUNCHER_REQUESTS, LAUNCHER_NEW = 8, 16


def _c_entry_recorder():
    """Record the C entry each LM kernel launch resolves: a launch calls
    its module's ``_kernel`` once, with the entry's name
    (``flash_attention``) or the dtype that picks it (``_ENTRY``, the
    others).  Returns ({kernel: [entry, ...]}, a function that
    unwraps)."""
    import importlib

    seen, real = {}, {}
    for name in LM_KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        real[name], seen[name] = mod._kernel, []

        def kernel(key, mod=mod, resolve=mod._kernel, log=seen[name]):
            log.append(key if isinstance(key, str) else mod._ENTRY[key])
            return resolve(key)

        mod._kernel = kernel

    def restore():
        for name, fn in real.items():
            importlib.import_module(f"repro_torch.kernels.{name}")._kernel = fn

    return seen, restore


def _float32_matmuls() -> None:
    """Fail unless float32 matmuls are float32: a TF32 GEMM would move the
    reference's numbers by about 1e-3, unseen."""
    import torch

    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    check(precision == "highest" and not tf32, f"float32 matmul precision "
          f"{precision!r}, allow_tf32 {tf32}: want 'highest' and False")


def phase_float32_launcher(device, arch, phase="20a"):
    """``repro_torch.launch.serve.main(["--arch", arch])``, the reference
    launcher's command as a user runs it: float32 (no ``--dtype``), full
    width and depth, the launcher's own seeded weights and requests.
    Checks the requests' tokens, every logit the engine saw, the launches
    of each admission and decode step against ``expected_launches``, the
    C entry of every launch (``FLOAT32_ENTRIES``), float32 matmuls without
    TF32, and the init and serving peaks; prints the tokens/s, decode
    steps, the wall and a profiled decode step.  Returns (the launcher's
    weights, kept through a wrapper of ``model.init``, the run's launches
    by kernel, its numbers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M

    cfg = get_config(arch)
    argv = ["--arch", arch]
    print(f"== phase {phase}: python -m repro_torch.launch.serve "
          f"{' '.join(argv)} (float32, the launcher's defaults) at full width "
          "and depth", flush=True)
    _float32_matmuls()
    kernels = _lm_kernels()
    made, records = {}, {"prefill": [], "decode": []}
    real_init = M.init

    def init(*args, **kwargs):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        made["params"] = real_init(*args, **kwargs)
        _sync(device)
        made["s"] = time.perf_counter() - t
        if device.type == "cuda":
            made["peak"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        return made["params"]

    entries, unwrap = _c_entry_recorder()
    restore = _record_model_calls(device, records)
    M.init = init
    try:
        for w in kernels.values():
            w.launches = 0
        t = time.perf_counter()
        done = launcher.main(argv)
        _sync(device)
        wall = time.perf_counter() - t
        launches = {k: w.launches for k, w in kernels.items()}
    finally:
        M.init = real_init
        restore()
        unwrap()
    _float32_matmuls()
    params = made.pop("params")
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    check(all(a.dtype == torch.float32 for a in _leaves(params)),
          "the launcher's weights are not all float32")
    serving_peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
    init_peak = made.get("peak", 0)
    print(f"init: {n_bytes / 1e9:.3f} GB of float32 weights in "
          f"{made['s']:.3f} s; init peak device memory {init_peak / 1e9!r} "
          f"GB; serving peak {serving_peak / 1e9!r} GB")
    for what, peak in (("init", init_peak), ("serving", serving_peak)):
        check(peak < CARD_BYTES, f"{what} peak device memory {peak / 1e9} GB "
              f"over {CARD_BYTES / 1e9} GB")
    check(len(done) == LAUNCHER_REQUESTS,
          f"{len(done)} of {LAUNCHER_REQUESTS} requests finished")
    _check_served(cfg, done, done, LAUNCHER_NEW, records, launches)
    for k, n in launches.items():
        check(entries[k] == [FLOAT32_ENTRIES[k]] * n,
              f"{k}: the launches resolved {sorted(set(entries[k]))} "
              f"({len(entries[k])} launches), wanted {FLOAT32_ENTRIES[k]} "
              f"{n} times")
    pre, dec = records["prefill"], records["decode"]
    decode_s = sum(x["s"] for x in dec)
    tokens = sum(len(r.output) for r in done)
    step_ms = sorted(x["s"] * 1e3 for x in dec)
    print(f"{cfg.name} float32 through the launcher: {len(done)} requests, "
          f"{tokens} tokens in {wall!r} s ({tokens / wall!r} tokens/s end to "
          f"end); {len(dec)} decode steps, "
          f"{(tokens - len(done)) / decode_s!r} tokens/s while decoding, "
          f"{statistics.median(step_ms)!r} ms/step median (first "
          f"{dec[0]['s'] * 1e3!r}, range {step_ms[0]!r}-{step_ms[-1]!r}); "
          f"prefills {[round(x['s'], 4) for x in pre]} s at T "
          f"{[x['T'] for x in pre]}; launches {launches}, every one on "
          f"{sorted({FLOAT32_ENTRIES[k] for k, n in launches.items() if n})}")
    numbers = {"wall_s": wall, "tokens_per_s": tokens / wall,
               "decode_steps": len(dec),
               "ms_per_step": statistics.median(step_ms),
               "init_peak_gb": init_peak / 1e9,
               "serving_peak_gb": serving_peak / 1e9,
               "weights_gb": n_bytes / 1e9}
    if device.type == "cuda":
        args, kwargs = records.pop("last decode")
        profile = profile_breakdown(lambda: M.decode_step(*args, **kwargs),
                                    f"decode step ({args[2]['tokens'].shape[0]}"
                                    " slots, float32)", warm=True)
        if profile:
            numbers["decode_busy_ms"] = profile["busy_ms"]
            numbers["decode_busy_share"] = profile["busy_ms"] / profile["wall_ms"]
    return params, launches, numbers


def phase_float32_serving(device, phase, arch, prompt_len, hand_on=False):
    """Phase 20 for one arch: the launcher at its defaults in float32
    (``phase_float32_launcher``), then the full-depth float32 hold on its
    weights, kernels against plain versions (``phase_model_kernels_vs_plain``;
    Granite ``phase_moe_model``, phase 10b's routing rule), then the
    kernels' prefill of ``FLOAT32_PREFILL`` seeded tokens as the engine
    runs it (only row T-1 unembedded), profiled: busy ms and share, top
    operations, each LM kernel's device ms in place.  With ``hand_on``, the weights' bfloat16 cast, which
    equals ``bf16_weights``' bit for bit (the same seeded float32 draws,
    cast), is returned for the bf16 phases; the float32 weights are freed.
    Returns {"arch", "launches", "numbers", "s", "bf16"}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    t = time.perf_counter()
    cfg = get_config(arch)
    params, launches, numbers = phase_float32_launcher(device, arch, phase)
    free_device_memory(device)
    hold = dict(cfg=cfg, depth=cfg.n_layers, prompt_len=prompt_len,
                params=params, phase=f"{phase} hold")
    if cfg.n_experts:
        phase_moe_model(device, walls=False, **hold)
    else:
        phase_model_kernels_vs_plain(device, **hold)
    free_device_memory(device)
    if device.type == "cuda":
        kernels = _lm_kernels()
        prompt = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, size=(1, FLOAT32_PREFILL)), device=device)}

        def prefill():
            out = M.prefill(cfg, params, prompt, max_cache_len=SERVE_MAX_LEN,
                            use_kernels=True, last_only=True)
            _sync(device)
            return out

        prefill()  # its first call with last_only
        t0 = time.perf_counter()
        prefill()
        numbers["prefill_s"] = time.perf_counter() - t0
        profile = profile_breakdown(
            prefill, f"{cfg.name} float32 prefill of {FLOAT32_PREFILL} "
            "tokens (kernels on, row T-1 unembedded)", warm=True) or {}
        in_place = dict(profile.get("in_place", {}))
        for name in profile.get("partial", []):
            # a partial trace: the kernel's device time from sessions of
            # their own, or its queued time printed
            in_place[name] = kernel_device_ms(
                prefill, KERNEL_NAMES[name], wrapper=kernels[name], calls=1)
        numbers.update(prefill_busy_ms=profile.get("busy_ms"),
                       prefill_wall_profiled_ms=profile.get("wall_ms"),
                       in_place_ms={k: v for k, v in in_place.items()
                                    if launches.get(k)})
        print(f"{cfg.name} float32 {FLOAT32_PREFILL}-token prefill (kernels on): "
              f"wall {numbers['prefill_s']!r} s; each LM kernel's device ms "
              f"a launch in place {numbers['in_place_ms']}")
    bf16 = None
    if hand_on:
        bf16 = M.cast_params(params, torch.bfloat16)
        # the first leaf drawn, the embedding, against a fresh bf16 draw
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        check(torch.equal(bf16["embed"], L._normal(
            gen, (cfg.vocab, cfg.d_model), 0.02, torch.bfloat16)),
            "the float32 weights' bf16 cast differs from a bf16 init")
    del params
    free_device_memory(device)
    s = time.perf_counter() - t
    print(f"phase {phase} ({arch}): {s:.1f} s", flush=True)
    return {"arch": arch, "launches": launches, "numbers": numbers, "s": s,
            "bf16": bf16}


# ---------------------------------------------------------------------------
# phase 21: the reference's training launcher on the block families no
# earlier phase trains
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainArch:
    """One arch of phase 21: the layers trained (``depth``, None for all),
    whether the launcher runs with ``--remat``, and the float32 cut's
    depth and whether it keeps the arch's tail."""

    phase: str
    arch: str
    depth: int | None
    remat: bool
    cut_depth: int
    cut_tail: bool = True


#: the three archs at full width, each at the deepest whole-group depth
#: whose reckoning (``train_bytes``) stays under the card.  Granite-MoE
#: trains whole.  Falcon-Mamba (116 GB of state whole) trains 24 of 64
#: layers with remat: without it the plain scan's per-step (B, d_inner,
#: d_state) float32 tensors kept for the backward (1.7 GB a layer) would
#: take the run past the card.  RecurrentGemma (153 GB whole) trains 8 of
#: 38 layers: two (RG-LRU, RG-LRU, local attention) groups and the RG-LRU
#: tail; its float32 cut is one whole group without the tail, so that it
#: holds a local attention layer
TRAIN_ARCHS = (
    TrainArch("21a", GRANITE_ARCH, None, False, 2),
    TrainArch("21b", MAMBA_ARCH, 24, True, 2),
    TrainArch("21c", SERVE_ARCH, 8, False, 3, cut_tail=False),
)
#: the reference launcher's defaults (``--batch 8 --seq 128 --lr 3e-4``,
#: float32, no remat: src/repro/launch/train.py), 6 steps with phase 11a's
#: 2 warm-up steps, so that the loss can fall in them.  Falcon-Mamba's
#: host-bound steps (4.1-7.1 s each on an H100's hosts) took a slow host's
#: whole run past 1150 s at 8; at 6 the mean of its last two losses is
#: still 0.7 below the first (11.66; 10.05 and 11.80)
TRAIN_ARCH_BATCH, TRAIN_ARCH_SEQ, TRAIN_ARCH_LR = 8, 128, "3e-4"
TRAIN_ARCH_STEPS, TRAIN_ARCH_WARMUP = 6, 2
#: bytes that autograd keeps a token in float32 for each pattern group and
#: for the tail (remat off), traced at full width from ``loss_fn``'s
#: forward on meta stand-ins by ``repro_torch.launch.dryrun.DeviceCounter``
#: at 8 x 128 tokens and rounded up (tests/test_torch_train_archs.py traces
#: them again).  Falcon-Mamba's is mostly the plain scan's two (B, d_inner,
#: d_state) tensors a step, 1 MiB a token
TRAIN_KEPT = {GRANITE_ARCH: (370_063, 0), MAMBA_ARCH: (1_629_060, 0),
              SERVE_ARCH: (1_436_457, 1_057_552)}


def train_bytes(arch, cfg, batch, seq, remat):
    """What one float32 training step of ``cfg`` (of ``arch``) on ``batch``
    x ``seq`` tokens holds on the card at its peak, reckoned from the
    config before anything is allocated: the state, 16 bytes a parameter
    (float32 masters, gradients and two AdamW moments), plus the larger of
    AdamW's temporaries (``adamw_update`` updates a leaf at a time with
    four float32 temporaries of its size: those of the largest leaf) and
    what the backward pass holds besides: four (tokens, vocab) float32
    tensors of the logits and their gradient, and the activations autograd
    keeps (``TRAIN_KEPT``; with remat each group's input, d_model floats a
    token, and one group's).  Returns the parts, their "total" and the
    "parameters" counted."""
    from repro_torch.launch.dryrun import meta_params

    tokens = batch * seq
    sizes = [a.numel() for a in _leaves(meta_params(cfg))]
    per_group, per_tail = TRAIN_KEPT[arch]
    tail = per_tail if cfg.tail else 0
    if remat:
        kept = cfg.n_groups * 4 * cfg.d_model + per_group + tail
    else:
        kept = cfg.n_groups * per_group + tail
    out = {"state": 16 * sum(sizes), "adamw": 4 * 4 * max(sizes),
           "logits": 4 * 4 * tokens * cfg.vocab, "activations": kept * tokens}
    out["total"] = out["state"] + max(out["adamw"],
                                      out["logits"] + out["activations"])
    out["parameters"] = sum(sizes)
    return out


def _gb(parts) -> str:
    """A reckoning's parts in GB."""
    return ", ".join(f"{k} {v / 1e9:.2f}" for k, v in parts.items()
                     if k != "parameters") + " GB"


def plain_scan_profile(device, cfg, batch, seq):
    """The plain Mamba scan (``mamba_scan_ref``) forward and backward under
    autograd at one of ``cfg``'s layers' training shapes, on seeded
    inputs, profiled after a warm-up: (device events, wall ms, device busy
    ms).  A training step runs it in every layer, the forward twice under
    remat: what makes the step host-bound."""
    import torch
    from repro_torch.kernels.ref import mamba_scan_ref
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=device).manual_seed(21)
    di, ds = cfg.ssm_d_inner, cfg.ssm_state

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.rand(shape, generator=gen, device=device) * scale
                + shift).requires_grad_()

    x, bc, cc = (draw(batch, seq, n, scale=2.0, shift=-1.0)
                 for n in (di, ds, ds))
    delta = draw(batch, seq, di, scale=0.1)
    a = draw(di, ds, scale=-8.0, shift=-0.5)
    d = draw(di)

    def run():
        y, h = mamba_scan_ref(x, delta, a, bc, cc, d)
        (y.sum() + h.sum()).backward()
        _sync(device)

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        wall = time.perf_counter() - t
    busy_us, n, _ = device_activity(prof)
    return n, wall * 1e3, busy_us / 1e3


def phase_train_arch(device, spec, reduced=False, steps=TRAIN_ARCH_STEPS,
                     batch=TRAIN_ARCH_BATCH, seq=TRAIN_ARCH_SEQ):
    """Phase 21a-21c for one arch: ``repro_torch.launch.train.main`` in this
    process at the reference launcher's defaults (float32), ``steps`` AdamW
    steps, ``--remat`` as ``spec`` says, the launcher's config cut to
    ``spec.depth`` layers.  The reckoning (``train_bytes``) must be under
    the card before anything is allocated; then every loss and grad norm
    finite, the mean of the last two losses below the first, the peak
    under the card and no LM kernel launched (counted from 0).  Prints the
    depth chosen and why, the init's wall, the step walls, tokens/s and the
    peak.  Returns its numbers."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    full = get_config(spec.arch)
    cfg = card_arch_config(spec, reduced)
    reckoned = train_bytes(spec.arch, cfg, batch, seq, spec.remat)
    reckoning_s = time.perf_counter() - t0
    why = ("all of them" if cfg.n_layers == full.n_layers else
           f"of {full.n_layers}: the whole arch's state alone is "
           f"{16 * full.n_params() / 1e9:.1f} GB")
    print(f"== phase {spec.phase}: training {cfg.name} through "
          f"repro_torch.launch.train at full width (d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}), depth {cfg.n_layers} ({why}), "
          f"{cfg.n_params() / 1e9:.3f} B parameters; {steps} AdamW steps of "
          f"{batch} x {seq} tokens at peak lr {TRAIN_ARCH_LR}, float32, remat "
          f"{'on' if spec.remat else 'off'}; reckoned {_gb(reckoned)} in "
          f"{reckoning_s:.2f} s", flush=True)
    if spec.depth is not None and not reduced:
        deeper = dataclasses.replace(cfg, n_layers=cfg.n_layers
                                     + len(cfg.pattern))
        more = train_bytes(spec.arch, deeper, batch, seq, spec.remat)
        print(f"the next whole group, depth {deeper.n_layers}, reckons "
              f"{more['total'] / 1e9:.2f} GB ({_gb(more)})")
    check(reckoned["total"] < CARD_BYTES, f"{spec.phase}: the step reckons "
          f"{reckoned['total'] / 1e9} GB, over {CARD_BYTES / 1e9} GB")
    _float32_matmuls()
    if device.type == "cuda":
        _sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    kernels = _wrappers()
    made, records = {}, []
    real_config, real_init = launch_train.get_config, M.init

    def init(*args, **kwargs):
        t = time.perf_counter()
        params = real_init(*args, **kwargs)
        _sync(device)
        made["s"] = time.perf_counter() - t
        return params

    argv = _train_argv(spec.arch, reduced, steps, batch, seq, "--lr",
                       TRAIN_ARCH_LR, "--warmup", str(TRAIN_ARCH_WARMUP),
                       "--device", str(device),
                       *(["--remat"] if spec.remat else []))
    launch_train.get_config = lambda name: dataclasses.replace(
        real_config(name), n_layers=cfg.n_layers)
    M.init = init
    try:
        for w in kernels.values():
            w.launches = 0
        t = time.perf_counter()
        state, lines = _run_launcher(argv, records, device)
        wall = time.perf_counter() - t
        launches = {k: w.launches for k, w in kernels.items()}
    finally:
        launch_train.get_config, M.init = real_config, real_init
    check(not any(launches.values()),
          f"{spec.phase}: the training path launched a kernel: {launches}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n_params = sum(a.numel() for a in _leaves(state.params))
    check(n_params == reckoned["parameters"], f"{spec.phase}: {n_params} "
          f"parameters trained, {reckoned['parameters']} reckoned")
    del state
    logged = [dict(f.split("=") for f in line.split()[2:])
              for line in lines if line.startswith("step ")]
    check(len(logged) == steps == len(records) and lines[-1] == "[train] done",
          f"{spec.phase}: {len(logged)} step lines and {len(records)} steps, "
          f"wanted {steps}; last line {lines[-1]!r}")
    losses = [r["loss"] for r in records]
    gnorms = [r["grad_norm"] for r in records]
    check(all(map(math.isfinite, losses + gnorms)),
          f"{spec.phase}: a loss or grad norm is not finite: {losses} {gnorms}")
    first, last_two = losses[0], statistics.mean(losses[-2:])
    check(last_two < first, f"{spec.phase}: loss did not fall: first {first}, "
          f"mean of the last two {last_two}")
    check(peak < CARD_BYTES, f"{spec.phase}: peak device memory {peak / 1e9} "
          f"GB over {CARD_BYTES / 1e9} GB")
    warm = [r["s"] for r in records[1:]]
    median = statistics.median(warm)
    print(f"{spec.phase} losses {losses!r}")
    print(f"{spec.phase} grad norms {gnorms!r}")
    print(f"{spec.phase}: kernel launches while training {launches}; init "
          f"{made['s']!r} s; first step {records[0]['s']!r} s; warm steps "
          f"{warm!r} s, median {median!r} s; {batch * seq / median!r} "
          f"tokens/s; launcher wall {wall!r} s; peak device memory "
          f"{peak / 1e9!r} GB (reckoned {reckoned['total'] / 1e9!r})")
    out = {"arch": spec.arch, "depth": cfg.n_layers, "init_s": made["s"],
           "first_step_s": records[0]["s"], "warm_median_s": median,
           "tokens_per_s": batch * seq / median, "peak_gb": peak / 1e9,
           "reckoned_gb": reckoned["total"] / 1e9, "losses": losses}
    if cfg.family == "ssm" and device.type == "cuda":
        n, wall_ms, busy_ms = plain_scan_profile(device, cfg, batch, seq)
        out["plain_scan"] = {"events": n, "wall_ms": wall_ms,
                             "busy_ms": busy_ms}
        print(f"{spec.phase}: mamba_scan_ref forward and backward at one "
              f"layer's shapes ({batch}, {seq}, {cfg.ssm_d_inner}, "
              f"{cfg.ssm_state}), profiled: {n} device events, wall "
              f"{wall_ms!r} ms, device busy {busy_ms!r} ms (share "
              f"{busy_ms / wall_ms!r}); a step runs it in {cfg.n_layers} "
              f"layers{', the forward twice (remat)' if spec.remat else ''}")
    out["s"] = time.perf_counter() - t0
    print(f"phase {spec.phase} ({spec.arch}): {out['s']:.1f} s", flush=True)
    return out


def phase_train_archs(device, archs=TRAIN_ARCHS, reduced=False,
                      steps=TRAIN_ARCH_STEPS, batch=TRAIN_ARCH_BATCH,
                      seq=TRAIN_ARCH_SEQ):
    """Phase 21: each of ``archs`` trained through the launcher (21a-21c),
    the card's memory freed between them, then each one's float32 cut,
    loss and gradients on the card against the CPU at B = 1 and ``seq``
    tokens (21d; RecurrentGemma's without the tail).  Returns the numbers
    by phase."""
    t = time.perf_counter()
    out = {}
    for spec in archs:
        out[spec.phase] = phase_train_arch(device, spec, reduced, steps,
                                           batch, seq)
        free_device_memory(device)
    for spec in archs:
        base = card_arch_config(spec, reduced)
        if not spec.cut_tail:
            base = dataclasses.replace(base, n_layers=spec.cut_depth, tail=())
        worst, flips = phase_training_float32_cut(
            device, depth=spec.cut_depth, seq=seq, phase=f"21d {spec.arch}",
            cfg=base)
        out[spec.phase].update(cut_worst=worst, cut_flips=flips)
        free_device_memory(device)
    s = time.perf_counter() - t
    card = f" on {card_name_and_limit()}" if device.type == "cuda" else ""
    print(f"phase 21: {s:.1f} s ("
          + ", ".join(f"{p} {r['s']:.1f} s" for p, r in out.items())
          + f", the cuts {s - sum(r['s'] for r in out.values()):.1f} s)"
          + card, flush=True)
    return out


# ---------------------------------------------------------------------------
# the paper's own evaluation (phase 22)
# ---------------------------------------------------------------------------

#: the solves of the reference's paper figures
#: (``benchmarks/paper_figures.py``, ``_OPT`` at :49): 16 restarts x 400
#: steps, seed 0 for every platform
PAPER_OPT = dict(n_restarts=16, steps=400)
#: Figs 5, 6 and 8 (:80, :99, :136): 1, 2, 4 and 8 sites at alpha 0.1, 1
#: and 10, and Fig 4's alpha 2 at 8 sites (:58).  ``planetlab_platform``
#: always makes 8 nodes, so all 13 are one (8, 8, 8) shape: a mode under a
#: barrier setting is one batched call over them
PAPER_SITES = (1, 2, 4, 8)
PAPER_ALPHAS = (0.1, 1.0, 10.0)
PAPER_FIG4_ALPHAS = (0.1, 1.0, 2.0)
PAPER_PLATFORMS = tuple((n, a) for n in PAPER_SITES for a in PAPER_ALPHAS) \
    + ((8, 2.0),)
BARRIERS_GGG = ("G", "G", "G")
#: the solver modes of Figs 5, 6 and 8 (:83, :100, :139) and the two
#: heuristics (:60, :163), all under ``optimize_plan``'s default barriers
PAPER_MODES = ("myopic_multi", "e2e_push", "e2e_shuffle", "e2e_multi")
PAPER_HEURISTICS = ("uniform", "local_push")
#: Fig 7 (:114-120): one barrier at a time relaxed to pipelining, then all
PAPER_RELAXED = (("P", "G", "G"), ("G", "P", "G"), ("G", "G", "P"),
                 ("P", "P", "P"))
#: Fig 4 (:57, :66): the barrier settings each plan is priced and
#: simulated under, and the DES's chunk
PAPER_FIG4_BARRIERS = (("G", "P", "L"), ("P", "P", "L"), ("P", "G", "L"),
                       ("G", "G", "L"))
PAPER_CHUNK_MB = 32.0
#: Fig 10 (:196-204): a mapper slowed 4x at run time, unknown to the planner
PAPER_STRAGGLERS = {("m", 2): 4.0}
PAPER_DYNAMICS = {"static": {}, "spec": dict(speculation=True),
                  "spec+steal": dict(speculation=True, stealing=True)}
#: Fig 9's two applications besides word count: sessionization (gap 1000,
#: :157) in the reference's shape (100 entries a user, timestamps in [0,
#: 1e7)) and the full inverted index of a corpus of phase 2's words a
#: document and vocabulary (seed 6, :158), each at 4M records, a fifth of
#: the main path's 20M: at 20M their four runs each took 118 s of a 173.5 s
#: phase 22 on a slow host (PERF.md); word count's row is phase 2's own
#: 20M-word run
PAPER_LOGS = 4_000_000
PAPER_LOGS_PER_USER = 100
PAPER_SESSION_GAP = 1000
PAPER_INDEX_DOCS = 4_000
PAPER_LOGS_SEED, PAPER_INDEX_SEED = 5, 6
#: each application's calibrated platform, (MB a source, alpha), at those
#: sizes: 16-byte log records, alpha 1 (an identity map); 8-byte words
#: each emitted as a 16-byte posting, alpha 2
PAPER_APPS_D = {"sessionization": (8.0, 1.0), "inverted_index": (4.0, 2.0)}
#: a cell's bar: within PAPER_RTOL of the reference's makespan
#: (``PAPER_REF``); where the reference's anneal has not settled (its plans
#: at 390-410 steps spread more than that: ``PAPER_BAND``), within the band
#: they span, extended by half its width on each side, widened by
#: PAPER_RTOL.  The port's CPU plans at 390-410 steps fall outside the
#: reference's plans at 396-404 steps widened by PAPER_RTOL in 55 of 1,344
#: draws, outside this bar in none (``print_tables`` of
#: tests/test_torch_paper_figures.py): which point of the end cycle a
#: solve stops at is float32 rounding
PAPER_RTOL = 1e-3
#: the reference's orderings (``test_e2e_multi_dominates_other_modes``):
#: e2e_multi within 1% of every other mode, and each relaxed optimum of the
#: all-global one; at ``PAPER_OPT`` the reference holds both in every cell
PAPER_DOMINANCE = 1.01
#: the paper's numbers (its testbed; printed beside the card's, not bars)
PAPER_FIG4 = {"r2": 0.9412, "slope": 1.1464}
PAPER_CLAIMS = {"e2e_multi over myopic_multi": "82-87%",
                "e2e_multi over uniform": "65-82%",
                "multi-phase over the best single phase": "37-64%",
                "optimized over vanilla Hadoop (measured)": "31-41%"}


def paper_label(n, alpha) -> str:
    return f"{n},{alpha!r}"


def paper_app_label(app, d_mb) -> str:
    return f"{app} {d_mb!r} MB"


def paper_key(label, mode, barriers) -> str:
    """A cell of ``PAPER_REF``: the platform, the plan's mode (a plan
    solved under one setting and priced under another reads
    ``mode@setting``) and the barrier setting it is priced under."""
    return f"{label},{mode},{''.join(barriers)}"


def paper_bar(key, ref, band):
    """(lo, hi): the makespans a cell may take (``PAPER_RTOL``)."""
    check(key in ref, f"22: no reference makespan for {key}")
    if key in band:
        lo, hi = band[key]
        half = (hi - lo) / 2
        return (lo - half) * (1 - PAPER_RTOL), (hi + half) * (1 + PAPER_RTOL)
    return ref[key] * (1 - PAPER_RTOL), ref[key] * (1 + PAPER_RTOL)


def hold_cell(key, got, ref, band, held):
    """Check a modeled makespan against its cell's bar; keep the row."""
    import numpy as np

    lo, hi = paper_bar(key, ref, band)
    check(np.isfinite(got) and lo <= got <= hi,
          f"22 {key}: makespan {got!r} s outside [{lo!r}, {hi!r}] (the "
          f"reference's {ref[key]!r}" + (f", band {band[key]!r}"
                                         if key in band else "") + ")")
    held.append((key, got, ref[key], key in band))


def hold_order(label, got, lhs, rhs, ref):
    """The reference's orderings: ``got[lhs]`` within ``PAPER_DOMINANCE`` of
    ``got[rhs]`` wherever the reference's cells are (at ``PAPER_OPT``, in
    every cell: tests/test_torch_paper_figures.py)."""
    if ref[lhs] <= PAPER_DOMINANCE * ref[rhs]:
        check(got[lhs] <= PAPER_DOMINANCE * got[rhs],
              f"{label}: {lhs} {got[lhs]!r} s above {PAPER_DOMINANCE} x "
              f"{rhs}'s {got[rhs]!r} s")


def paper_solve(device, platforms, mode, barriers, opt, log, label):
    """One ``optimize_plan_batch`` call over ``platforms`` (seed 0 for each,
    as the reference's figures), timed between two synchronizations; its
    ``_solve_batch_many`` calls' inputs are appended to ``log["inputs"]``
    and its wall to ``log["walls"]``."""
    from repro_torch.core import optimize as O

    real = O._solve_batch_many
    inputs = []

    def recording(*args, **kwargs):
        inputs.append(args)
        return real(*args, **kwargs)

    O._solve_batch_many = recording
    try:
        _sync(device)
        t = time.perf_counter()
        out = O.optimize_plan_batch(platforms, mode, barriers=barriers,
                                    seeds=[0] * len(platforms), device=device,
                                    **opt)
        _sync(device)
        wall = time.perf_counter() - t
    finally:
        O._solve_batch_many = real
    log["inputs"] += inputs
    log["walls"].append((label, mode, "".join(barriers), len(platforms),
                         len(inputs), wall))
    print(f"{label}: optimize_plan_batch {mode} {''.join(barriers)} B="
          f"{len(platforms)} {opt['n_restarts']}x{opt['steps']}: "
          f"{len(inputs)} solver call(s), {wall:.3f} s", flush=True)
    return out


def paper_steps_vs_cpu(device, inputs, label, flat=(), steps=25,
                       profile=False):
    """Each recorded ``_solve_batch_many`` call run for ``steps`` steps from
    its own inputs on the card and on the CPU: x, y at atol 1e-4, the exact
    objective at rtol 1e-4 (phase 12c's bar), for every request but those
    in ``flat``, whose distances are printed, unchecked: a platform of
    identical nodes, where the objective is flat in the plan, its gradient
    at rounding level, and Adam's g/sqrt(v) makes each rounding a full step
    (the reference and the port, both on the CPU, are up to 2.7e-3 apart
    in x there after 25 steps: tests/test_torch_paper_figures.py; every
    solve of such a platform ends at uniform's makespan).  With ``profile``, the e2e_multi call's card run is
    profiled: its busy share and device events a step."""
    import torch
    from repro_torch.core import optimize as O

    cpu = torch.device("cpu")
    for args in inputs:
        kind, barriers, opt_x, opt_y = args[6:10]

        def solve(dev):
            moved = (tuple(a.to(dev) for a in args[0]),) + tuple(
                a.to(dev) for a in args[1:6])
            return O._solve_batch_many(*moved, kind, barriers, opt_x, opt_y,
                                       steps)

        name = (f"{kind} {''.join(barriers)} opt_x {opt_x} opt_y {opt_y} "
                f"B={args[1].shape[0]}")
        if (profile and (kind, opt_x, opt_y) == ("e2e", True, True)
                and device.type == "cuda"):
            from torch.profiler import ProfilerActivity, profile as prof_

            solve(device)
            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                solve(device)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            busy_us, n_events, _ = device_activity(prof)
            print(f"{label} solver profile, {name}, {steps} steps: wall "
                  f"{wall!r} s  device busy {busy_us / 1e6!r} s  busy share "
                  f"{busy_us / 1e6 / wall!r}  device events {n_events} "
                  f"({n_events / steps!r} a step)")
        got = [t.cpu() for t in solve(device)]
        want = solve(cpu)
        held = [b for b in range(args[1].shape[0]) if b not in flat]
        errs = (_held(f"{label} {name} x", got[0][held], want[0][held], 1e-4),
                _held(f"{label} {name} y", got[1][held], want[1][held], 1e-4),
                _held(f"{label} {name} exact", got[2][held], want[2][held],
                      0.0, 1e-4))
        print(f"{label} {name}, {steps} steps card against CPU: max |err| x "
              f"{errs[0]!r}, y {errs[1]!r}, exact {errs[2]!r} (x, y atol "
              "1e-4; exact rtol 1e-4)")
        if flat:
            flat_ = list(flat)
            rel = ((got[2][flat_] - want[2][flat_]).abs()
                   / want[2][flat_].abs()).max()
            print(f"  unchecked, the {len(flat_)} one-site requests (a flat "
                  f"objective): max |err| x "
                  f"{float((got[0][flat_] - want[0][flat_]).abs().max())!r}, "
                  f"y {float((got[1][flat_] - want[1][flat_]).abs().max())!r},"
                  f" exact relative {float(rel)!r}")


def _paper_log():
    return {"inputs": [], "walls": [], "held": []}


def _paper_platforms(cells=PAPER_PLATFORMS):
    from repro_torch.core import planetlab_platform

    return [planetlab_platform(n, alpha=a, seed=0) for n, a in cells]


def paper_modes(device, opt=PAPER_OPT, ref=None, band=None):
    """Phase 22a (Figs 5, 6, 8): every planner mode under all-global
    barriers over the 13 platforms, one batched call a mode (myopic_multi
    two: the push round, then the shuffle round from its x), uniform and
    local_push through the same front door, then a warm repeat of
    e2e_multi's call.  Every cell within its bar, none worse than
    uniform, the one-site platforms' modes all equal, e2e_multi within 1%
    of every other mode in every cell; the 25 steps of each call card
    against CPU (the one-site platforms' printed, unchecked), e2e_multi's
    profiled.  Returns ({mode: [PlanResult] by platform}, the log)."""
    import numpy as np

    ref = PAPER_REF if ref is None else ref
    band = PAPER_BAND if band is None else band
    print("== phase 22a: every planner mode under all-global barriers over "
          f"the {len(PAPER_PLATFORMS)} PlanetLab platforms (Figs 5, 6, 8)",
          flush=True)
    log = _paper_log()
    platforms = _paper_platforms()
    res = {}
    for mode in PAPER_HEURISTICS + PAPER_MODES:
        res[mode] = paper_solve(device, platforms, mode, BARRIERS_GGG, opt,
                                log, "22a")
    check(len(log["inputs"]) == 5, f"22a made {len(log['inputs'])} solver "
          "calls, not 5 (myopic_multi's two rounds, three single solves)")
    push, shuffle = log["inputs"][:2]
    xf = shuffle[3]
    pushed = np.stack([r.plan.x for r in res["myopic_multi"]])
    check(push[6] == "push" and shuffle[6] == "shuffle"
          and xf.device == push[1].device and xf.dtype == push[1].dtype
          and tuple(xf.shape) == pushed.shape
          and np.array_equal(xf.cpu().numpy(), pushed.astype(np.float32)),
          f"22a: myopic_multi's shuffle round did not start from the push "
          f"round's x on {device} ({xf.dtype}, {tuple(xf.shape)} on "
          f"{xf.device})")
    paper_solve(device, platforms, "e2e_multi", BARRIERS_GGG, opt,
                {"inputs": [], "walls": log["walls"]}, "22a warm repeat")
    for g, (n, a) in enumerate(PAPER_PLATFORMS):
        label = paper_label(n, a)
        uni = res["uniform"][g].makespan
        got = {paper_key(label, mode, BARRIERS_GGG): rows[g].makespan
               for mode, rows in res.items()}
        multi = paper_key(label, "e2e_multi", BARRIERS_GGG)
        for key, span in got.items():
            hold_cell(key, span, ref, band, log["held"])
            check(span <= uni * (1 + 1e-9),
                  f"22a {key}: {span!r} s worse than uniform {uni!r}")
            hold_order("22a", got, multi, key, ref)
        if n == 1:  # 8 identical nodes: every plan is as good as uniform
            spans = [rows[g].makespan for rows in res.values()]
            check(max(spans) - min(spans) <= 1e-9 * uni,
                  f"22a {label}: the one-site modes differ: {spans!r}")
        print(f"22a {label}: " + "  ".join(
            f"{mode} {rows[g].makespan:.2f}" for mode, rows in res.items()))
    for a in PAPER_ALPHAS:
        g = PAPER_PLATFORMS.index((8, a))
        m = {mode: rows[g].makespan for mode, rows in res.items()}
        single = min(m["e2e_push"], m["e2e_shuffle"])
        print(f"22a 8 sites alpha {a}: e2e_multi over myopic_multi "
              f"{1 - m['e2e_multi'] / m['myopic_multi']:.2%}, over uniform "
              f"{1 - m['e2e_multi'] / m['uniform']:.2%}, over the best single "
              f"phase {1 - m['e2e_multi'] / single:.2%} (the paper: "
              f"{PAPER_CLAIMS['e2e_multi over myopic_multi']}, "
              f"{PAPER_CLAIMS['e2e_multi over uniform']}, "
              f"{PAPER_CLAIMS['multi-phase over the best single phase']})")
    for n in PAPER_SITES:
        ratios = []
        for a in PAPER_ALPHAS:
            g = PAPER_PLATFORMS.index((n, a))
            uni = res["uniform"][g].makespan
            ratios.append(
                f"alpha {a}: myopic {res['myopic_multi'][g].makespan / uni:.3f}"
                f", e2e {res['e2e_multi'][g].makespan / uni:.3f}")
        print(f"22a Fig 8, {n} site(s), over uniform: " + "; ".join(ratios))
    flat = [g for g, (n, _) in enumerate(PAPER_PLATFORMS) if n == 1]
    paper_steps_vs_cpu(device, log["inputs"], "22a", flat, profile=True)
    return res, log


def paper_barriers(device, all_global=None, opt=PAPER_OPT, ref=None,
                   band=None):
    """Phase 22b (Fig 7): e2e_multi under each relaxed barrier setting over
    the three 8-site platforms, one batched call a setting; each cell
    within its bar, each relaxed optimum within 1% of the all-global one
    (22a's, or solved here where 22b runs alone); the 25 steps of each
    call card against CPU."""
    ref = PAPER_REF if ref is None else ref
    band = PAPER_BAND if band is None else band
    print("== phase 22b: e2e_multi with one barrier at a time relaxed to "
          "pipelining, and all (Fig 7), at 8 sites", flush=True)
    log = _paper_log()
    cells = [(8, a) for a in PAPER_ALPHAS]
    platforms = _paper_platforms(cells)
    if all_global is None:
        all_global = paper_solve(device, platforms, "e2e_multi", BARRIERS_GGG,
                                 opt, log, "22b (its all-global optimum, "
                                 "alone)")
        for (n, a), r in zip(cells, all_global):
            hold_cell(paper_key(paper_label(n, a), "e2e_multi", BARRIERS_GGG),
                      r.makespan, ref, band, log["held"])
    rows = {}
    for b in PAPER_RELAXED:
        rows["".join(b)] = paper_solve(device, platforms, "e2e_multi", b, opt,
                                       log, "22b")
    for g, (n, a) in enumerate(cells):
        label = paper_label(n, a)
        base = all_global[g].makespan
        glob = paper_key(label, "e2e_multi", BARRIERS_GGG)
        for b in PAPER_RELAXED:
            key = paper_key(label, "e2e_multi", b)
            hold_cell(key, rows["".join(b)][g].makespan, ref, band,
                      log["held"])
            hold_order("22b", {key: rows["".join(b)][g].makespan,
                               glob: base}, key, glob, ref)
        print(f"22b {label}: over the all-global optimum {base:.2f} s: "
              + "  ".join(f"{k} {r[g].makespan / base:.3f}"
                          for k, r in rows.items()))
    paper_steps_vs_cpu(device, log["inputs"], "22b")
    return rows, log


def paper_des(device, e2e_multi=None, opt=PAPER_OPT, ref=None, band=None):
    """Phase 22c (Fig 4): the all-global e2e_multi plans at 8 sites and
    alpha 0.1, 1 and 2 (22a's, or solved here where 22c runs alone) and
    uniform, each priced through ``GeoJob.with_plan`` under Fig 4's four
    barrier settings (every modeled makespan within its cell's bar) and
    simulated on the DES; the fit of simulated on modeled printed beside
    the reference's and the paper's, not held."""
    import numpy as np
    from repro_torch.api import GeoJob
    from repro_torch.core import uniform_plan

    ref = PAPER_REF if ref is None else ref
    band = PAPER_BAND if band is None else band
    print("== phase 22c: the model against the discrete-event simulator "
          "(Fig 4)", flush=True)
    log = _paper_log()
    cells = [(8, a) for a in PAPER_FIG4_ALPHAS]
    platforms = _paper_platforms(cells)
    if e2e_multi is None:
        e2e_multi = paper_solve(device, platforms, "e2e_multi", BARRIERS_GGG,
                                opt, log, "22c (its plans, alone)")
        paper_steps_vs_cpu(device, log["inputs"], "22c")
    preds, meas, sim_s = [], [], 0.0
    for (n, a), p, solved in zip(cells, platforms, e2e_multi):
        job = GeoJob(p, device=device)
        label = paper_label(n, a)
        for name, plan in (("uniform", uniform_plan(p)),
                           ("e2e_multi@GGG", solved.plan)):
            for b in PAPER_FIG4_BARRIERS:
                modeled = job.with_plan(plan, b).planned.makespan
                hold_cell(paper_key(label, name, b), modeled, ref, band,
                          log["held"])
                t = time.perf_counter()
                sim = job.simulate(chunk_mb=PAPER_CHUNK_MB).makespan
                sim_s += time.perf_counter() - t
                check(np.isfinite(sim), f"22c {label} {name} {b}: simulated "
                      f"{sim!r}")
                preds.append(modeled)
                meas.append(sim)
    preds, meas = np.asarray(preds), np.asarray(meas)
    slope = float(np.polyfit(preds, meas, 1)[0])
    r2 = float(np.corrcoef(preds, meas)[0, 1] ** 2)
    print(f"22c Fig 4: {preds.size} runs, R^2 {r2!r}, slope {slope!r} (the "
          f"reference's {REF_FIG4['r2']!r}, {REF_FIG4['slope']!r}; the "
          f"paper's {PAPER_FIG4['r2']}, {PAPER_FIG4['slope']}); DES "
          f"{sim_s / preds.size * 1e3:.1f} ms a run")
    return {"r2": r2, "slope": slope}, log


def expected_sessions(users, values, gap):
    """A plain numpy sessionization of a whole log: (user, timestamp,
    starts a session) in (user, timestamp) order."""
    import numpy as np

    ts = values & ((1 << 32) - 1)
    order = np.lexsort((ts, users))
    u, t = users[order], ts[order]
    start = np.ones(u.size, bool)
    start[1:] = (u[1:] != u[:-1]) | (t[1:] - t[:-1] > gap)
    return u, t, start


def _in_key_order(label, outputs, *columns):
    """The reducers' outputs, each in key order, merged in key order: a
    stable sort keeps each reducer's order within a key, so that rows
    sorted within their reducer stay sorted.  Checks each key lies at one
    reducer.  Returns the keys, then each of ``columns(keys, values)``."""
    import numpy as np

    outs = [(k, v) for k, v in outputs if k.size]
    keys = np.concatenate([k for k, _ in outs])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    distinct = sum(int(np.count_nonzero(k[1:] != k[:-1])) + 1
                   for k, _ in outs)
    check(distinct == int(np.count_nonzero(keys[1:] != keys[:-1])) + 1,
          f"{label}: a key at more than one reducer")
    return (keys,) + tuple(np.concatenate([col(k, v) for k, v in outs])[order]
                           for col in columns)


def check_sessions(outputs, expect, label):
    """Each reducer's sessions numbered from 0 in (user, timestamp) order,
    each user at one reducer, and the cut points those of the whole
    log's."""
    import numpy as np

    def starts(k, v):
        sid = v >> 32
        start = np.ones(k.size, bool)
        start[1:] = sid[1:] != sid[:-1]
        check(sid[0] == 0 and np.array_equal(np.diff(sid), start[1:]),
              f"{label}: a reducer's sessions are not numbered from 0")
        t = v & ((1 << 32) - 1)
        check(np.all((k[1:] > k[:-1]) | ((k[1:] == k[:-1])
                                         & (t[1:] >= t[:-1]))),
              f"{label}: a reducer's entries are not in (user, timestamp) "
              "order")
        return start

    got = _in_key_order(label, outputs, lambda k, v: v & ((1 << 32) - 1),
                        starts)
    check(all(np.array_equal(g, w) for g, w in zip(got, expect)),
          f"{label}: sessions differ from a numpy sessionization of the log")


def expected_postings(values):
    """The full inverted index of a corpus in numpy: every (word, posting)
    of the map output in (word, posting) order."""
    import numpy as np

    words = values & ((1 << 20) - 1)
    postings = ((values >> 40) << 20) | ((values >> 20) & ((1 << 20) - 1))
    order = np.lexsort((postings, words))
    return words[order], postings[order]


def check_postings(outputs, expect, label):
    """Each reducer's postings in (word, posting) order, each word at one
    reducer, and all of them the whole map output's."""
    import numpy as np

    def sorted_postings(k, v):
        check(np.all((k[1:] > k[:-1]) | ((k[1:] == k[:-1])
                                         & (v[1:] >= v[:-1]))),
              f"{label}: a reducer's postings are not in (word, posting) "
              "order")
        return v

    got = _in_key_order(label, outputs, sorted_postings)
    check(all(np.array_equal(g, w) for g, w in zip(got, expect)),
          f"{label}: postings differ from numpy's index of the map output")


def paper_apps(device, wc_row, opt=PAPER_OPT, ref=None, band=None,
               n_logs=PAPER_LOGS, n_docs=PAPER_INDEX_DOCS,
               words_per_doc=WORDS_PER_DOC, vocab=VOCAB):
    """Phase 22d (Fig 9): word count (``wc_row``: phase 2's run), then
    sessionization and the full inverted index, each calibrated by a probe
    run and executed under uniform, local_push and e2e_multi at GGL; the
    two apps' calibrated platforms and Fig 10's planned in one batched GGL
    call (each cell within its bar; its 25 steps card against CPU).  Each
    execution's outputs against numpy, ``model_error`` finite, the
    optimized plan's measured makespan below both baselines'.  Returns
    (Fig 10's plan, the log, the rows)."""
    import numpy as np
    from repro_torch.api import GeoJob, split_sources
    from repro_torch.core import (BARRIERS_GGL, local_push_plan,
                                  planetlab_platform, uniform_plan)
    from repro_torch.mapreduce.apps import (generate_documents, generate_logs,
                                            inverted_index, sessionization)

    ref = PAPER_REF if ref is None else ref
    band = PAPER_BAND if band is None else band
    print("== phase 22d: the paper's three applications executed (Fig 9)",
          flush=True)
    log = _paper_log()
    base = planetlab_platform(8, alpha=1.0, seed=0)
    rows = {"word_count": wc_row}
    print(f"22d word_count (phase 2's run, {wc_row['opt']} at GGL): alpha "
          f"{wc_row['alpha']!r}; measured makespan uniform "
          f"{wc_row['uniform']!r} s, local_push {wc_row['local_push']!r} s, "
          f"e2e_multi {wc_row['e2e_multi']!r} s; model_error "
          f"{wc_row['model_error']!r}")
    apps = {}
    for name, make, gen, expect_fn in (
            ("sessionization", lambda: sessionization(gap=PAPER_SESSION_GAP),
             lambda: generate_logs(
                 n_logs, n_users=n_logs // PAPER_LOGS_PER_USER,
                 seed=PAPER_LOGS_SEED),
             lambda k, v: expected_sessions(k, v, PAPER_SESSION_GAP)),
            ("inverted_index", inverted_index,
             lambda: generate_documents(n_docs, words_per_doc, vocab=vocab,
                                        seed=PAPER_INDEX_SEED),
             lambda k, v: expected_postings(v))):
        t = time.perf_counter()
        keys, vals = gen()
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        expect = expect_fn(keys, vals)
        numpy_s = time.perf_counter() - t
        sources = split_sources(keys, vals, base.nS)
        t = time.perf_counter()
        job = GeoJob(base, make(), device=device).calibrate(sources)
        cal_s = time.perf_counter() - t
        d = job.platform.D
        check(np.all(d == d[0]), f"22d {name}: sources of unequal size {d}")
        d = float(d[0])
        apps[name] = (job, sources, expect, paper_app_label(name, d))
        print(f"22d {name}: {keys.size} records made in {gen_s:.3f} s, "
              f"numpy's answer in {numpy_s:.3f} s; calibrate {cal_s:.3f} s: alpha "
              f"{job.platform.alpha!r}, {d!r} MB a source", flush=True)
    platforms = [job.platform for job, *_ in apps.values()] + [base]
    planned = paper_solve(device, platforms, "e2e_multi", BARRIERS_GGL, opt,
                          log, "22d")
    labels = [label for *_, label in apps.values()] + [paper_label(8, 1.0)]
    for label, r in zip(labels, planned):
        hold_cell(paper_key(label, "e2e_multi", BARRIERS_GGL), r.makespan,
                  ref, band, log["held"])
    paper_steps_vs_cpu(device, log["inputs"], "22d")
    for (name, (job, sources, expect, label)), r in zip(apps.items(), planned):
        p = job.platform
        row = {"alpha": p.alpha}
        for pname, plan in (("uniform", uniform_plan(p)),
                            ("local_push", local_push_plan(p)),
                            ("e2e_multi", r.plan)):
            t = time.perf_counter()
            report = job.with_plan(plan, BARRIERS_GGL).execute(sources)
            wall = time.perf_counter() - t
            t = time.perf_counter()
            (check_sessions if name == "sessionization" else check_postings)(
                report.outputs, expect, f"22d {name} {pname}")
            check_s = time.perf_counter() - t
            err = report.model_error()
            check(np.isfinite(err), f"22d {name} {pname}: model_error {err}")
            row[pname] = report.makespan_measured
            row[f"{pname} model_error"] = err
            print(f"22d {name} {pname:10s} execute {wall:.3f} s (checked in "
                  f"{check_s:.3f} s)  measured makespan "
                  f"{report.makespan_measured!r} s  modeled "
                  f"{report.makespan_modeled!r} s  model_error {err!r}",
                  flush=True)
        for other in ("uniform", "local_push"):
            check(row["e2e_multi"] < row[other],
                  f"22d {name}: the optimized plan's measured makespan "
                  f"{row['e2e_multi']!r} s does not beat {other}'s "
                  f"{row[other]!r} s")
        rows[name] = row
    for name, row in rows.items():
        print(f"22d Fig 9 {name}: alpha {row['alpha']!r}, measured e2e_multi "
              f"over local_push (vanilla Hadoop) "
              f"{1 - row['e2e_multi'] / row['local_push']:.2%}, over uniform "
              f"{1 - row['e2e_multi'] / row['uniform']:.2%} (the paper: "
              f"{PAPER_CLAIMS['optimized over vanilla Hadoop (measured)']})")
    return planned[-1].plan, log, rows


def paper_dynamics(device, plan=None, opt=PAPER_OPT, ref=None, band=None):
    """Phase 22e (Fig 10): the GGL e2e_multi plan at 8 sites and alpha 1
    (22d's, or solved here where 22e runs alone) and local_push, simulated
    with a mapper slowed 4x, static, with speculation, and with speculation
    and stealing: finite, printed beside the reference's, not held."""
    import numpy as np
    from repro_torch.api import GeoJob
    from repro_torch.core import (BARRIERS_GGL, SimConfig, local_push_plan,
                                  planetlab_platform)

    ref = PAPER_REF if ref is None else ref
    band = PAPER_BAND if band is None else band
    print("== phase 22e: speculation and stealing under a straggler "
          "(Fig 10)", flush=True)
    log = _paper_log()
    base = planetlab_platform(8, alpha=1.0, seed=0)
    if plan is None:
        solved = paper_solve(device, [base], "e2e_multi", BARRIERS_GGL, opt,
                             log, "22e (its plan, alone)")[0]
        hold_cell(paper_key(paper_label(8, 1.0), "e2e_multi", BARRIERS_GGL),
                  solved.makespan, ref, band, log["held"])
        paper_steps_vs_cpu(device, log["inputs"], "22e")
        plan = solved.plan
    out = {}
    for name, p in (("optimized", plan), ("hadoop_baseline",
                                          local_push_plan(base))):
        job = GeoJob(base, device=device).with_plan(p, BARRIERS_GGL)
        out[name] = {dyn: job.simulate(SimConfig(
            barriers=BARRIERS_GGL, stragglers=PAPER_STRAGGLERS,
            **flags)).makespan for dyn, flags in PAPER_DYNAMICS.items()}
        check(all(np.isfinite(v) for v in out[name].values()),
              f"22e {name}: {out[name]}")
        print(f"22e {name}: " + "  ".join(
            f"{dyn} {float(v)!r} s (the reference's {REF_FIG10[name][dyn]!r})"
            for dyn, v in out[name].items()))
    return out, log


def phase_paper_figures(device, wc_row, opt=PAPER_OPT, ref=None, band=None,
                        **sizes):
    """Phase 22: the paper's evaluation through the port, 22a-22e in turn,
    each sharing what an earlier one solved; ``wc_row`` is phase 2's word
    count row, ``sizes`` the apps' corpus sizes (``paper_apps``).  Returns
    the numbers and ``segment_sum``'s launches in the phase (counted from
    0)."""
    from repro_torch.kernels.segment_reduce import segment_sum

    t0 = time.perf_counter()
    segment_sum.launches = 0
    res, log_a = paper_modes(device, opt, ref, band)
    g = [PAPER_PLATFORMS.index((8, a)) for a in PAPER_ALPHAS]
    fig7, log_b = paper_barriers(device, [res["e2e_multi"][i] for i in g],
                                 opt, ref, band)
    g = [PAPER_PLATFORMS.index((8, a)) for a in PAPER_FIG4_ALPHAS]
    fig4, log_c = paper_des(device, [res["e2e_multi"][i] for i in g], opt,
                            ref, band)
    plan, log_d, fig9 = paper_apps(device, wc_row, opt, ref, band, **sizes)
    fig10, log_e = paper_dynamics(device, plan, opt, ref, band)
    launches = segment_sum.launches
    logs = (log_a, log_b, log_c, log_d, log_e)
    held = [row for lg in logs for row in lg["held"]]
    walls = [w for lg in logs for w in lg["walls"]]
    banded = sorted(key for key, _, _, in_band in held if in_band)
    gaps = {b: max((abs(got - want) / want for _, got, want, in_band in held
                    if in_band == b), default=0.0) for b in (False, True)}
    s = time.perf_counter() - t0
    card = f" on {card_name_and_limit()}" if device.type == "cuda" else ""
    print(f"phase 22: {len(held)} cells held, {len(banded)} on the "
          f"reference's band ({banded}); worst gap to the reference's "
          f"makespan {gaps[False]!r} where it settled, {gaps[True]!r} on a "
          f"band; {len(walls)} optimize_plan_batch calls, "
          f"{sum(w[4] for w in walls)} solver calls, "
          f"{sum(w[-1] for w in walls):.1f} s; segment_sum launches "
          f"{launches}; {s:.1f} s{card}", flush=True)
    return {"launches": launches, "walls": walls, "held": held,
            "fig4": fig4, "fig9": fig9, "fig10": fig10, "s": s}


#: the reference's makespan of every cell phase 22 holds (seconds, float64
#: ``CostModel`` pricing), at ``PAPER_OPT`` (``print_tables`` of
#: tests/test_torch_paper_figures.py, which also holds it to a fresh
#: reference run)
PAPER_REF = {
    '1,0.1,uniform,GGG': 8.391155280295031,
    '1,0.1,local_push,GGG': 8.391155280295031,
    '1,0.1,myopic_multi,GGG': 8.391155280295031,
    '1,0.1,e2e_push,GGG': 8.391155280295031,
    '1,0.1,e2e_shuffle,GGG': 8.391155280295031,
    '1,0.1,e2e_multi,GGG': 8.391155280295031,
    '1,1.0,uniform,GGG': 22.392076554864662,
    '1,1.0,local_push,GGG': 22.392076554864662,
    '1,1.0,myopic_multi,GGG': 22.392076554864662,
    '1,1.0,e2e_push,GGG': 22.392076554864662,
    '1,1.0,e2e_shuffle,GGG': 22.392076554864662,
    '1,1.0,e2e_multi,GGG': 22.392076554864662,
    '1,10.0,uniform,GGG': 162.401289300561,
    '1,10.0,local_push,GGG': 162.401289300561,
    '1,10.0,myopic_multi,GGG': 162.401289300561,
    '1,10.0,e2e_push,GGG': 162.401289300561,
    '1,10.0,e2e_shuffle,GGG': 162.401289300561,
    '1,10.0,e2e_multi,GGG': 162.401289300561,
    '2,0.1,uniform,GGG': 88.91022690533765,
    '2,0.1,local_push,GGG': 34.64956079165002,
    '2,0.1,myopic_multi,GGG': 29.734085627774494,
    '2,0.1,e2e_push,GGG': 34.281622186143146,
    '2,0.1,e2e_shuffle,GGG': 84.07242997341994,
    '2,0.1,e2e_multi,GGG': 28.474900403322977,
    '2,1.0,uniform,GGG': 162.88119820260982,
    '2,1.0,local_push,GGG': 108.6205320889222,
    '2,1.0,myopic_multi,GGG': 59.30878127886781,
    '2,1.0,e2e_push,GGG': 108.49015403881474,
    '2,1.0,e2e_shuffle,GGG': 111.21086497227044,
    '2,1.0,e2e_multi,GGG': 41.842933919091735,
    '2,10.0,uniform,GGG': 902.5909111753317,
    '2,10.0,local_push,GGG': 848.3302450616441,
    '2,10.0,myopic_multi,GGG': 351.630374195352,
    '2,10.0,e2e_push,GGG': 600.9963252073089,
    '2,10.0,e2e_shuffle,GGG': 385.81557971989076,
    '2,10.0,e2e_multi,GGG': 116.13701960344059,
    '4,0.1,uniform,GGG': 518.6295036150273,
    '4,0.1,local_push,GGG': 63.60416890653756,
    '4,0.1,myopic_multi,GGG': 28.803576755049953,
    '4,0.1,e2e_push,GGG': 59.06666495254955,
    '4,0.1,e2e_shuffle,GGG': 481.7450152167024,
    '4,0.1,e2e_multi,GGG': 26.468426126916224,
    '4,1.0,uniform,GGG': 952.8317934937301,
    '4,1.0,local_push,GGG': 497.80645878524047,
    '4,1.0,myopic_multi,GGG': 127.85047385095098,
    '4,1.0,e2e_push,GGG': 218.6737980127382,
    '4,1.0,e2e_shuffle,GGG': 582.3352205954628,
    '4,1.0,e2e_multi,GGG': 126.94422379157703,
    '4,10.0,uniform,GGG': 5294.854692280759,
    '4,10.0,local_push,GGG': 4839.829357572269,
    '4,10.0,myopic_multi,GGG': 1135.9470053641662,
    '4,10.0,e2e_push,GGG': 1106.354070633933,
    '4,10.0,e2e_shuffle,GGG': 1588.417987499838,
    '4,10.0,e2e_multi,GGG': 765.6382057548078,
    '8,0.1,uniform,GGG': 553.3327995496854,
    '8,0.1,local_push,GGG': 75.76719739233732,
    '8,0.1,myopic_multi,GGG': 41.59469026374655,
    '8,0.1,e2e_push,GGG': 65.18850093790493,
    '8,0.1,e2e_shuffle,GGG': 518.591743523455,
    '8,0.1,e2e_multi,GGG': 38.12702000445527,
    '8,1.0,uniform,GGG': 1007.8211522684317,
    '8,1.0,local_push,GGG': 530.2555501110835,
    '8,1.0,myopic_multi,GGG': 181.66736693119688,
    '8,1.0,e2e_push,GGG': 221.10934211890233,
    '8,1.0,e2e_shuffle,GGG': 658.8486237196245,
    '8,1.0,e2e_multi,GGG': 136.82403847290433,
    '8,10.0,uniform,GGG': 5552.704679455893,
    '8,10.0,local_push,GGG': 5075.139077298545,
    '8,10.0,myopic_multi,GGG': 1604.3611201288697,
    '8,10.0,e2e_push,GGG': 1142.2611518085123,
    '8,10.0,e2e_shuffle,GGG': 2072.293076547344,
    '8,10.0,e2e_multi,GGG': 606.4805805195281,
    '8,2.0,uniform,GGG': 1512.8082108448161,
    '8,2.0,local_push,GGG': 1035.2426086874682,
    '8,2.0,myopic_multi,GGG': 337.3999760483638,
    '8,2.0,e2e_push,GGG': 365.3909445262387,
    '8,2.0,e2e_shuffle,GGG': 814.3723742832362,
    '8,2.0,e2e_multi,GGG': 219.05659568310023,
    '8,0.1,e2e_multi,PGG': 27.319306439106228,
    '8,0.1,e2e_multi,GPG': 24.15141967333345,
    '8,0.1,e2e_multi,GGP': 34.408760888635925,
    '8,0.1,e2e_multi,PPP': 13.281567448152247,
    '8,1.0,e2e_multi,PGG': 111.4112667314351,
    '8,1.0,e2e_multi,GPG': 82.51742236425285,
    '8,1.0,e2e_multi,GGP': 104.14580389209355,
    '8,1.0,e2e_multi,PPP': 45.718419137496745,
    '8,10.0,e2e_multi,PGG': 573.7403935924428,
    '8,10.0,e2e_multi,GPG': 416.548059792505,
    '8,10.0,e2e_multi,GGP': 383.8223177437191,
    '8,10.0,e2e_multi,PPP': 204.2083613053992,
    '8,0.1,uniform,GPL': 505.3574359151472,
    '8,0.1,uniform,PPL': 482.27697856848255,
    '8,0.1,uniform,PGL': 528.0653898450937,
    '8,0.1,uniform,GGL': 551.1458471917583,
    '8,0.1,e2e_multi@GGG,GPL': 26.121853500774147,
    '8,0.1,e2e_multi@GGG,PPL': 19.85776763072555,
    '8,0.1,e2e_multi@GGG,PGL': 31.45026588832839,
    '8,0.1,e2e_multi@GGG,GGL': 37.714351758376985,
    '8,1.0,uniform,GPL': 528.0675159230493,
    '8,1.0,uniform,PPL': 504.9870585763846,
    '8,1.0,uniform,PGL': 962.8711713424966,
    '8,1.0,uniform,GGL': 985.9516286891613,
    '8,1.0,e2e_multi@GGG,GPL': 89.88534836192,
    '8,1.0,e2e_multi@GGG,PPL': 89.88534836192,
    '8,1.0,e2e_multi@GGG,PGL': 115.94897352902431,
    '8,1.0,e2e_multi@GGG,GGL': 136.82403847290433,
    '8,2.0,uniform,GPL': 966.2350699942286,
    '8,2.0,uniform,PPL': 966.2350699942286,
    '8,2.0,uniform,PGL': 1445.9887063396109,
    '8,2.0,uniform,GGL': 1469.0691636862755,
    '8,2.0,e2e_multi@GGG,GPL': 141.26268107074895,
    '8,2.0,e2e_multi@GGG,PPL': 112.32366574449307,
    '8,2.0,e2e_multi@GGG,PGL': 190.11758035684437,
    '8,2.0,e2e_multi@GGG,GGL': 219.05659568310023,
    'sessionization 8.0 MB,e2e_multi,GGL': 4.069403784077662,
    'inverted_index 4.0 MB,e2e_multi,GGL': 3.108569411475708,
    '8,1.0,e2e_multi,GGL': 130.22092109048518,
}
#: (lo, hi) of the reference's plans at 390-410 steps, where they spread
#: more than PAPER_RTOL (the same script)
PAPER_BAND = {
    '2,1.0,myopic_multi,GGG': (59.308120071307755, 59.37817773449478),
    '2,1.0,e2e_multi,GGG': (41.711932968075445, 41.844150161808955),
    '2,10.0,myopic_multi,GGG': (351.630374195352, 360.37035247398427),
    '2,10.0,e2e_push,GGG': (600.5674899912449, 603.5877830678157),
    '4,0.1,myopic_multi,GGG': (28.357061074900315, 28.850414369361225),
    '4,0.1,e2e_multi,GGG': (26.44002592556182, 26.47215307694217),
    '4,1.0,e2e_push,GGG': (218.48055158908764, 220.50186938531354),
    '4,10.0,e2e_push,GGG': (1105.274926533898, 1115.1973967933059),
    '4,10.0,e2e_shuffle,GGG': (1586.4155607553528, 1588.4187522533707),
    '4,10.0,e2e_multi,GGG': (744.5236047780276, 765.6382057548078),
    '8,0.1,myopic_multi,GGG': (41.50070640868801, 41.60677892866366),
    '8,0.1,e2e_push,GGG': (65.09415074663879, 65.27598780229346),
    '8,1.0,myopic_multi,GGG': (181.35058478732128, 181.67133392291274),
    '8,1.0,e2e_push,GGG': (219.80782020638085, 221.10934211890233),
    '8,1.0,e2e_multi,GGG': (135.97314401442532, 139.49720902771185),
    '8,10.0,myopic_multi,GGG': (1583.617529719468, 1622.334384456306),
    '8,10.0,e2e_push,GGG': (1131.3282849839263, 1150.2666130512262),
    '8,10.0,e2e_shuffle,GGG': (2061.21189031738, 2098.1136633263955),
    '8,10.0,e2e_multi,GGG': (605.6989791192403, 606.5485135419389),
    '8,2.0,myopic_multi,GGG': (336.75434611037696, 337.40125052190666),
    '8,2.0,e2e_push,GGG': (364.08578230949365, 372.55832635045243),
    '8,2.0,e2e_shuffle,GGG': (814.3723742832362, 818.4719696495165),
    '8,2.0,e2e_multi,GGG': (215.3363720230137, 220.52469733154862),
    '8,0.1,e2e_multi,PGG': (27.213192059940376, 27.5900673061238),
    '8,0.1,e2e_multi,GGP': (34.312365447786945, 34.50734334806498),
    '8,0.1,e2e_multi,PPP': (13.252196538778778, 13.2990864385802),
    '8,1.0,e2e_multi,PGG': (110.69659634334863, 114.82751130478489),
    '8,1.0,e2e_multi,GPG': (81.70977962652677, 85.01597855237247),
    '8,1.0,e2e_multi,GGP': (102.51332327199404, 105.22299261800131),
    '8,1.0,e2e_multi,PPP': (44.645444372611834, 46.50480553868246),
    '8,10.0,e2e_multi,PGG': (572.665733786291, 573.7403935924428),
    '8,10.0,e2e_multi,GPG': (415.25168101189365, 417.64077686258884),
    '8,10.0,e2e_multi,GGP': (383.33020190236107, 384.19911786457266),
    '8,10.0,e2e_multi,PPP': (204.17602823486158, 205.1291032054344),
    '8,0.1,e2e_multi@GGG,GPL': (26.079705343704955, 26.121853500774147),
    '8,0.1,e2e_multi@GGG,PPL': (19.766475239984292, 19.892672157299575),
    '8,0.1,e2e_multi@GGG,PGL': (31.36744822158997, 31.478872323361546),
    '8,0.1,e2e_multi@GGG,GGL': (37.68067832531063, 37.72075507480508),
    '8,1.0,e2e_multi@GGG,GPL': (87.22267891355384, 105.1181685531689),
    '8,1.0,e2e_multi@GGG,PPL': (87.22267891355384, 105.1181685531689),
    '8,1.0,e2e_multi@GGG,PGL': (113.61694612441744, 121.80820220308641),
    '8,1.0,e2e_multi@GGG,GGL': (134.50027648311263, 139.49720902771185),
    '8,2.0,e2e_multi@GGG,GPL': (134.6807760692671, 143.21427846208405),
    '8,2.0,e2e_multi@GGG,PPL': (112.32366574449307, 137.9921242999453),
    '8,2.0,e2e_multi@GGG,PGL': (182.2307706338771, 191.72133484755926),
    '8,2.0,e2e_multi@GGG,GGL': (213.35253898540182, 220.52469733154862),
    'sessionization 8.0 MB,e2e_multi,GGL':
        (4.0590012849708, 4.1071374476299916),
    'inverted_index 4.0 MB,e2e_multi,GGL':
        (2.995771837773961, 3.1579598959123563),
    '8,1.0,e2e_multi,GGL': (129.8880411190656, 131.42839832415973),
}
#: the reference's Fig 4 fit and Fig 10 runs (the same script)
REF_FIG4 = {'r2': 0.9332396205444901, 'slope': 1.0514364762565251}
REF_FIG10 = {
    'optimized': {
        'static': 189.13984298253834,
        'spec': 253.28467163771538,
        'spec+steal': 202.14031154869073,
    },
    'hadoop_baseline': {
        'static': 530.1290529180151,
        'spec': 508.94252301627955,
        'spec+steal': 508.94252301627955,
    },
}

# ---------------------------------------------------------------------------
# phase 23: the control plane at the reference's scale
# ---------------------------------------------------------------------------

#: the reference benchmark's ``--quick`` budget (benchmarks/run.py:82), the
#: one its recorded run (benchmarks/baseline.json) took
CONTROL_OPT = dict(n_restarts=6, steps=200)
#: the solve cost 23a's held runs charge each swap: pinned, since the
#: measured charge is a half-decade bucket of this host's solve times (the
#: reference's jitted CPU solve falls in another bucket than the card's)
CONTROL_CHARGE_S = 1.0
#: a makespan's bar where the reference's anneal has settled; where it has
#: not (``REF_CONTROL_SPREAD``), ``control_bar`` widens it by its spread
CONTROL_RTOL = 1e-3
#: the seeds of ``run_online`` whose runs measure that spread, and the
#: relative moves of one bandwidth of each fabric that measure it too (a
#: solve whose winner does not move with the seed still moves with its
#: inputs: at 6 x 100 such a nudge moves reactive_solo's makespan by 5%)
CONTROL_SPREAD_SEEDS = (1, 2)
CONTROL_SPREAD_NUDGES = (1e-7, -1e-7)
#: schedule_failover (paper_figures.py:554): two jobs' volumes, a reducer
#: killed mid-shuffle, then cluster 1 partitioned until t = 400 s
FAILOVER_D = ((5000.0, 5000.0, 0.0), (3000.0, 3000.0, 0.0))
FAILOVER_POLICIES = ("reactive_shared", "reactive_failover")
#: schedule_online_shared (paper_figures.py:446): the steady job, the late
#: one arriving at 50 s, and the three co-replanning variants (name,
#: policy, the OnlineConfig's fields where it overrides the policy's)
SHARED_D = ((8000.0, 8000.0, 0.0, 0.0), (0.0, 0.0, 6000.0, 6000.0))
SHARED_ARRIVAL_S = 50.0
SHARED_VARIANTS = (("reactive_solo", "reactive", None),
                   ("reactive_shared", "reactive_shared", None),
                   ("shared_no_hysteresis", "reactive_shared",
                    dict(shared=True, hysteresis=0.0)))
#: fig12_replication (paper_figures.py:213)
FIG12_REPLICATION = (1, 2, 3)
#: bench_planner (paper_figures.py:627) at the quick budget: single solves
#: at 3 steps past it (a key no other scenario uses), replan_batch at its
#: production 500 steps, 8 warm solves, 8 seeded views, best of 3
PLANNER_OPT = dict(n_restarts=6, steps=203)
PLANNER_REPLAN_OPT = dict(n_restarts=6, steps=500)
PLANNER_WARM = 8
PLANNER_REPEATS = 3
#: online_1000 (paper_figures.py:934-966): 996 nodes, 100 fluid jobs, a
#: backbone-wide reducer brownout to 5% at 250 s, the 90 first released
#: live and the last 10 arriving at 300 s and 480 s, reactive_shared
#: co-replanning incrementally at a pinned 5 s decision cost
SCALE_TIER = dict(n_regions=12, edges_per_region=40, mappers_per_region=28,
                  n_backbone=4, reducers_per_backbone=45, seed=1)
SCALE_MIX = dict(n_jobs=100, seed=3, arrival_spread_s=600.0)
SCALE_LIVE = 90
SCALE_ARRIVALS_S = (300.0, 480.0)
SCALE_BROWNOUT = (250.0, 0.05)
SCALE_CHARGE_S = 5.0
#: the reference's CI budget for the run (its docstring), printed beside
#: the card's wall, not checked: hosts differ by up to 55% (PERF.md)
SCALE_BUDGET_S = 60.0
#: the fresh process that splits the first solve (``--first-solve``) is
#: stopped after this
FIRST_SOLVE_TIMEOUT_S = 300


def control_pkg(device):
    """The port's entry points for the phase-23 scenarios, each solve on
    ``device``; ``tests/test_torch_control_plane.py`` runs the same
    scenarios through the reference's (``api``, ``core``, ``dev`` = {})."""
    import types

    import repro_torch.api as api
    import repro_torch.core as core

    return types.SimpleNamespace(api=api, core=core,
                                 dev={"device": device},
                                 sync=lambda: _sync(device))


def failover_fabric(core, failures=()):
    """``failover_substrate`` (paper_figures.py:518): clusters A (s0, s1,
    m0, m1, r0, r1) and B (s2, m2, r2), a fast wide-area shuffle path into
    B's big reducer r2."""
    import numpy as np

    sub = core.Substrate(
        B_sm=np.array([[200.0, 200.0, 1.0], [200.0, 200.0, 1.0],
                       [1.0, 1.0, 200.0]]),
        B_mr=np.array([[200.0, 200.0, 150.0], [200.0, 200.0, 150.0],
                       [2.0, 2.0, 200.0]]),
        C_m=np.array([100.0, 100.0, 100.0]),
        C_r=np.array([100.0, 40.0, 500.0]),
        cluster_s=np.array([0, 0, 1]), cluster_m=np.array([0, 0, 1]),
        cluster_r=np.array([0, 0, 1]), name="failover")
    return sub.with_failures(list(failures)) if failures else sub


def failover_faults(core):
    """schedule_failover's faults (paper_figures.py:568-571)."""
    return [core.FailureEvent.reducer_kill(1, 115.0),
            core.FailureEvent.cluster_partition(1, 118.0, 400.0)]


def shared_online_fabric(core, t_drift=110.0):
    """``shared_online_substrate`` (paper_figures.py:410): the late job
    stuck on r1, r0 degrading 300 -> 40 MB/s at ``t_drift``, two nuisance
    steps on dead push links."""
    import numpy as np

    return core.Substrate(
        B_sm=np.array([[200.0, 200.0, 1.0, 1.0], [200.0, 200.0, 1.0, 1.0],
                       [1.0, 1.0, 200.0, 200.0], [1.0, 1.0, 200.0, 200.0]]),
        B_mr=np.array([[200.0, 200.0], [200.0, 200.0], [1.0, 200.0],
                       [1.0, 200.0]]),
        C_m=np.array([100.0, 100.0, 100.0, 100.0]),
        C_r=np.array([300.0, 60.0]),
        cluster_s=np.array([0, 0, 1, 1]), cluster_m=np.array([0, 0, 1, 1]),
        cluster_r=np.array([0, 1]), name="online_shared",
    ).with_traces({
        "reduce[r0]": core.CapacityTrace.step(300.0, 40.0, t_drift),
        "push[s0->m2]": core.CapacityTrace.step(1.0, 0.9, 150.0),
        "push[s1->m2]": core.CapacityTrace.step(1.0, 0.9, 180.0),
    })


def fig12_runs(pkg):
    """fig12_replication: local_push on the 8-site platform at alpha 1,
    simulated under GGL with 1, 2 and 3 replicas (cross-cluster past 1):
    {replicas: (makespan, push_end)}."""
    c = pkg.core
    p = c.planetlab_platform(8, alpha=1.0, seed=0)
    plan = c.local_push_plan(p)
    out = {}
    for r in FIG12_REPLICATION:
        res = c.simulate(p, plan, c.SimConfig(
            barriers=c.BARRIERS_GGL, replication=r,
            cross_cluster_replication=r > 1)).as_dict()
        out[r] = (res["makespan"], res["push_end"])
    return out


def control_online(pkg, sched, policy, online, **kwargs):
    """One ``run_online``, timed between two synchronizations: (report,
    wall, the run's ``SolveTimeEMA``)."""
    api = pkg.api
    real = api.SolveTimeEMA
    api.SolveTimeEMA = recorded = recording_ema(real)
    recorded.made.clear()
    try:
        pkg.sync()
        t = time.perf_counter()
        report = sched.run_online(policy=policy, online=online, **kwargs)
        pkg.sync()
        wall = time.perf_counter() - t
    finally:
        api.SolveTimeEMA = real
    return report, wall, recorded.made[0]


def control_online_configs(pkg, policy, override, charge, measured):
    """(label, OnlineConfig) of each run of a variant: the charge pinned,
    then, where ``measured``, the EMA's (the policy's own config)."""
    import dataclasses as dc

    c = pkg.core
    base = (c.get_online_config(policy) if override is None
            else c.OnlineConfig(**override))
    runs = [("pinned", dc.replace(base, solver_cost_s=charge))]
    if measured:
        runs.append(("measured", base))
    return runs


def control_failover(pkg, opt=CONTROL_OPT, charge=CONTROL_CHARGE_S, seed=0,
                     measured=True):
    """schedule_failover as paper_figures.py:554 builds it: the frozen
    joint plan of the two jobs, simulated under the faults with 2 replicas
    (audited), then ``run_online`` under each policy from the frozen plans.
    Returns {"frozen": makespan, "plans": the frozen plans, "runs":
    {(policy, label): (report, wall, ema)}}."""
    import numpy as np

    a, c = pkg.api, pkg.core
    GGL = c.BARRIERS_GGL
    d_steady, d_late = (np.array(d) for d in FAILOVER_D)
    sub0 = failover_fabric(c)
    frozen = a.GeoSchedule(
        [a.GeoJob(sub0.view(d_steady, 1.0, name="steady")),
         a.GeoJob(sub0.view(d_late, 1.0, name="late"))], **pkg.dev,
    ).plan("joint", mode="e2e_multi", barriers=GGL, **opt)
    plans = frozen.planned.plans
    cfg = c.SimConfig(barriers=GGL, replication=2, audit=True)
    subf = failover_fabric(c, failover_faults(c))
    sv = subf.view(d_steady, 1.0, name="steady")
    lv = subf.view(d_late, 1.0, name="late")
    frozen_sim = c.simulate_schedule([(sv, plans[0], cfg), (lv, plans[1], cfg)],
                                     substrate=subf)
    runs = {}
    for policy in FAILOVER_POLICIES:
        for label, online in control_online_configs(pkg, policy, None, charge,
                                                    measured):
            sched = a.GeoSchedule(
                [a.GeoJob(sv).with_plan(plans[0], GGL),
                 a.GeoJob(lv).with_plan(plans[1], GGL)], **pkg.dev,
            ).with_plans()
            runs[policy, label] = control_online(pkg, sched, policy, online,
                                                 cfg=cfg, seed=seed, **opt)
    return {"frozen": frozen_sim.makespan, "plans": plans, "runs": runs}


def control_online_shared(pkg, opt=CONTROL_OPT, charge=CONTROL_CHARGE_S,
                          seed=0, measured=True):
    """schedule_online_shared as paper_figures.py:446 builds it: the frozen
    joint plan of both jobs simulated with the late one released at 50 s,
    then the steady job planned alone and ``run_online`` under each variant
    with the late job arriving on its frozen plan.  Returns {"frozen":
    makespan, "plans": the frozen plans, "runs": {(variant, label):
    (report, wall, ema)}}."""
    import numpy as np

    a, c = pkg.api, pkg.core
    GGL = c.BARRIERS_GGL
    sub = shared_online_fabric(c)
    steady = a.GeoJob(sub.view(np.array(SHARED_D[0]), 1.0, name="steady"))
    late_view = sub.view(np.array(SHARED_D[1]), 1.0, name="late")
    cfg = c.SimConfig(barriers=GGL)
    frozen = a.GeoSchedule([steady, a.GeoJob(late_view)], **pkg.dev).plan(
        "joint", mode="e2e_multi", barriers=GGL, **opt)
    plans = frozen.planned.plans
    frozen_sim = c.simulate_schedule(
        [(steady.platform, plans[0], cfg),
         (late_view, plans[1], c.SimConfig(barriers=GGL,
                                           start_time=SHARED_ARRIVAL_S))],
        substrate=sub)
    sched = a.GeoSchedule([steady], **pkg.dev).plan(
        "independent", mode="e2e_multi", barriers=GGL, **opt)
    runs = {}
    for name, policy, override in SHARED_VARIANTS:
        for label, online in control_online_configs(pkg, policy, override,
                                                    charge, measured):
            arrival = a.Arrival(a.GeoJob(late_view, **pkg.dev).with_plan(
                plans[1], GGL), SHARED_ARRIVAL_S)
            runs[name, label] = control_online(
                pkg, sched, policy, online, arrivals=[arrival], cfg=cfg,
                seed=seed, **opt)
    return {"frozen": frozen_sim.makespan, "plans": plans, "runs": runs}


def control_cells(failover, shared):
    """The makespans 23a holds, keyed as ``REF_CONTROL``: each frozen
    schedule's, and each pinned run's online and static one."""
    cells = {"failover frozen": failover["frozen"],
             "online_shared frozen": shared["frozen"]}
    for scenario, out in (("failover", failover), ("online_shared", shared)):
        for (name, label), (report, _, _) in out["runs"].items():
            if label == "pinned":
                cells[f"{scenario} {name}"] = report.makespan_online
                cells[f"{scenario} {name} static"] = report.makespan_static
    return cells


def control_counts(out):
    """(decisions, swaps, rejected) of each pinned run of a scenario."""
    return {name: (len(r.decisions), len(r.swaps), len(r.rejected))
            for (name, label), (r, _, _) in out["runs"].items()
            if label == "pinned"}


def control_bar(key, spread):
    """A 23a or 23c makespan's relative bar: ``CONTROL_RTOL``, or where
    the reference's anneals have not settled (its spread ``s`` over other
    seeds and nudged inputs is over ``CONTROL_RTOL``) ``2 s + CONTROL_RTOL``:
    the band its runs span about its own, extended by half its width each
    side and widened by ``CONTROL_RTOL``, as phase 22's ``paper_bar``.  A
    few of the reference's runs do not span the card's, another sample of
    the same chaos: the card's first reactive_solo landed 1.84e-3 off
    against a spread of 1.31e-3, and the reference's own run at another
    seed 1.6e-3 off (tests/test_torch_control_plane.py)."""
    s = spread.get(key, 0.0)
    return 2 * s + CONTROL_RTOL if s > CONTROL_RTOL else CONTROL_RTOL


def hold_control(label, got, want, rtol):
    import numpy as np

    rel = abs(got - want) / abs(want)
    check(np.isfinite(got) and rel <= rtol,
          f"{label}: {got!r} s, the reference's {want!r} s: relative "
          f"{rel!r} over {rtol!r}")
    print(f"{label}: {got!r} s, the reference's {want!r} s, relative "
          f"{rel!r} (bar {rtol!r})")


def check_online_run(label, report, shared):
    """23a's and 23c's invariants of one ``run_online``: every plan valid,
    both makespans finite, and at every adopted decision nothing modeled
    worse than what it replaced (a shared stack's largest remaining, or a
    solo swap's own)."""
    import numpy as np
    from repro_torch.core.plan import validate_plan

    for plan in report.plans:
        validate_plan(plan.x, plan.y)
    for value in (report.makespan_online, report.makespan_static):
        check(np.isfinite(value), f"{label}: makespan {value!r}")
    if shared:
        check(stack_never_rises(report.decisions),
              f"{label}: an adopted stack's modeled remaining rose")
    else:
        worse = [d for d in report.swaps
                 if d.modeled_after >= d.modeled_before]
        check(not worse, f"{label}: swaps modeled worse: {worse}")


def print_online_run(label, report, wall, ema, want=None):
    print(f"{label}: wall {wall:.3f} s  online {report.makespan_online!r} s "
          f" static {report.makespan_static!r} s  decisions "
          f"{len(report.decisions)}  swaps {len(report.swaps)}  rejects "
          f"{len(report.rejected)}  charged {report.charged_s!r} s  EMA "
          f"charge {ema.charge_s()!r} s (warm solves {ema.samples}, first "
          f"calls {ema.excluded})"
          + ("" if want is None else
             f"  (the reference's decisions, swaps, rejects {want})"))


def phase_control_failover_shared(device, opt=CONTROL_OPT, ref=None,
                                  spread=None, counts=None, fig12=None):
    """Phase 23a: Fig 12's three DES runs, then schedule_failover and
    schedule_online_shared at the quick budget on the card, each online run
    with the charge pinned (held) and with the EMA's (invariants only)."""
    from repro_torch.core.plan import validate_plan

    ref = REF_CONTROL if ref is None else ref
    spread = REF_CONTROL_SPREAD if spread is None else spread
    counts = REF_CONTROL_COUNTS if counts is None else counts
    fig12 = REF_FIG12 if fig12 is None else fig12
    print("== phase 23a: failover, shared co-replanning and replication",
          flush=True)
    pkg = control_pkg(device)
    got = fig12_runs(pkg)
    for r, (span, push_end) in got.items():
        check(span == fig12[r],
              f"23a Fig 12, {r} replicas: makespan {span!r} s, the "
              f"reference's {fig12[r]!r} s")
        print(f"23a Fig 12, {r} replica(s): makespan {span!r} s (the "
              f"reference's, bit for bit), push ends {push_end!r} s")
    failover = control_failover(pkg, opt)
    shared = control_online_shared(pkg, opt)
    for scenario, out in (("failover", failover),
                          ("online_shared", shared)):
        for plan in out["plans"]:
            validate_plan(plan.x, plan.y)
        want = counts.get(scenario, {})
        for (name, label), (report, wall, ema) in out["runs"].items():
            tag = f"23a {scenario} {name} ({label} charge)"
            check_online_run(tag, report, name != "reactive_solo")
            print_online_run(tag, report, wall, ema,
                             want.get(name) if label == "pinned" else None)
    cells = control_cells(failover, shared)
    for key, value in cells.items():
        hold_control(f"23a {key}", value, ref[key], control_bar(key, spread))
    margins = {}
    for policy in FAILOVER_POLICIES:
        for label in ("pinned", "measured"):
            report = failover["runs"].get((policy, label), (None,))[0]
            if report is not None:
                margins[policy, label] = 1 - (report.makespan_online
                                              / failover["frozen"])
    ref_margin = 1 - ref["failover reactive_shared"] / ref["failover frozen"]
    print("23a failover_margin: " + "  ".join(
        f"{p} {label} {m!r}" for (p, label), m in margins.items())
        + f"  (the reference's, pinned: {ref_margin!r})")
    return {"fig12": got, "cells": cells, "margins": margins,
            "walls": {f"{s} {n} {label}": w
                      for s, out in (("failover", failover),
                                     ("online_shared", shared))
                      for (n, label), (_, w, _) in out["runs"].items()}}


def planner_service(pkg, opt=PLANNER_OPT, ropt=PLANNER_REPLAN_OPT,
                    warm=PLANNER_WARM, repeats=PLANNER_REPEATS):
    """bench_planner's sequence (paper_figures.py:627): the solver counters
    reset, a cold solve and ``warm`` warm ones on planetlab_platform(8, 1.0,
    seed=3), a B = 8 ``optimize_plan_batch`` over the seeded views (once to
    warm, once timed), their plans as incumbents, then ``replan_batch``
    full and incremental, each warmed and taken best of ``repeats``.  Each
    solve timed between two synchronizations."""
    import numpy as np

    c = pkg.core
    p = c.planetlab_platform(8, alpha=1.0, seed=3)

    def timed(fn, *args, **kwargs):
        pkg.sync()
        t = time.perf_counter()
        out = fn(*args, **kwargs, **pkg.dev)
        pkg.sync()
        return out, time.perf_counter() - t

    c.reset_solver_cache_stats()
    cold, cold_s = timed(c.optimize_plan, p, "e2e_multi", seed=0, **opt)
    warm_runs = [timed(c.optimize_plan, p, "e2e_multi", seed=s, **opt)
                 for s in range(1, warm + 1)]
    lat = [s for _, s in warm_runs]
    views = [c.planetlab_platform(8, alpha=1.0, seed=s) for s in range(8)]
    seeds = list(range(10, 18))
    timed(c.optimize_plan_batch, views, "e2e_multi", seeds=seeds, **opt)
    batch, batch_s = timed(c.optimize_plan_batch, views, "e2e_multi",
                           seeds=seeds, **opt)
    incumbents = [r.plan for r in timed(
        c.optimize_plan_batch, views, "e2e_multi", seeds=seeds, **opt)[0]]
    replans, best = {}, {}
    for incremental in (False, True):
        timed(c.replan_batch, views, incumbents, seeds=seeds,
              incremental=incremental, **ropt)
    for incremental in (False, True):
        walls = []
        for _ in range(repeats):
            res, s = timed(c.replan_batch, views, incumbents, seeds=seeds,
                           incremental=incremental, **ropt)
            walls.append(s)
        replans[incremental], best[incremental] = res, min(walls)
    uniform = c.makespan(p, c.uniform_plan(p))
    return {
        "cold_s": cold_s, "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "plans_per_s": len(views) / batch_s, "batch_s": batch_s,
        "full_s": best[False], "incremental_s": best[True],
        "stats": c.solver_cache_stats(),
        "single": [cold] + [r for r, _ in warm_runs], "uniform": uniform,
        "batch": batch, "views_uniform": [c.makespan(v, c.uniform_plan(v))
                                          for v in views],
        "incumbents": [r.makespan for r in batch], "replans": replans,
    }


def first_solve_main() -> None:
    """``python3 chip_smoke.py --first-solve``: in a fresh process, the
    first solve on the card split into its parts, each timed between two
    synchronizations; one JSON line of (part, seconds)."""
    t = time.perf_counter()
    import torch

    parts = [("import torch", time.perf_counter() - t)]
    sys.path.insert(0, str(SRC))
    t = time.perf_counter()
    from repro_torch.core import optimize_plan, planetlab_platform

    parts.append(("import repro_torch.core", time.perf_counter() - t))
    dev = torch.device("cuda", 0)

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        parts.append((name, time.perf_counter() - t))
        return out

    part("CUDA context (the first allocation)",
         lambda: torch.zeros(1, device=dev))
    part("first RNG draw (the Philox generator)",
         lambda: torch.rand(64, 64, device=dev))
    a = torch.ones(64, 64, device=dev)
    part("first cuBLAS handle (a 64 x 64 matmul)", lambda: a @ a)
    part("torch.func's first trace (vmap of grad of a logsumexp)",
         lambda: torch.func.vmap(torch.func.grad(
             lambda v: torch.logsumexp(v, 0)))(a))
    p = planetlab_platform(8, alpha=1.0, seed=3)
    for name, seed, steps in (("first solve", 0, PLANNER_OPT["steps"]),
                              ("second solve, the same key", 1,
                               PLANNER_OPT["steps"]),
                              ("a new key's first solve (one more step)", 2,
                               PLANNER_OPT["steps"] + 1)):
        part(f"{name} (optimize_plan e2e_multi {PLANNER_OPT['n_restarts']} x"
             f" {steps})", lambda: optimize_plan(
                 p, "e2e_multi", seed=seed, device=dev,
                 n_restarts=PLANNER_OPT["n_restarts"], steps=steps))
    print(json.dumps({"first_solve_parts": parts}), flush=True)


def first_solve_breakdown():
    """The process's first solve split into its parts (``--first-solve``)
    in a fresh process, with CUDA's default lazy module loading and with
    ``CUDA_MODULE_LOADING=EAGER`` (every kernel loaded with the context):
    printed, not checked."""
    import os

    for loading in ("LAZY", "EAGER"):
        env = dict(os.environ, CUDA_MODULE_LOADING=loading)
        t = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--first-solve"],
                env=env, capture_output=True, text=True,
                timeout=FIRST_SOLVE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"23b first solve, CUDA_MODULE_LOADING={loading}: no result "
                  f"in {FIRST_SOLVE_TIMEOUT_S} s")
            continue
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"first_solve_parts"')]
        if proc.returncode != 0 or not lines:
            print(f"23b first solve, CUDA_MODULE_LOADING={loading}: exit "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            continue
        parts = json.loads(lines[-1])["first_solve_parts"]
        print(f"23b the process's first solve, CUDA_MODULE_LOADING={loading} "
              f"(a process of its own, {time.perf_counter() - t:.1f} s):")
        for name, secs in parts:
            print(f"  {name}: {secs!r} s")


def phase_planner_service(device, opt=PLANNER_OPT, ropt=PLANNER_REPLAN_OPT,
                          stats=None, first_solve=False):
    """Phase 23b: the planner service (bench_planner) on the card: every
    plan never worse than uniform, no replan (full or incremental) worse
    than its incumbent, the solver counters the reference's for the
    same call sequence; the latencies and rates printed.  With
    ``first_solve`` (the phase alone), the process's first solve split
    into its parts in a fresh process."""
    from repro_torch.core.plan import validate_plan

    stats = REF_PLANNER_STATS if stats is None else stats
    print("== phase 23b: the planner service", flush=True)
    out = planner_service(control_pkg(device), opt, ropt)
    for r in out["single"]:
        check(r.makespan <= out["uniform"] * (1 + 1e-9),
              f"23b a single solve {r.makespan!r} s worse than uniform's "
              f"{out['uniform']!r} s")
        validate_plan(r.plan.x, r.plan.y)
    for r, u in zip(out["batch"], out["views_uniform"]):
        check(r.makespan <= u * (1 + 1e-9),
              f"23b a batched plan {r.makespan!r} s worse than uniform's {u!r}")
    for incremental, res in out["replans"].items():
        worse = sum(r.makespan > b + 1e-9
                    for r, b in zip(res, out["incumbents"]))
        check(worse == 0, f"23b {worse} of {len(res)} replans (incremental "
                          f"{incremental}) modeled worse than the incumbent")
    check(out["stats"] == stats,
          f"23b solver counters {out['stats']}, the reference's {stats}")
    print(f"23b {opt['n_restarts']} x {opt['steps']}: cold {out['cold_s']!r} "
          f"s; warm p50 {out['p50_ms']!r} ms, p99 {out['p99_ms']!r} ms "
          f"({PLANNER_WARM} solves); warm over cold "
          f"{out['cold_s'] / (out['p50_ms'] / 1e3)!r}x; B = 8 "
          f"optimize_plan_batch {out['batch_s']!r} s, {out['plans_per_s']!r}"
          f" plans/s")
    print(f"23b replan_batch B = 8 at {ropt['n_restarts']} x {ropt['steps']},"
          f" best of {PLANNER_REPEATS}: full {out['full_s']!r} s, incremental"
          f" {out['incremental_s']!r} s, speedup "
          f"{out['full_s'] / out['incremental_s']!r}x; solver counters "
          f"{out['stats']} (the reference's)")
    if first_solve:
        first_solve_breakdown()
    return out


def scale_online_setup(pkg, tier=SCALE_TIER, mix=SCALE_MIX, live=SCALE_LIVE):
    """online_1000 as paper_figures.py:934-958 builds it, on ``tier``'s
    substrate: (substrate, the live jobs, their configs, the arrivals)."""
    import numpy as np

    a, c = pkg.api, pkg.core
    sub0 = c.scale_tier_substrate(**tier)
    cluster_r = np.asarray(sub0.cluster_r)
    browned = np.flatnonzero(cluster_r == cluster_r[0])
    C_r = np.asarray(sub0.C_r)
    t_brown, share = SCALE_BROWNOUT
    sub = sub0.with_traces({
        f"reduce[r{k}]": c.CapacityTrace.step(float(C_r[k]),
                                             float(C_r[k]) * share, t_brown)
        for k in browned})
    entries = c.scale_job_mix(sub, **mix, base_cfg=c.SimConfig(mode="fluid"))
    order = np.argsort([cfg.start_time for _, _, cfg in entries])
    jobs, cfgs, arrivals = [], [], []
    for i in order[:live]:
        pv, pl, cfg = entries[int(i)]
        jobs.append(a.GeoJob(pv, **pkg.dev).with_plan(pl, cfg.barriers))
        cfgs.append(cfg)
    late = order[live:]
    for n, i in enumerate(late):
        pv, pl, cfg = entries[int(i)]
        arrivals.append(a.Arrival(
            a.GeoJob(pv, **pkg.dev).with_plan(pl, cfg.barriers),
            SCALE_ARRIVALS_S[0] if n < len(late) // 2 else SCALE_ARRIVALS_S[1],
            cfg=cfg))
    return sub, jobs, cfgs, arrivals


def scale_online(pkg, setup, opt=CONTROL_OPT, charge=SCALE_CHARGE_S,
                 seed=0, hysteresis=1.0):
    """online_1000's ``run_online`` (paper_figures.py:959-966), timed
    between two synchronizations: (report, wall)."""
    a = pkg.api
    sub, jobs, cfgs, arrivals = setup
    sched = a.GeoSchedule(jobs, **pkg.dev).with_plans()
    pkg.sync()
    t = time.perf_counter()
    report = sched.run_online(
        policy="reactive_shared", arrivals=arrivals, cfg=cfgs, seed=seed,
        online=a.OnlineConfig(shared=True, hysteresis=hysteresis,
                              incremental=True, solver_cost_s=charge), **opt)
    pkg.sync()
    return report, time.perf_counter() - t


def scale_numbers(report, wall, n_nodes):
    return {"n_nodes": n_nodes, "decisions": len(report.decisions),
            "swaps": len(report.swaps), "rejected": len(report.rejected),
            "makespan": report.makespan_online,
            "static_makespan": report.makespan_static,
            "online_margin": report.improvement, "wall_s": wall,
            "decisions_per_s": len(report.decisions) / wall if wall else 0.0}


def profile_anneal(solve, steps, sessions=3):
    """Busy share and device events a step of ``solve`` (one anneal of
    ``steps`` steps) on the card, from a profiler session that traces a
    warm-up call, dropped, before the one it keeps; a trace counts only
    where every kernel launch the host made in the kept call has its
    kernel on the device, else the session is made again, up to
    ``sessions``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                solve()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                prof.step()
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = sum(e.device_type == cuda
                      and not e.name.startswith(("Memcpy", "Memset"))
                      for e in events)
        launched = sum(e.device_type != cuda
                       and e.name.startswith(("cudaLaunch", "cuLaunch"))
                       for e in events)
        busy_us, n_events, _ = device_activity(prof)
        # the trace is whole where every launch the host made has its
        # kernel (it records one kernel more than the launches counted)
        if launched and kernels >= launched:
            print(f"23c one decision's anneal ({steps} steps) under the "
                  f"profiler: wall {wall!r} s, device busy "
                  f"{busy_us / 1e6!r} s, busy share {busy_us / 1e6 / wall!r},"
                  f" device events {n_events} ({n_events / steps!r} a step),"
                  f" kernels {kernels} of {launched} launched")
            return {"wall_s": wall, "busy_s": busy_us / 1e6,
                    "busy_share": busy_us / 1e6 / wall,
                    "events_per_step": n_events / steps}
        print(f"  profiler session {session} of {sessions} recorded {kernels}"
              f" kernels of {launched} launches: no device time from it")
    print("23c no complete trace of the anneal")
    return None


def scale_anneal_vs_cpu(device, recorded):
    """One decision's anneal, from the inputs the card's run gave it, on the
    card and on the CPU: held in float64 (x, y atol 1e-4, the exact
    objective rtol 1e-4); the float32 runs, as the path runs them, printed
    beside the CPU's float32 run against its float64 one (at these inputs
    float32 rounding alone moves x by more than 1e-4:
    tests/test_torch_control_plane.py)."""
    import torch
    from repro_torch.core import optimize as O

    args, kwargs = recorded
    cpu = torch.device("cpu")

    def solve(dev, dtype):
        moved = [tuple(t.to(dev, dtype) for t in arg)
                 if isinstance(arg, tuple) else arg.to(dev, dtype)
                 for arg in args]
        return [t.cpu() for t in O._solve_residual_shared_batch(*moved,
                                                                **kwargs)]

    def dist(a, b):
        return ((a[0] - b[0]).abs().max().item(),
                (a[1] - b[1]).abs().max().item(),
                ((a[2] - b[2]).abs() / b[2].abs()).max().item())

    card64, cpu64 = solve(device, torch.float64), solve(cpu, torch.float64)
    name = "_solve_residual_shared_batch"
    errs = (_held(f"23c {name} float64 x", card64[0], cpu64[0], 1e-4),
            _held(f"23c {name} float64 y", card64[1], cpu64[1], 1e-4),
            _held(f"23c {name} float64 exact", card64[2], cpu64[2], 0.0,
                  1e-4))
    print(f"23c {name}, logits {tuple(args[4].shape)}, {kwargs['steps']} "
          f"steps in float64, card against CPU: max |err| x {errs[0]!r}, y "
          f"{errs[1]!r}, exact {errs[2]!r} s (x, y atol 1e-4; exact rtol "
          "1e-4)")
    card32, cpu32 = solve(device, torch.float32), solve(cpu, torch.float32)
    print(f"unchecked: in float32, as the path runs it, max |err| x, y, exact"
          f" relative: card against CPU {dist(card32, cpu32)!r}; card against "
          f"the float64 CPU run {dist(card32, cpu64)!r}; CPU against it "
          f"{dist(cpu32, cpu64)!r}")
    return errs


def phase_scale_online(device, tier=SCALE_TIER, mix=SCALE_MIX,
                       live=SCALE_LIVE, opt=CONTROL_OPT, ref=None,
                       spread=None):
    """Phase 23c: online_1000 on the card: decisions and swaps the
    reference's (or within its spread), the makespan within its bar, a
    positive online margin, every plan valid and no adopted stack modeled
    worse; one decision's anneal held card against CPU and profiled."""
    import numpy as np
    import torch
    from repro_torch.core import optimize as O

    ref = REF_SCALE if ref is None else ref
    spread = REF_SCALE_SPREAD if spread is None else spread
    print("== phase 23c: online_1000, the 1000-node tier online", flush=True)
    pkg = control_pkg(device)
    t = time.perf_counter()
    setup = scale_online_setup(pkg, tier, mix, live)
    sub = setup[0]
    n_nodes = sub.nS + sub.nM + sub.nR
    print(f"23c substrate {sub.nS} edges, {sub.nM} mappers, {sub.nR} reducers"
          f" ({n_nodes} nodes), {len(setup[1])} live jobs and "
          f"{len(setup[3])} arrivals built in {time.perf_counter() - t:.1f} s")
    real = O._solve_residual_shared_batch
    anneals, held = [], []

    def recording(*args, **kwargs):
        anneals.append((tuple(args[4].shape), kwargs["steps"],
                        kwargs["kappa"], args[4].device.type))
        if not held and args[4].shape[1] == O._INCREMENTAL_STACK_CAP:
            held.append(([tuple(a.detach().cpu() for a in arg)
                          if isinstance(arg, tuple) else arg.detach().cpu()
                          for arg in args], dict(kwargs)))
        return real(*args, **kwargs)

    if device.type == "cuda":
        # the allocator's counters exist once CUDA is set up in the process
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    O._solve_residual_shared_batch = recording
    try:
        report, wall = scale_online(pkg, setup, opt)
    finally:
        O._solve_residual_shared_batch = real
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else float("nan"))
    got = scale_numbers(report, wall, n_nodes)
    check_online_run("23c online_1000", report, True)
    check(all(dev == device.type for *_, dev in anneals),
          f"23c an anneal ran off {device}: {anneals}")
    n_eff, steps_eff = O._shared_incremental_budget(
        opt["n_restarts"], opt["steps"], live)
    check(anneals and all(a[:2] == ((n_eff, O._INCREMENTAL_STACK_CAP,
                                     sub.nS, sub.nM), steps_eff)
                          for a in anneals),
          f"23c anneals {anneals}, not {n_eff} restarts x "
          f"{O._INCREMENTAL_STACK_CAP} jobs x {steps_eff} steps")
    print(f"23c {len(anneals)} co-replans, each {n_eff} restarts x "
          f"{O._INCREMENTAL_STACK_CAP} jobs (the stack cap) x {steps_eff} "
          f"steps, logits {anneals[0][0]} float32 "
          f"({np.prod(anneals[0][0]) * 4 / 1e6:.1f} MB), kappa "
          f"{[a[2] for a in anneals]}")
    lo, hi = spread.get("decisions", (ref["decisions"], ref["decisions"]))
    check(lo <= got["decisions"] <= hi,
          f"23c {got['decisions']} decisions, the reference's "
          f"{ref['decisions']} (its spread {lo}-{hi})")
    lo, hi = spread.get("swaps", (ref["swaps"], ref["swaps"]))
    check(lo <= got["swaps"] <= hi,
          f"23c {got['swaps']} swaps, the reference's {ref['swaps']} (its "
          f"spread {lo}-{hi})")
    hold_control("23c makespan", got["makespan"], ref["makespan"],
                 control_bar("makespan", spread))
    hold_control("23c static makespan", got["static_makespan"],
                 ref["static_makespan"], CONTROL_RTOL)
    check(got["online_margin"] > 0,
          f"23c online_margin {got['online_margin']!r}")
    print(f"23c online_1000: wall {wall!r} s (the reference's CI budget "
          f"{SCALE_BUDGET_S} s, its recorded run {REF_SCALE_RECORD['wall_s']!r}"
          f" s), decisions {got['decisions']} (the reference's "
          f"{ref['decisions']}), swaps {got['swaps']} ({ref['swaps']}), "
          f"rejected {got['rejected']} ({ref['rejected']}), decisions_per_s "
          f"{got['decisions_per_s']!r} (its record "
          f"{REF_SCALE_RECORD['decisions_per_s']!r}), makespan "
          f"{got['makespan']!r} s, static {got['static_makespan']!r} s, "
          f"online_margin {got['online_margin']!r} (the reference's "
          f"{ref['online_margin']!r}); peak device memory {peak!r} GB")
    check(bool(held), "23c no anneal at the stack cap to hold")
    errs = scale_anneal_vs_cpu(device, held[0])
    prof = None
    if device.type == "cuda":
        args, kwargs = held[0]
        moved = [tuple(a.to(device) for a in arg) if isinstance(arg, tuple)
                 else arg.to(device) for arg in args]
        prof = profile_anneal(lambda: real(*moved, **kwargs), kwargs["steps"])
    return dict(got, peak_gb=peak, anneals=len(anneals), held_errs=errs,
                profile=prof)


#: phase 23's parts; in the whole script each runs in a process of its
#: own, the three at once (``run_control_parts``): their host work (the
#: solver's launches, the DES and the fluid executor) overlaps, and the
#: card is idle most of the time in each
CONTROL_PARTS = ("23a", "23b", "23c")
CONTROL_TIMEOUT_S = 900


def control_part(name):
    """The function of a phase-23 part."""
    return {"23a": phase_control_failover_shared,
            "23b": phase_planner_service,
            "23c": phase_scale_online}[name]


def control_summary(name, out):
    """What a part's result reports, as JSON takes it."""
    if name == "23a":
        return {"cells": out["cells"], "walls": out["walls"],
                "margins": {" ".join(k): v for k, v in out["margins"].items()},
                "fig12": {str(r): v for r, v in out["fig12"].items()}}
    if name == "23b":
        return {k: out[k] for k in ("cold_s", "p50_ms", "p99_ms", "batch_s",
                                    "plans_per_s", "full_s", "incremental_s",
                                    "stats")}
    return out


def control_part_main(name, device_name="cuda", kwargs="{}") -> None:
    """``python3 chip_smoke.py --control-part <23a|23b|23c> [cuda|cpu]
    [JSON keyword arguments]``: one part of phase 23 in a process of its
    own, every kernel's launches counted from 0; its seconds, launches and
    result as one JSON line, last.  On the CPU it takes one torch thread
    (the three parts run at once)."""
    import torch

    sys.path.insert(0, str(SRC))
    import repro_torch

    device = (torch.device("cuda", 0) if device_name == "cuda"
              else torch.device(device_name))
    if device.type == "cpu":
        torch.set_num_threads(1)
    repro_torch.set_default_device(device)
    kw = json.loads(kwargs)
    if "fig12" in kw:
        kw["fig12"] = {int(r): v for r, v in kw["fig12"].items()}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    out = control_part(name)(device, **kw)
    s = time.perf_counter() - t
    print(json.dumps({"control_part": name, "s": s,
                      "launches": {k: w.launches for k, w in wrappers.items()},
                      "out": control_summary(name, out)}, default=float),
          flush=True)


def start_control_parts(device, kwargs=None):
    """Start phase 23's parts at once, each in a process of its own on
    ``device`` (``control_part_main``, with ``kwargs[name]``); they are
    stopped when this process exits.  Returns what
    ``finish_control_parts`` takes."""
    import atexit
    import os
    import tempfile

    kwargs = kwargs or {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_control_")
    procs = {}
    for name in CONTROL_PARTS:
        with open(os.path.join(workdir, f"{name}.log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--control-part", name, device.type,
                 json.dumps(kwargs.get(name, {}))],
                stdout=log, stderr=subprocess.STDOUT)

    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    return workdir, procs, stop, time.perf_counter()


def finish_control_parts(started, timeout=CONTROL_TIMEOUT_S):
    """Wait for the parts ``start_control_parts`` started, up to
    ``timeout`` from their start, stop any left, and print each one's
    output in turn.  Fails if one did not end with its result.  Returns
    the results by part and the seconds waited here."""
    import os
    import shutil

    workdir, procs, stop, t_start = started
    t = time.perf_counter()
    for p in procs.values():
        try:
            p.wait(timeout=max(t_start + timeout - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            pass
    stop()
    waited = time.perf_counter() - t
    results = {}
    for name, p in procs.items():
        text = open(os.path.join(workdir, f"{name}.log")).read()
        print(text, end="" if text.endswith("\n") else "\n", flush=True)
        lines = [ln for ln in text.splitlines()
                 if ln.startswith('{"control_part"')]
        check(p.returncode == 0 and bool(lines),
              f"phase {name}, in a process of its own: exit {p.returncode}"
              f" (its output above)")
        results[name] = json.loads(lines[-1])
    shutil.rmtree(workdir, ignore_errors=True)
    return results, waited


def phase_control_plane(device, a=None, b=None, c=None, first_solve=False,
                        started=None):
    """Phase 23: 23a, 23b and 23c (each sub-phase's keyword arguments in
    ``a``, ``b``, ``c``) in turn in this process, or, where ``started``,
    the parts ``start_control_parts`` started (at once, each in a process
    of its own), waited for here; every kernel's launches counted from 0:
    none may launch (nothing here executes a reduce or serves a model)."""
    t0 = time.perf_counter()
    out, secs, launches = {}, {}, {}
    if started is not None:
        results, waited = finish_control_parts(started)
        for name, r in results.items():
            out[name], secs[name] = r["out"], r["s"]
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        t0 = started[3]
        print("phase 23's parts at once, each in a process of its own: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
              + f"; waited {waited:.1f} s for them here; "
              f"{time.perf_counter() - _T0:.1f} s into the run", flush=True)
    else:
        kwargs = {"23a": a or {},
                  "23b": dict(b or {}, first_solve=first_solve),
                  "23c": c or {}}
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        for name in CONTROL_PARTS:
            t = time.perf_counter()
            out[name] = control_part(name)(device, **kwargs[name])
            secs[name] = time.perf_counter() - t
            print(f"phase {name}: {secs[name]:.1f} s; "
                  f"{time.perf_counter() - _T0:.1f} s into the run",
                  flush=True)
        launches = {name: w.launches for name, w in wrappers.items()}
    check(not any(launches.values()),
          f"phase 23 launched kernels: {launches}")
    s = time.perf_counter() - t0
    card = f" on {card_name_and_limit()}" if device.type == "cuda" else ""
    print(f"phase 23: {s:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items())
        + f"{'' if started is None else ', at once'}); kernel launches "
        f"{launches}{card}", flush=True)
    return dict(out, launches=launches, s=s, secs=secs)


#: the reference's numbers phase 23 holds, from its CPU run at
#: ``CONTROL_OPT`` (``print_tables`` of tests/test_torch_control_plane.py,
#: which also holds them to a fresh reference run): Fig 12's makespans;
#: 23a's frozen and pinned online and static makespans; each pinned run's
#: (decisions, swaps, rejections); the spread of each makespan over
#: ``CONTROL_SPREAD_SEEDS`` and ``CONTROL_SPREAD_NUDGES`` where it is more
#: than ``CONTROL_RTOL``
REF_FIG12 = {1: 508.3860265318138, 2: 1252.5992402530353,
             3: 1545.961223541104}
REF_CONTROL = {
    'failover frozen': 419.0402019684004,
    'online_shared frozen': 540.0272386021852,
    'failover reactive_shared': 205.04193736984178,
    'failover reactive_shared static': 419.0402019684004,
    'failover reactive_failover': 205.04193736984178,
    'failover reactive_failover static': 419.0402019684004,
    'online_shared reactive_solo': 462.746484123336,
    'online_shared reactive_solo static': 439.26560983625933,
    'online_shared reactive_shared': 422.54333846802155,
    'online_shared reactive_shared static': 439.26560983625933,
    'online_shared shared_no_hysteresis': 422.54377772367735,
    'online_shared shared_no_hysteresis static': 439.26560983625933,
}
REF_CONTROL_COUNTS = {
    'failover': {'reactive_shared': (2, 1, 1), 'reactive_failover': (2, 1, 1)},
    'online_shared': {'reactive_solo': (8, 5, 0),
                      'reactive_shared': (9, 4, 2),
                      'shared_no_hysteresis': (9, 6, 0)},
}
REF_CONTROL_SPREAD = {
    'failover frozen': 0.027487850653739043,
    'failover reactive_shared': 0.024217292042393535,
    'failover reactive_shared static': 0.027487850653739043,
    'failover reactive_failover': 0.024217292042393535,
    'failover reactive_failover static': 0.027487850653739043,
    'online_shared reactive_solo': 0.0013147857233983817,
    'online_shared reactive_shared': 0.02375967239426835,
    'online_shared shared_no_hysteresis': 0.0237606872455286,
}
#: bench_planner's solver counters for phase 23b's call sequence
REF_PLANNER_STATS = {'calls': 20, 'hits': 16, 'misses': 4, 'compiles': 4,
                     'entries': 4, 'shapes': 4}
#: online_1000 at run_online's seed 0, and over seeds 0-2 the range of its
#: decisions and swaps and the largest relative move of its makespan
REF_SCALE = {
    'n_nodes': 996,
    'decisions': 261,
    'swaps': 48,
    'rejected': 0,
    'makespan': 7354.0453869752755,
    'static_makespan': 13207.19648060636,
    'online_margin': 0.4431789215997458,
}
REF_SCALE_SPREAD = {
    'decisions': (260, 261),
    'swaps': (48, 48),
    'makespan': 0.025436233471816894,
}
#: the reference's recorded online_1000 (benchmarks/baseline.json: jax
#: 0.4.37, ``--quick``, on a CPU host), printed beside the card's
REF_SCALE_RECORD = {"wall_s": 44.78866241000287,
                    "decisions_per_s": 5.827367596084084}

def free_device_memory(device) -> None:
    """Return what the finished phases held to the card; print the run's
    wall so far."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"device memory allocated after freeing: "
              f"{torch.cuda.memory_allocated(device) / 1e9!r} GB, reserved "
              f"{torch.cuda.memory_reserved(device) / 1e9!r} GB; "
              f"{time.perf_counter() - _T0:.1f} s into the run")


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
    reducer_inputs, launches, wc_row = phase_main_path(device)
    entries = [phase_segment_sum(device, reducer_inputs, launches)]
    phase_batched_solver(device)
    free_device_memory(device)
    paper = phase_paper_figures(device, wc_row)
    free_device_memory(device)
    # phase 20 serves each arch in float32 through the launcher on its own
    # seeded weights, whose bf16 cast (equal to bf16_weights') then serves
    # phase 5, 7 or 9 and the arch's long shapes (phase 19) before it is
    # freed; 20a's full-depth hold takes the place of phase 6b's cut
    f32 = {"20a": phase_float32_serving(device, *FLOAT32_ARCHS[0],
                                        hand_on=True)}
    weights = f32["20a"].pop("bf16")
    served = phase_serving(device, params=weights)
    long = {"19a": phase_long_context(device, *LONG_ARCHS[0], params=weights)}
    del weights
    free_device_memory(device)
    entries += phase_lm_kernels(device, served)
    free_device_memory(device)
    f32["20b"] = phase_float32_serving(device, *FLOAT32_ARCHS[1], hand_on=True)
    weights = f32["20b"].pop("bf16")
    served = phase_serving(device, MAMBA_ARCH, fixed=MAMBA_PROMPTS, phase="7",
                           params=weights)
    long["19b"] = phase_long_context(device, *LONG_ARCHS[1], params=weights)
    del weights
    free_device_memory(device)
    entries.append(phase_mamba_kernel(device, served))
    phase_model_kernels_vs_plain(device, MAMBA_ARCH, depth=4, phase="8b")
    free_device_memory(device)
    f32["20c"] = phase_float32_serving(device, *FLOAT32_ARCHS[2], hand_on=True)
    weights = f32["20c"].pop("bf16")
    granite = phase_serving(device, GRANITE_ARCH, fixed=GRANITE_PROMPTS,
                            phase="9", params=weights)
    long["19c"] = phase_long_context(device, *LONG_ARCHS[2], params=weights)
    del weights
    free_device_memory(device)
    moe, flash_granite = phase_moe_kernel(device, granite)
    entries.append(moe)
    phase_moe_model(device)
    free_device_memory(device)
    f32["20d"] = phase_float32_serving(device, *FLOAT32_ARCHS[3])
    phase_training(device, profile=False)  # PERF.md holds its profile
    free_device_memory(device)
    phase_training_float32_cut(device)
    phase_checkpoint_resume(device)
    phase_grad_guard(device)
    free_device_memory(device)
    phase_train_archs(device)
    jobs, joint, schedule_launches = phase_schedule(device)
    online = phase_online(device, jobs, joint)
    phase_card_vs_cpu(device, jobs, joint, *online)
    free_device_memory(device)
    t13 = time.perf_counter()
    alphas, out_scales, recorded, pipeline_launches = phase_pipeline(device)
    phase_pipeline_schedule(device, jobs, alphas, out_scales)
    phase_pipeline_card_vs_cpu(device, recorded)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    free_device_memory(device)
    moe["launches_by_path"] = {GRANITE_ARCH: moe["launches"],
                               "expert parallel (14b)": 0}
    # phase 23's parts run at once, each in a process of its own, beside
    # phases 14 to 16 (solves, host tracing, one-rank meshes and two ranks
    # on one card, whose walls say nothing of a multi-card step): their
    # host work overlaps, and each uses a few GB of the card.  Not before
    # phase 21: run after phase 22, phase 23 left 32 MiB more allocated on
    # the card, and phase 21b's AdamW step, whose peak is 10 GB under the
    # card's size, ran out of memory (8.85 GiB reserved but unallocated)
    control_parts = start_control_parts(device)
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
    free_device_memory(device)
    control = phase_control_plane(device, started=control_parts)
    free_device_memory(device)
    example_launches, example_err = phase_examples(device)
    free_device_memory(device)
    widths = phase_flash_widths(device)
    card = phase_card_archs(device)
    moe["launches_by_path"]["expert parallel (14b)"] = ep_launches["moe_dispatch"]
    moe["launches"] += ep_launches["moe_dispatch"]
    segsum = entries[0]
    segsum["launches_by_path"] = {"GeoJob": segsum["launches"],
                                  "GeoSchedule": schedule_launches,
                                  "GeoPipeline": pipeline_launches,
                                  # its word count row is GeoJob's run
                                  "paper's evaluation (22)": paper["launches"]}
    segsum["launches"] += (schedule_launches + pipeline_launches
                           + paper["launches"])
    flash = next(e for e in entries if e["name"] == "flash_attention")
    flash["launches_by_path"] = {SERVE_ARCH: flash["launches"],
                                 GRANITE_ARCH: granite["flash_attention"]}
    flash["launches"] += granite["flash_attention"]
    flash["launches_by_path"]["expert parallel (14b)"] = \
        ep_launches["flash_attention"]
    flash["launches"] += ep_launches["flash_attention"]
    flash["launches_by_path"]["examples (17e)"] = example_launches
    flash["launches"] += example_launches
    flash["max_abs_err"] = max(flash["max_abs_err"], flash_granite["max_abs_err"],
                               example_err)
    flash["granite_prefill"] = flash_granite
    flash["bf16_widths_max_abs_err"] = widths
    flash["max_abs_err"] = max(flash["max_abs_err"], *widths.values())
    flash["tensor_core_build"] = flash_build
    for e in entries:
        if e["name"] in tp_launches:
            e.setdefault("launches_by_path", {"serving": e["launches"]})
            e["launches_by_path"]["tensor parallel (16b)"] = \
                tp_launches[e["name"]]
            e["launches"] += tp_launches[e["name"]]
    # phase 18: each arch's serving launches, and the kernels at its shapes
    flash["card_archs"] = {}
    for arch, r in card.items():
        for e in (flash, moe):
            n = r["launches"][e["name"]]
            if n:
                e["launches_by_path"][f"{arch} (18)"] = n
                e["launches"] += n
        if "flash" in r:
            flash["max_abs_err"] = max(flash["max_abs_err"], r["flash_err"])
            flash["card_archs"].update(r["flash"])
        if "moe" in r:
            moe["max_abs_err"] = max(moe["max_abs_err"], r["moe"]["max_abs_err"])
            moe[f"{arch}_prefill"] = {k: v for k, v in r["moe"].items()
                                      if k not in ("name", "route", "source",
                                                   "replaces", "ptxas")}
    # phase 19: the long shapes' serving and long_500k launches, and the
    # kernels at their 32k shapes
    by_name = {e["name"]: e for e in entries}
    for phase, r in long.items():
        for name, n in r["launches"].items():
            if n and name in by_name:
                e = by_name[name]
                e.setdefault("launches_by_path", {"serving": e["launches"]})
                e["launches_by_path"][f"{r['arch']} long shapes ({phase})"] = n
                e["launches"] += n
        for name, numbers in r["kernels"].items():
            e = by_name[name]
            e.setdefault("long_32k", {})[r["arch"]] = numbers
            e["max_abs_err"] = max(e["max_abs_err"], numbers["max_abs_err"])
    print(f"phase 19: {sum(r['s'] for r in long.values()):.1f} s ("
          + ", ".join(f"{p} {r['s']:.1f} s" for p, r in long.items())
          + f") on {card_name_and_limit()}", flush=True)
    # phase 20: the launcher's float32 serving launches of each arch
    for phase, r in f32.items():
        for name, n in r["launches"].items():
            if n:
                e = by_name[name]
                e.setdefault("launches_by_path", {"serving": e["launches"]})
                e["launches_by_path"][f"{r['arch']} float32 (20)"] = n
                e["launches"] += n
                e.setdefault("float32_in_place_ms", {})[r["arch"]] = \
                    r["numbers"].get("in_place_ms", {}).get(name)
    print(f"phase 20: {sum(r['s'] for r in f32.values()):.1f} s ("
          + ", ".join(f"{p} {r['s']:.1f} s" for p, r in f32.items())
          + f") on {card_name_and_limit()}", flush=True)
    # phase 23: the control plane launches no kernel (checked there)
    for e in entries:
        e.setdefault("launches_by_path", {"serving": e["launches"]})
        e["launches_by_path"]["control plane (23)"] = \
            control["launches"][e["name"]]
    print(f"phase 23: {control['s']:.1f} s (" + ", ".join(
        f"{p} {s:.1f} s" for p, s in control["secs"].items())
        + f") on {card_name_and_limit()}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":
        tp_rank_main(int(sys.argv[2]), sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--rglru-profile":
        rglru_profile_main(sys.argv[2])
    elif len(sys.argv) == 2 and sys.argv[1] == "--first-solve":
        first_solve_main()
    elif 3 <= len(sys.argv) <= 5 and sys.argv[1] == "--control-part":
        control_part_main(*sys.argv[2:])
    else:
        main()
