"""Training launcher: geo-planned data ingest, fault-tolerant checkpointing,
restart from the newest committed step — the reference launcher on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --device cpu --steps 200 --batch 8 --seq 128 \
        --ckpt-dir /tmp/ckpt --resume auto
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 8 --batch 4 --seq 2048 --dtype bfloat16 --remat  # the card

Runs on the card unless ``--device cpu`` is given.  Parameters are
float32 masters from a seeded generator, and ``--dtype`` is the compute
dtype.

* **--resume auto** restores the newest *committed* checkpoint (a crashed
  save can never be restored), and the data pipeline fast-forwards to the
  restored step: the same batches as a run that never stopped.
* checkpoints are written asynchronously off the training loop, with
  retention + milestones, on the reference's layout: a checkpoint of
  either package restores into the other.
* **--compression int8|bf16** enables error-feedback gradient compression.
* **--geo-ingest** plans the corpus push with the paper's optimizer (on
  the device) and logs the modeled ingest time vs a myopic plan.
* **--mesh** raises: multi-GPU training is not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import default_device, resolve_device, set_default_device
from repro_torch.configs import get_config
from repro_torch.core.platform import tpu_pod_platform
from repro_torch.data.pipeline import GeoDataPipeline
from repro_torch.models import model as M
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import AdamWConfig, cosine_schedule
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_device(batch_np, device):
    """The step's batch on ``device``, copied from pinned memory without
    waiting for the card."""
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def main(argv=None, wrap_step=None):
    """Train as ``argv`` says; returns the final ``TrainState``.
    ``wrap_step``, if given, is handed the step function and returns the
    one the loop calls (a caller's timing or profiling of each step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--mesh", default=None,
                    help="DxM: not ported (multi-GPU training); raises")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--geo-ingest", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the process default, cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-GPU training is not ported (ROADMAP.md "
            "queue 1, the multi-GPU item); train on one device")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        remat=args.remat,
        compute_dtype=DTYPES[args.dtype],
        compression=args.compression,
    )
    lr_fn = cosine_schedule(args.lr, args.warmup, args.steps)

    # the data pipeline plans on the process default device
    previous = default_device()
    set_default_device(device)
    try:
        # --- geo-planned ingest ---------------------------------------------
        platform = tpu_pod_platform(n_pods=2, hosts_per_pod=4,
                                    compute_jitter=0.3, seed=args.seed)
        pipe = GeoDataPipeline(
            platform, vocab=cfg.vocab, batch=args.batch, seq=args.seq,
            seed=args.seed, d_model=cfg.d_model,
            embeds=cfg.frontend == "embed",
            mode="e2e_push" if args.geo_ingest else "uniform",
        )
        if args.geo_ingest:
            from repro_torch.core.optimize import optimize_plan

            myopic = optimize_plan(platform, "myopic_push", n_restarts=6,
                                   steps=200)
            print(f"[ingest] planned={pipe.modeled_ingest_time():.2f}s "
                  f"myopic-push={myopic.breakdown['push']:.2f}s")

        # --- init / restore ---------------------------------------------------
        mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
        start_step = 0
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        state = init_state(cfg, M.init(cfg, gen, device=device),
                           seed=args.seed, compression=args.compression)
        if mgr and args.resume == "auto" and mgr.latest_step() is not None:
            state, _, start_step = mgr.restore(None, state)
            print(f"[resume] restored committed step {start_step}")

        step_fn = make_train_step(cfg, tcfg, lr_fn=lr_fn)
        if wrap_step is not None:
            step_fn = wrap_step(step_fn)
        pipe.start(from_step=start_step)
        t_last = time.time()
        try:
            for s in range(start_step, args.steps):
                _, batch_np = next(pipe)
                state, metrics = step_fn(state, _to_device(batch_np, device))
                if (s + 1) % args.log_every == 0 or s + 1 == args.steps:
                    loss = float(metrics["loss"])  # waits for the step
                    dt = time.time() - t_last
                    t_last = time.time()
                    tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
                    print(
                        f"step {s+1:5d} loss={loss:.4f} "
                        f"gnorm={float(metrics['grad_norm']):.2f} "
                        f"lr={float(metrics['lr']):.2e} tok/s={tok_s:.0f}",
                        flush=True,
                    )
                if mgr and (s + 1) % args.ckpt_every == 0:
                    mgr.save_async(s + 1, state, extras={"arch": cfg.name})
            if mgr:
                mgr.save(args.steps, state, extras={"arch": cfg.name},
                         milestone=True)
        finally:
            pipe.stop()
            if mgr:
                mgr.wait()
    finally:
        set_default_device(previous)
    print("[train] done")
    return state


if __name__ == "__main__":
    main()
