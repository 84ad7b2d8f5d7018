"""Serving launcher: the port's continuous-batching engine over a (reduced
or full) arch config with random weights from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --reduced --device cpu --requests 8 --slots 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --dtype bfloat16                       # full width, on the card

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the process default, cuda)")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend == "embed":
        raise SystemExit(f"{cfg.name} is a stub-frontend arch; serve a "
                         "token-in arch (e.g. qwen3-1.7b)")
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = M.init(cfg, gen, device=device, dtype=dtype)
    eng = ServeEngine(cfg, params,
                      ServeConfig(slots=args.slots, max_len=args.max_len,
                                  compute_dtype=dtype, seed=args.seed),
                      device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        n = int(rng.integers(4, 24))
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {cfg.name} on {device}: {len(done)} requests, {toks} "
          f"tokens, {toks/dt:.1f} tok/s, {eng.step_count} decode steps")
    for r in done[:3]:
        print(f"  rid={r.rid} ttft_steps={r.ttft_steps} out={r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
