"""End-to-end training driver through the PyTorch port (``repro_torch``; no
jax): train a ~20M-param Qwen3-family model for a few hundred steps with
geo-planned ingest, async checkpointing and resume-after-kill.

    PYTHONPATH=src python examples/port_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/port_train_lm.py --device cpu

This is a thin veneer over ``repro_torch.launch.train`` (the production
launcher); it also demonstrates the kill/resume cycle by checkpointing
every 50 steps — re-running the same command continues from the newest
committed checkpoint.  Runs on ``--device`` (default ``cuda``); the
checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_train_lm`` in the
temporary directory).
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launcher

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--ckpt-dir",
                default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

state = train_launcher.main([
    "--arch", "qwen3-1.7b",
    "--reduced",
    "--steps", str(args.steps),
    "--batch", "8",
    "--seq", "128",
    "--lr", "1e-3",
    "--ckpt-dir", args.ckpt_dir,
    "--ckpt-every", "50",
    "--resume", "auto",
    "--geo-ingest",
    "--log-every", "10",
    "--device", args.device,
])
