"""Serve a small model with batched requests through the PyTorch port's
continuous-batching engine (``repro_torch``; no jax).

    PYTHONPATH=src python examples/port_serve_lm.py
    PYTHONPATH=src python examples/port_serve_lm.py --device cpu

Runs on ``--device`` (default ``cuda``); on the card every prefill's
attention is the hand-written ``flash_attention`` kernel.
"""
import argparse

from repro_torch.launch import serve as serve_launcher

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

done = serve_launcher.main([
    "--arch", "qwen3-1.7b",
    "--reduced",
    "--requests", "12",
    "--slots", "4",
    "--max-len", "128",
    "--max-new", "16",
    "--device", args.device,
])
