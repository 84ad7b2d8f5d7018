"""Phi-3-Vision 4.2B — phi3-mini text backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (MHA, kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision tower is a STUB per the brief: ``input_specs()`` feeds
precomputed patch embeddings (B, T, d_model); this config covers the
transformer backbone only.
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    frontend="embed",
)
