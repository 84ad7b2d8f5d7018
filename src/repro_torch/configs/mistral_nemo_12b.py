"""Mistral-Nemo-Base-2407 (12B) — 128k-context dense transformer.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)
