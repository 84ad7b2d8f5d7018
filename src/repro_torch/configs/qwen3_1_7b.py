"""Qwen3-1.7B — qk-norm + GQA dense transformer.

28L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=6144 vocab=151936.
[hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="rmsnorm",
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
