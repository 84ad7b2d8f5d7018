"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
[arXiv:2306.05284; hf]

The EnCodec audio frontend is a STUB per the brief: ``input_specs()`` feeds
precomputed frame embeddings (the sum of the four codebook embeddings);
this config covers the transformer backbone, with a 2048-way codec-token
output head.
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="layernorm",
    act="gelu",
    rope_theta=10_000.0,
    frontend="embed",
)
