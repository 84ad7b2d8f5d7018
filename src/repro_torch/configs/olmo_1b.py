"""OLMo-1B — non-parametric LayerNorm dense transformer.

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
[arXiv:2402.00838; hf]
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="nonparam_ln",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
