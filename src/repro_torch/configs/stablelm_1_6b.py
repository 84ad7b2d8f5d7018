"""StableLM-2-1.6B — parametric-LayerNorm dense transformer.

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]

(The released model applies rotary to 25% of head dims; we apply full
rotary — noted in DESIGN.md §Arch-applicability.)
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    pattern=(Block(mixer="attn", ffn="dense"),),
    norm="layernorm",
    act="silu",
    rope_theta=10_000.0,
)
