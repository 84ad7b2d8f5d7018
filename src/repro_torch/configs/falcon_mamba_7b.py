"""Falcon-Mamba-7B — pure Mamba-1 SSM (attention-free).

64L d_model=4096 (attn-free, d_ff=0), ssm_state=16, vocab=65024.
[arXiv:2410.05355; unverified]

Sub-quadratic by construction — runs the ``long_500k`` shape with O(1)
per-token state.
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    pattern=(Block(mixer="ssm", ffn="none"),),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    norm="rmsnorm",
    act="silu",
    subquadratic=True,
)
