"""Llama-4-Scout-17B-16E (MoE, early fusion) — backbone config.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

iRoPE layout: groups of four layers — three local-RoPE attention layers
(8192-token chunked window) followed by one global NoPE layer.  Every layer
carries a top-1 16-expert MoE FFN (the released model interleaves a shared
expert; we model the routed experts, noted in DESIGN.md).  The MoE dispatch
is the paper-technique integration point (``geo_plannable``).
"""
from repro_torch.models.config import ArchConfig, Block

_LOCAL = Block(mixer="attn", ffn="moe", rope=True, window=8192)
_GLOBAL = Block(mixer="attn", ffn="moe", rope=False, window=None)

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    n_experts=16,
    top_k=1,
    expert_d_ff=8192,
    norm="rmsnorm",
    act="silu",
    rope_theta=500_000.0,
    geo_plannable=True,
)
