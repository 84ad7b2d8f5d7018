"""IBM Granite MoE 3B-A800M — 32 experts top-8 family.

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155, MoE 40
experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 experts are padded to 48 (= 3 per TP-16 shard) with -inf router mass —
padding is exact; the wasted FLOPs surface in the roofline's
MODEL_FLOPS/HLO_FLOPS ratio.  MoE dispatch is geo-plannable.
"""
from repro_torch.models.config import ArchConfig, Block

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    pattern=(Block(mixer="attn", ffn="moe"),),
    n_experts=40,
    top_k=8,
    expert_d_ff=512,
    capacity_factor=1.25,
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    geo_plannable=True,
)
