"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 ratio (Griffin).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, 2048-token local
attention window.  [arXiv:2402.19427; unverified]

Layout: (rglru, rglru, local-attn) × 12 groups + (rglru, rglru) tail = 38
layers.  Sub-quadratic (bounded attention window + linear recurrence) —
runs the ``long_500k`` shape.
"""
from repro_torch.models.config import ArchConfig, Block

_RG = Block(mixer="rglru", ffn="dense")
_LA = Block(mixer="attn", ffn="dense", rope=True, window=2048)

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    pattern=(_RG, _RG, _LA),
    tail=(_RG, _RG),
    rglru_expand=1,
    norm="rmsnorm",
    act="gelu",
    rope_theta=10_000.0,
    subquadratic=True,
)
