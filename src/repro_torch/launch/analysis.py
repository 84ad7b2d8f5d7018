"""Analytic FLOP accounting for the pieces HLO cost analysis cannot see.

The dry-run's analysis build unrolls the layer-group scan, so per-layer
matmuls/collectives are counted exactly — but the chunked-attention inner
scans (and the decode path's cache attention) stay rolled, and XLA counts
while bodies once.  Attention score/value contractions are plain matmuls
with exactly known shapes, so we add them analytically:

    fwd attention FLOPs / layer = 4 · B · Σ_t S_eff(t) · H · Dh

with ``S_eff(t)`` the causal (and windowed) visible context, and a 4×
multiplier for training (fwd + 2× bwd + 1× remat re-forward).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ArchConfig

__all__ = ["attention_flops", "visible_context_sum"]


def visible_context_sum(T: int, q_offset: int, window: Optional[int]) -> float:
    """Σ over queries at absolute positions q_offset..q_offset+T-1 of the
    number of visible keys under causal (+ optional window) masking."""
    total = 0.0
    # closed forms per regime to stay O(1)
    lo, hi = q_offset, q_offset + T - 1
    if window is None:
        # Σ (t+1) for t in [lo, hi]
        return (hi + 1 + lo + 1) * T / 2.0
    w = window
    # below the window fill-up point, t+1 keys; after, exactly w
    fill_end = min(hi, w - 1)
    if lo <= fill_end:
        n = fill_end - lo + 1
        total += (fill_end + 1 + lo + 1) * n / 2.0
    rest = hi - max(lo, w - 1 + 1) + 1
    if rest > 0:
        total += rest * w
    return total


def attention_flops(cfg: ArchConfig, kind: str, B: int, T: int,
                    cache_len: int = 0) -> float:
    """Total attention matmul FLOPs for one step across all devices."""
    H, Dh = cfg.n_heads, cfg.head_dim_
    blocks = [(b, cfg.n_groups) for b in cfg.pattern] + [(b, 1) for b in cfg.tail]
    total = 0.0
    for blk, reps in blocks:
        if blk.mixer != "attn":
            continue
        if kind == "decode":
            # one query per row against the populated cache
            s_sum = min(cache_len, blk.window) if blk.window else cache_len
            s_sum = float(s_sum) * T
        else:
            s_sum = visible_context_sum(T, 0, blk.window)
        total += reps * 4.0 * B * s_sum * H * Dh
    mult = 4.0 if kind == "train" else 1.0
    return total * mult
