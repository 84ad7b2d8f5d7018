"""Public ops layer: the entry points the models and the MapReduce engine
call.

Each op launches its Hopper kernel for a CUDA tensor at any size: the
reference's ``_MIN_KERNEL_SEQ`` threshold and its ``D % block_d`` tiling
condition were about the TPU kernels' grids and do not carry over.  For a
tensor on the CPU, or with ``use_kernel=False``, it computes the plain
version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .moe_dispatch import compute_slots, moe_dispatch
from .rglru_scan import rglru_scan
from .segment_reduce import segment_sum

__all__ = ["attention", "combine_tokens", "compute_slots",
           "dispatch_at_slots", "dispatch_tokens", "gated_linear_recurrence",
           "sorted_segment_sum", "ssm_scan"]


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, use_kernel: bool = True):
    """GQA attention (B, Hq, T, Dh) × (B, Hkv, S, Dh) → (B, Hq, T, Dh)."""
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def ssm_scan(x, delta, A, Bc, Cc, D, h0=None, use_kernel: bool = True):
    """Mamba-1 selective scan → (y, h_T)."""
    if use_kernel:
        return mamba_scan(x, delta, A, Bc, Cc, D, h0)
    return ref.mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)


def gated_linear_recurrence(x, a, h0=None, use_kernel: bool = True):
    """RG-LRU → (h_all, h_T)."""
    if use_kernel:
        return rglru_scan(x, a, h0)
    return ref.rglru_scan_ref(x, a, h0)


def sorted_segment_sum(values, segment_ids, num_segments: int,
                       use_kernel: bool = True):
    if use_kernel:
        return segment_sum(values, segment_ids, num_segments)
    return ref.segment_sum_ref(values, segment_ids, num_segments)


def dispatch_at_slots(tokens, expert_ids, slot_ids, num_experts: int,
                      capacity: int, use_kernel: bool = True) -> torch.Tensor:
    """Scatter tokens into (E, C, D) buffers at the given slots: the MoE
    layer's own slot ids (planned capacity, clamped slots) reach the
    kernel through here."""
    if use_kernel:
        return moe_dispatch(tokens.contiguous(), expert_ids.int().contiguous(),
                            slot_ids.int().contiguous(), num_experts, capacity)
    return ref.moe_dispatch_ref(tokens, expert_ids, slot_ids, num_experts,
                                capacity)


def dispatch_tokens(tokens, expert_ids, num_experts: int, capacity: int,
                    use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens into (E, C, D) buffers; returns (buffers, slot_ids)."""
    slots = compute_slots(expert_ids, num_experts)
    return dispatch_at_slots(tokens, expert_ids, slots, num_experts, capacity,
                             use_kernel=use_kernel), slots


def combine_tokens(expert_out, expert_ids, slot_ids, gates, capacity: int):
    """Inverse of dispatch: gather expert outputs back to token order."""
    return ref.moe_combine_ref(expert_out, expert_ids, slot_ids, gates,
                               capacity)
