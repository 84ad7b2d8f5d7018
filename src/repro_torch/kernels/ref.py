"""Plain PyTorch versions of the port's kernels.

They run on any device and define what each kernel computes: the CPU
tests hold them against :mod:`repro.kernels.ref`, and on the card the
kernels are held against them.  They repeat the kernels' arithmetic and are
no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "mamba_scan_ref", "rglru_scan_ref",
           "segment_sum_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, Hq, T, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dh)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masking.

    ``q_offset`` positions the queries inside the kv sequence (decode /
    chunked prefill): query ``t`` attends to keys ``<= t + q_offset``.
    ``window``: keys further than ``window-1`` behind the query are masked.
    Logits and softmax in float32, scale ``Dh**-0.5``; a fully-masked row
    gives 0, not NaN; the result is in q's dtype.
    """
    B, Hq, T, Dh = q.shape
    _, Hkv, S, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    if scale is None:
        scale = Dh ** -0.5
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kr) * scale
    q_pos = torch.arange(T, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully-masked rows produce NaN from softmax(-inf); zero them
    probs = probs.masked_fill(~mask.any(dim=-1)[:, None], 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", probs, vr)
    return out.to(q.dtype)


def mamba_scan_ref(
    x: torch.Tensor,  # (B, T, Di)
    delta: torch.Tensor,  # (B, T, Di)
    A: torch.Tensor,  # (Di, Ds)    (negative-definite diagonal dynamics)
    Bc: torch.Tensor,  # (B, T, Ds)
    Cc: torch.Tensor,  # (B, T, Ds)
    D: torch.Tensor,  # (Di,)
    h0: Optional[torch.Tensor] = None,  # (B, Di, Ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan.

      h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t ⊙ x_t) ⊗ B_t
      y_t = (h_t · C_t) + D ⊙ x_t

    Every input is taken in float32.  Returns ``(y, h_T)``: y (B, T, Di)
    in x's dtype and h_T (B, Di, Ds) in float32.
    """
    Bn, T, Di = x.shape
    Ds = A.shape[1]
    xf, df = x.float(), delta.float()
    Af, Bf, Cf = A.float(), Bc.float(), Cc.float()
    h = (torch.zeros((Bn, Di, Ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = torch.empty((Bn, T, Di), dtype=torch.float32, device=x.device)
    for t in range(T):
        decay = torch.exp(df[:, t, :, None] * Af)  # (B, Di, Ds)
        inject = (df[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = decay * h + inject
        ys[:, t] = torch.einsum("bds,bs->bd", h, Cf[:, t])
    y = ys + D.float() * xf
    return y.to(x.dtype), h


def rglru_scan_ref(
    x: torch.Tensor,  # (B, T, D) gated input
    a: torch.Tensor,  # (B, T, D) recurrence gate in (0, 1)
    h0: Optional[torch.Tensor] = None,  # (B, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU diagonal linear recurrence (RecurrentGemma):

      h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ x_t

    Returns ``(h_all, h_T)``: the full hidden sequence in x's dtype and the
    final state in float32.
    """
    B, T, D = x.shape
    xf, af = x.float(), a.float()
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    inject = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * xf
    hs = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    for t in range(T):
        h = af[:, t] * h + inject[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def segment_sum_ref(
    values: torch.Tensor,  # (N, D)
    segment_ids: torch.Tensor,  # (N,) integer ids, sorted or not
    num_segments: int,
) -> torch.Tensor:
    """Segment sum — the MapReduce combiner/reducer primitive: row ``n`` of
    ``values`` is added into row ``segment_ids[n]`` of the ``(num_segments,
    D)`` output.  Sums are taken in float32 and cast back to the input
    dtype; ids outside ``[0, num_segments)`` are dropped."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    out.index_add_(0, ids[keep], values[keep].float())
    return out.to(values.dtype)
