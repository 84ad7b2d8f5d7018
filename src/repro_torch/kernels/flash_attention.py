"""Forward flash attention on Hopper — the prefill attention of
RecurrentGemma (local, MQA, Dh 256) and Granite-MoE (causal GQA, Dh 64).

Replaces the TPU kernel :func:`repro.kernels.flash_attention._attn_kernel`
(blockwise online softmax with the running max, normaliser and accumulator
in VMEM across a sequential kv grid axis) with the hand-written CUDA C++
kernels of ``csrc/flash_attention.cu`` for ``sm_90a``.  The function is
bound by operations on the H100, and both kernels skip every kv tile that
no query of the block can see, as the TPU kernel does.  Which kernel runs
is a rule of (dtype, Dh), :func:`_entry`:

* bfloat16 with Dh 64, 128 or 256 (:data:`WGMMA_HEAD_DIMS`, the served
  widths among them): both products on the tensor cores with ``wgmma``,
  Q, K and V fed by TMA, the online softmax in float32 registers, P
  rounded to bf16 for the second product.  q, k and v must be 16-byte
  aligned (TMA's rule).
* bfloat16 at any other Dh <= 256, and float32: the CUDA-core kernel,
  both products in float32.  float32 stays there because the tensor cores
  take float32 only as TF32.

See the note in the source.  For a tensor on the CPU the wrapper computes
the plain version :func:`repro_torch.kernels.ref.attention_ref`; for a
CUDA tensor it launches the kernel that the rule names or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention"]

#: widest head either kernel takes (their largest instantiation)
MAX_HEAD_DIM = 256
#: bf16 head widths of the tensor-core kernel: whole 64-column (128-byte)
#: TMA boxes, one instantiation each
WGMMA_HEAD_DIMS = (64, 128, 256)


def _entry(dtype: torch.dtype, dh: int) -> str:
    """The C entry point that a (dtype, Dh) pair launches; raises on what
    neither kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {dtype}, need float32 or "
                        "bfloat16")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} > {MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return "flash_attention_f32"
    if dh in WGMMA_HEAD_DIMS:
        return "flash_attention_bf16_wgmma"
    return "flash_attention_bf16"


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    fn = getattr(_build.load("flash_attention"), entry)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i32, i64, i64,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> str:
    """Raise on what the kernels do not take; else the entry point."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q on {q.device}, need cuda")
    _build.refuse_grad("flash_attention", q, k, v)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}, q "
                            f"dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: need q (B, Hq, T, Dh) and k, v (B, Hkv, S, Dh); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    entry = _entry(q.dtype, Dh)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window}, need >= 1 or "
                         "None")
    if entry.endswith("_wgmma") and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned "
                         "for the tensor-core kernel")
    return entry


def flash_attention(
    q: torch.Tensor,  # (B, Hq, T, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dh)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention with causal, sliding-window and ``q_offset`` masking,
    scale ``Dh**-0.5``, float32 softmax; ``(B, Hq, T, Dh)`` in q's dtype.
    A query that sees no key gives 0.  Each kernel launch adds one to
    ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    entry = _check(q, k, v, window)
    B, Hq, T, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _kernel(entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, T, S, Dh, int(bool(causal)),
                -1 if window is None else int(window), int(q_offset),
                Dh ** -0.5, stream,
            )
        if rc != 0:
            raise RuntimeError(f"flash_attention: kernel launch failed with "
                               f"CUDA error {rc}")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
