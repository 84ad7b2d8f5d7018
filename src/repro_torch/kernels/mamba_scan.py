"""Mamba-1 selective scan on Hopper — Falcon-Mamba's mixer, in prefill and
in every decode step.

Replaces the TPU kernel :func:`repro.kernels.mamba_scan._mamba_kernel` (a
chunked associative scan over a (batch, d_inner block, chunk) grid with the
state carried in VMEM) with the hand-written CUDA C++ kernel
``csrc/mamba_scan.cu`` for ``sm_90a``: one thread per (batch, channel,
state) walking time, the sum over the states taken with warp shuffles; see
the note in the source.

For a tensor on the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .ref import mamba_scan_ref

__all__ = ["MAX_STATE", "mamba_scan"]

_ENTRY = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}

#: a channel's states are lanes of one warp
MAX_STATE = 32


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("mamba_scan"), _ENTRY[dtype])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p] * 9 + [i64] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, delta, A, Bc, Cc, D, h0) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: x on {x.device}, need cuda")
    named = {"delta": delta, "A": A, "Bc": Bc, "Cc": Cc, "D": D, "h0": h0}
    for name, t in named.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"mamba_scan: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"mamba_scan: x dtype {x.dtype}, need float32 or "
                        "bfloat16")
    for name in ("delta", "Bc", "Cc"):
        if named[name].dtype != x.dtype:
            raise TypeError(f"mamba_scan: {name} dtype {named[name].dtype}, "
                            f"x dtype {x.dtype}")
    for name in ("A", "D"):
        if not named[name].is_floating_point():
            raise TypeError(f"mamba_scan: {name} dtype {named[name].dtype}, "
                            "need a float dtype")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError(f"mamba_scan: need x and delta (B, T, Di) of one "
                         f"shape, got {tuple(x.shape)} and "
                         f"{tuple(delta.shape)}")
    B, T, Di = x.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"mamba_scan: A must be ({Di}, Ds), got "
                         f"{tuple(A.shape)}")
    Ds = A.shape[1]
    if not 1 <= Ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {Ds}: the kernel takes 1 to "
                         f"{MAX_STATE} states (one warp lane each)")
    for name in ("Bc", "Cc"):
        t = named[name]
        if t.shape != (B, T, Ds):
            raise ValueError(f"mamba_scan: {name} must be ({B}, {T}, {Ds}), "
                             f"got {tuple(t.shape)}")
        if t.stride(2) != 1:
            raise ValueError(f"mamba_scan: {name} needs unit stride along "
                             f"d_state, got strides {t.stride()}")
    if D.shape != (Di,):
        raise ValueError(f"mamba_scan: D must be ({Di},), got "
                         f"{tuple(D.shape)}")
    if Di * 8 >= 2 ** 31:  # the kernel offsets a chunk's rows in int32
        raise ValueError(f"mamba_scan: d_inner {Di} is too large")
    if not (x.is_contiguous() and delta.is_contiguous()):
        raise ValueError("mamba_scan: x and delta must be contiguous")
    if h0 is not None:
        if h0.dtype != torch.float32:
            raise TypeError(f"mamba_scan: h0 dtype {h0.dtype}, need float32")
        if h0.shape != (B, Di, Ds):
            raise ValueError(f"mamba_scan: h0 must be ({B}, {Di}, {Ds}), got "
                             f"{tuple(h0.shape)}")
        if not h0.is_contiguous():
            raise ValueError("mamba_scan: h0 must be contiguous")


def mamba_scan(
    x: torch.Tensor,  # (B, T, Di)
    delta: torch.Tensor,  # (B, T, Di)
    A: torch.Tensor,  # (Di, Ds)
    Bc: torch.Tensor,  # (B, T, Ds)
    Cc: torch.Tensor,  # (B, T, Ds)
    D: torch.Tensor,  # (Di,)
    h0: Optional[torch.Tensor] = None,  # (B, Di, Ds) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan → ``(y, h_T)``: y (B, T, Di) in x's dtype and h_T
    (B, Di, Ds) in float32.  x, delta, Bc and Cc share one dtype; A and D
    may be in another (the parameters' own) and are widened to float32
    here.  Bc and Cc may be views with any batch and time strides.  Each
    kernel launch adds one to ``mamba_scan.launches``."""
    if x.device.type == "cpu":
        return mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)
    _check(x, delta, A, Bc, Cc, D, h0)
    B, T, Di = x.shape
    Ds = A.shape[1]
    y = torch.empty_like(x)
    if not (B and Di and T):  # nothing to scan: h_T is the initial state
        h_t = (h0.clone() if h0 is not None else
               torch.zeros((B, Di, Ds), dtype=torch.float32, device=x.device))
        return y, h_t
    h_t = torch.empty((B, Di, Ds), dtype=torch.float32, device=x.device)
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(x.dtype)(
            x.data_ptr(), delta.data_ptr(), a32.data_ptr(),
            Bc.data_ptr(), Cc.data_ptr(), d32.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_t.data_ptr(), B, T, Di, Ds,
            Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    mamba_scan.launches += 1
    return y, h_t


mamba_scan.launches = 0
