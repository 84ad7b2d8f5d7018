"""Mamba-1 selective scan on Hopper — Falcon-Mamba's mixer, in prefill and
in every decode step.

Replaces the TPU kernel :func:`repro.kernels.mamba_scan._mamba_kernel` (a
chunked associative scan over a (batch, d_inner block, chunk) grid with the
state carried in VMEM) with the hand-written CUDA C++ kernel
``csrc/mamba_scan.cu`` for ``sm_90a``: lanes across channels, each thread
a group of a channel's states in registers, time serial, its inputs staged
into shared memory ahead of use by ``cp.async``; see the note in the
source.

For a tensor on the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`; for a CUDA tensor it
launches the kernel or raises.  It enters no device context: the tensors
must be on the current device, or the wrapper raises.  The kernel reads A
and D in their own dtype, float32 or bfloat16, so the served path casts
nothing.
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
#: the C entry's dtype code of A and of D
_PARAM_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry's arguments: 9 pointers (x, delta, A, B, C, D, h0, y, h_T),
#: b, t, d_inner, d_state, B's and C's batch and time strides, A's and D's
#: dtype codes, and the stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 10 + [ctypes.c_void_p]

#: a channel's states are spread over 4 warps, at most 8 states a thread
MAX_STATE = 32


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("mamba_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(x, delta, A, Bc, Cc, D, h0) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: x on {x.device}, need cuda")
    _build.refuse_grad("mamba_scan", x, delta, A, Bc, Cc, D, h0)
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
                         f"{MAX_STATE} states (4 warps of up to 8)")
    for name in ("Bc", "Cc"):
        t = named[name]
        if t.shape != (B, T, Ds):
            raise ValueError(f"mamba_scan: {name} must be ({B}, {T}, {Ds}), "
                             f"got {tuple(t.shape)}")
        if t.stride(2) != 1 and t.numel():
            raise ValueError(f"mamba_scan: {name} needs unit stride along "
                             f"d_state, got strides {t.stride()}")
    if D.shape != (Di,):
        raise ValueError(f"mamba_scan: D must be ({Di},), got "
                         f"{tuple(D.shape)}")
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
    current = torch.cuda.current_device()
    if x.get_device() != current:
        raise ValueError(f"mamba_scan: x on {x.device}, the current device is "
                         f"cuda:{current}: call under "
                         f"torch.cuda.device({x.device})")


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
    may be in another (the parameters' own): the kernel reads float32 and
    bfloat16 as they are, and any other float dtype, or a strided A or D,
    is made float32 and contiguous here.  Bc and Cc may be views with any
    batch and time strides.  Each kernel launch adds one to
    ``mamba_scan.launches``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return mamba_scan_ref(x, delta, A, Bc, Cc, D, h0)
        _check(x, delta, A, Bc, Cc, D, h0)  # raises: not cuda
    # every check of _check in one expression of cheap accessors, and
    # _check, which names the fault, only where one fails
    index = x.get_device()
    dtype = x.dtype
    if not (dtype in _ENTRY and x.dim() == 3 and delta.shape == x.shape
            and delta.dtype == dtype and Bc.dtype == dtype
            and Cc.dtype == dtype and A.is_floating_point()
            and D.is_floating_point() and A.dim() == 2
            and A.size(0) == x.size(2) and 1 <= A.size(1) <= MAX_STATE
            and Bc.dim() == 3 and Bc.size(0) == x.size(0)
            and Bc.size(1) == x.size(1) and Bc.size(2) == A.size(1)
            and Cc.dim() == 3 and Cc.size(0) == x.size(0)
            and Cc.size(1) == x.size(1) and Cc.size(2) == A.size(1)
            and (Bc.stride(2) == 1 and Cc.stride(2) == 1 or not Bc.numel())
            and D.dim() == 1 and D.size(0) == x.size(2)
            and delta.get_device() == index and A.get_device() == index
            and Bc.get_device() == index and Cc.get_device() == index
            and D.get_device() == index
            and index == torch._C._cuda_getDevice()
            and x.is_contiguous() and delta.is_contiguous()
            and (h0 is None or (h0.dtype == torch.float32
                                and h0.get_device() == index
                                and h0.dim() == 3
                                and h0.size(0) == x.size(0)
                                and h0.size(1) == x.size(2)
                                and h0.size(2) == A.size(1)
                                and h0.is_contiguous()))
            and not ((x.requires_grad or delta.requires_grad
                      or A.requires_grad or Bc.requires_grad
                      or Cc.requires_grad or D.requires_grad
                      or h0 is not None and h0.requires_grad)
                     and torch.is_grad_enabled())):
        _check(x, delta, A, Bc, Cc, D, h0)
    B, T, Di = x.shape
    Ds = A.size(1)
    y = torch.empty_strided((B, T, Di), (T * Di, Di, 1), dtype=dtype,
                            device=x.device)
    if not (B and Di and T):  # nothing to scan: h_T is the initial state
        h_t = (h0.clone() if h0 is not None else
               torch.zeros((B, Di, Ds), dtype=torch.float32, device=x.device))
        return y, h_t
    h_t = torch.empty_strided((B, Di, Ds), (Di * Ds, Ds, 1),
                              dtype=torch.float32, device=x.device)
    if A.dtype not in _PARAM_CODE or not A.is_contiguous():
        A = A.to(torch.float32).contiguous()
    if D.dtype not in _PARAM_CODE or not D.is_contiguous():
        D = D.to(torch.float32).contiguous()
    rc = _kernel(dtype)(
        x.data_ptr(), delta.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_t.data_ptr(), B, T, Di, Ds,
        Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
        _PARAM_CODE[A.dtype], _PARAM_CODE[D.dtype],
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    mamba_scan.launches += 1
    return y, h_t


mamba_scan.launches = 0
