"""RG-LRU gated linear recurrence on Hopper — RecurrentGemma's recurrent
block, in prefill and in every decode step.

Replaces the TPU kernel :func:`repro.kernels.rglru_scan._rglru_kernel` (a
chunked associative scan with the carry in VMEM across a sequential chunk
grid axis) with the hand-written CUDA C++ kernels ``csrc/rglru_scan.cu``
for ``sm_90a``.  The function is bound by bytes on the H100.  The kernels
scan time in chunks, in two launches and without atomics: each chunk's
(product of a, state from 0) pair, then each chunk's rescan from the state
its predecessors' pairs give; :func:`chunking` picks the chunks, and a
decode step (T = 1) is one launch.  See the note in the source.

For a tensor on the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.rglru_scan_ref`; for a CUDA tensor it
launches the kernels or raises.  It enters no device context: the tensors
must be on the current device, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .ref import rglru_scan_ref

__all__ = ["chunking", "rglru_scan"]

_ENTRY = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}
#: the C entry's arguments: 6 pointers (x, a, h0, y, h_T, scratch), b, t,
#: d, the chunk length, and the stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]

#: the shortest chunk, and the step every chunk's length is a multiple of,
#: in the kernels' groups of steps loaded together: pass 2 folds one pair
#: per chunk before its own, so a chunk shorter than this is not worth it
_MIN_GROUPS = 2
#: most chunks: pass 2 of the last chunk folds MAX_CHUNKS - 1 pairs
MAX_CHUNKS = 64


def chunking(b: int, t: int, d: int, tile: int, group: int,
             blocks: int) -> Tuple[int, int]:
    """``(chunk, K)``: steps per chunk and the number of chunks of a (b, t,
    d) scan, for kernels of ``tile`` channels a block that load ``group``
    steps together, on a card that holds ``blocks`` of their blocks at
    once (the wrapper reads all three from the C entry and the card).  K
    is the fewest chunks whose (d / tile) · K · b blocks fill the card,
    with chunks of at least ``_MIN_GROUPS`` groups, a multiple of that,
    and at most ``MAX_CHUNKS`` of them; every chunk but the last is
    whole.  K = 1 at T ≤ 1."""
    if t <= 1:
        return max(t, 1), 1
    tiles = b * -(-d // tile)
    step = _MIN_GROUPS * group
    k = min(-(-blocks // tiles), -(-t // step), MAX_CHUNKS)
    chunk = -(-t // k)
    chunk = -(-chunk // step) * step
    return chunk, -(-t // chunk)


@functools.lru_cache(maxsize=None)
def _geometry(index: int) -> Tuple[int, int, int]:
    """``chunking``'s (tile, group, blocks) on card ``index``: channels a
    block, steps loaded together and blocks an SM holds, as the C source
    sets them, and the card's SMs."""
    fn = _build.load("rglru_scan").rglru_scan_geometry
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_int64 * 3)()
    fn(out)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return out[0], out[1], out[2] * sms


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("rglru_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, a: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: x on {x.device}, need cuda")
    _build.refuse_grad("rglru_scan", x, a, h0)
    if a.device != x.device:
        raise ValueError(f"rglru_scan: a on {a.device}, x on {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"rglru_scan: x dtype {x.dtype}, need float32 or "
                        "bfloat16")
    if a.dtype != x.dtype:
        raise TypeError(f"rglru_scan: a dtype {a.dtype}, x dtype {x.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan: need x and a (B, T, D) of one shape, "
                         f"got {tuple(x.shape)} and {tuple(a.shape)}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("rglru_scan: x and a must be contiguous")
    if h0 is not None:
        if h0.device != x.device:
            raise ValueError(f"rglru_scan: h0 on {h0.device}, x on {x.device}")
        if h0.dtype != torch.float32:
            raise TypeError(f"rglru_scan: h0 dtype {h0.dtype}, need float32")
        if h0.shape != (x.shape[0], x.shape[2]):
            raise ValueError(f"rglru_scan: h0 must be ({x.shape[0]}, "
                             f"{x.shape[2]}), got {tuple(h0.shape)}")
        if not h0.is_contiguous():
            raise ValueError("rglru_scan: h0 must be contiguous")
    current = torch.cuda.current_device()
    if x.get_device() != current:
        raise ValueError(f"rglru_scan: x on {x.device}, the current device is "
                         f"cuda:{current}: call under "
                         f"torch.cuda.device({x.device})")


def rglru_scan(
    x: torch.Tensor,  # (B, T, D) gated input
    a: torch.Tensor,  # (B, T, D) recurrence gate in (0, 1)
    h0: Optional[torch.Tensor] = None,  # (B, D) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` → ``(h_all,
    h_T)``: every state in x's dtype and the last in float32.  Each call
    that launches adds one to ``rglru_scan.launches``, whether it takes one
    launch or two."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rglru_scan_ref(x, a, h0)
        _check(x, a, h0)  # raises: not cuda
    # every check of _check in one expression of cheap accessors, and
    # _check, which names the fault, only where one fails
    index = x.get_device()
    if not (x.dtype in _ENTRY and a.dtype == x.dtype and x.dim() == 3
            and a.shape == x.shape and a.get_device() == index
            and index == torch._C._cuda_getDevice()
            and x.is_contiguous() and a.is_contiguous()
            and (h0 is None or (h0.dtype == torch.float32
                                and h0.get_device() == index
                                and h0.dim() == 2 and h0.size(0) == x.size(0)
                                and h0.size(1) == x.size(2)
                                and h0.is_contiguous()))
            and not ((x.requires_grad or a.requires_grad
                      or h0 is not None and h0.requires_grad)
                     and torch.is_grad_enabled())):
        _check(x, a, h0)
    B, T, D = x.shape
    y = torch.empty_strided((B, T, D), (T * D, D, 1), dtype=x.dtype,
                            device=x.device)
    if not (B and D and T):  # nothing to scan: h_T is the initial state
        h_t = (h0.clone() if h0 is not None else
               torch.zeros((B, D), dtype=torch.float32, device=x.device))
        return y, h_t
    h_t = torch.empty_strided((B, D), (D, 1), dtype=torch.float32,
                              device=x.device)
    chunk, k = chunking(B, T, D, *_geometry(index))
    scratch = (torch.empty_strided((2 * B * (k - 1) * D,), (1,),
                                   dtype=torch.float32, device=x.device)
               if k > 1 else None)
    rc = _kernel(x.dtype)(
        x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_t.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, D, chunk,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    rglru_scan.launches += 1
    return y, h_t


rglru_scan.launches = 0
