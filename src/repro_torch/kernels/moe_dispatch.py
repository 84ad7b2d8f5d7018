"""MoE token dispatch on Hopper — the scatter of routed tokens into
per-expert capacity buffers, in every MoE layer of every prefill and decode
step.

Replaces the TPU kernel :func:`repro.kernels.moe_dispatch._dispatch_kernel`
(a one-hot ``(C, block)`` MXU product per (expert, token block) grid cell,
accumulated into the expert's VMEM-resident buffer) with the hand-written
CUDA C++ kernel ``csrc/moe_dispatch.cu`` for ``sm_90a``: an index pass
finds each (expert, slot) pair's first row and count of rows, then one warp
per output row writes it once in the tokens' dtype (zeros, a copy of its
one row, or the float32 sum of its rows in row order, as the TPU kernel
sums rows that share a pair); see the note in the source.

``num_experts``, ``capacity`` and D are run-time integers.  For a tensor on
the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.moe_dispatch_ref`; for a CUDA tensor it
launches the kernel or raises.  The wrapper crosses into C once per call,
with the output and, above the one-launch size (``_SMALL_PAIRS``,
``_SMALL_ROWS``), an int32 workspace of ``2·E·C`` entries from the caching
allocator; without one, the C entry takes its one-launch path.  It enters
no device context: the tensors must be on the current device, or the
wrapper raises.

:func:`compute_slots` (each token's position within its expert, a running
count in token order) is a torch op, as it is a jnp op in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import moe_dispatch_ref

__all__ = ["compute_slots", "moe_dispatch"]

_ENTRY = {torch.float32: "moe_dispatch_f32", torch.bfloat16: "moe_dispatch_bf16"}
#: the index pass keeps each pair's first row as an int32
_MAX_ROWS = 2 ** 31
#: a dispatch of at most this many output rows and rows takes the kernel's
#: one-launch path, whose index of 2·E·C int32 (32 KB at most) lies in
#: shared memory: the wrapper passes it no tables.  At the decode step's
#: 32 rows the three launches of the other path cost the host more than
#: the whole of index_add_'s call.
_SMALL_PAIRS, _SMALL_ROWS = 4096, 2048


def compute_slots(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Position of each token within its expert's buffer (0-based): a
    per-expert running count in token order, int32.  Ids must lie in
    ``[0, num_experts)``."""
    ids = expert_ids.long()
    # (E, T): the running count along the last axis, where the card's scan
    # is fast (a (T, E) count along the first axis takes milliseconds)
    onehot = torch.arange(num_experts, device=ids.device)[:, None] == ids
    running = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    safe = ids.clamp(0, max(num_experts - 1, 0))
    return running.gather(0, safe[None, :]).squeeze(0)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load("moe_dispatch"), _ENTRY[dtype])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _check(tokens, expert_ids, slot_ids, num_experts, capacity) -> None:
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_dispatch: tokens on {tokens.device}, need cuda")
    _build.refuse_grad("moe_dispatch", tokens)
    if tokens.dim() != 2:
        raise ValueError(f"moe_dispatch: tokens must be (T, D), got "
                         f"{tuple(tokens.shape)}")
    if tokens.dtype not in _ENTRY:
        raise TypeError(f"moe_dispatch: tokens dtype {tokens.dtype}, need "
                        "float32 or bfloat16")
    for name, t in (("expert_ids", expert_ids), ("slot_ids", slot_ids)):
        if t.device != tokens.device:
            raise ValueError(f"moe_dispatch: {name} on {t.device}, tokens on "
                             f"{tokens.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"moe_dispatch: {name} dtype {t.dtype}, need int32")
        if t.shape != (tokens.shape[0],):
            raise ValueError(f"moe_dispatch: {name} must be "
                             f"({tokens.shape[0]},), got {tuple(t.shape)}")
    if not (tokens.is_contiguous() and expert_ids.is_contiguous()
            and slot_ids.is_contiguous()):
        raise ValueError("moe_dispatch: tokens, expert_ids and slot_ids must "
                         "be contiguous")
    if int(num_experts) < 0 or int(capacity) < 0:
        raise ValueError(f"moe_dispatch: num_experts={num_experts}, "
                         f"capacity={capacity}: need both >= 0")
    if tokens.shape[0] >= _MAX_ROWS:
        raise ValueError(f"moe_dispatch: {tokens.shape[0]} rows, the kernel "
                         f"takes fewer than {_MAX_ROWS}")
    current = torch.cuda.current_device()
    if tokens.get_device() != current:
        raise ValueError(f"moe_dispatch: tokens on {tokens.device}, the current "
                         f"device is cuda:{current}: call under "
                         f"torch.cuda.device({tokens.device})")


def moe_dispatch(
    tokens: torch.Tensor,  # (T, D) float32 or bfloat16
    expert_ids: torch.Tensor,  # (T,) int32
    slot_ids: torch.Tensor,  # (T,) int32
    num_experts: int,
    capacity: int,
) -> torch.Tensor:
    """``(num_experts, capacity, D)`` buffers in the tokens' dtype: row
    ``t`` of ``tokens`` at ``(expert_ids[t], slot_ids[t])``; rows with an
    expert id outside ``[0, num_experts)`` or a slot outside ``[0,
    capacity)`` are dropped, and rows that share a pair are summed in
    float32, in row order.  Each kernel launch adds one to
    ``moe_dispatch.launches``."""
    if not tokens.is_cuda:
        if tokens.device.type == "cpu":
            return moe_dispatch_ref(tokens, expert_ids, slot_ids, num_experts,
                                    capacity)
        _check(tokens, expert_ids, slot_ids, num_experts, capacity)  # raises
    # every check of _check in one expression of cheap accessors (the
    # host's cost of a call is most of a decode step's dispatch); _check
    # names the fault
    dtype = tokens.dtype
    e, c = int(num_experts), int(capacity)
    index = tokens.get_device()
    if not (dtype in _ENTRY and expert_ids.dtype == torch.int32
            and slot_ids.dtype == torch.int32 and tokens.dim() == 2
            and expert_ids.dim() == 1 and slot_ids.dim() == 1
            and expert_ids.get_device() == index
            and slot_ids.get_device() == index
            and index == torch._C._cuda_getDevice() and e >= 0 and c >= 0
            and tokens.is_contiguous() and expert_ids.is_contiguous()
            and slot_ids.is_contiguous()
            and expert_ids.size(0) == tokens.size(0) == slot_ids.size(0)
            and tokens.size(0) < _MAX_ROWS
            and not (tokens.requires_grad and torch.is_grad_enabled())):
        _check(tokens, expert_ids, slot_ids, num_experts, capacity)
    t, d = tokens.shape
    # empty_strided: no memory-format argument for the host to resolve
    out = torch.empty_strided((e, c, d), (c * d, d, 1), dtype=dtype,
                              device=tokens.device)
    if d and e and c:
        pairs = e * c
        # a small dispatch indexes in shared memory: no tables to allocate
        tables = (None if pairs <= _SMALL_PAIRS and t <= _SMALL_ROWS else
                  torch.empty(2 * pairs, dtype=torch.int32,
                              device=tokens.device))
        rc = _kernel(dtype)(
            tokens.data_ptr(), expert_ids.data_ptr(), slot_ids.data_ptr(),
            out.data_ptr(), 0 if tables is None else tables.data_ptr(),
            t, d, e, c,
            torch._C._cuda_getCurrentRawStream(index),
        )
        if rc != 0:
            raise RuntimeError(f"moe_dispatch: kernel launch failed with CUDA "
                               f"error {rc}")
        moe_dispatch.launches += 1
    return out


moe_dispatch.launches = 0
