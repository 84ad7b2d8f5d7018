"""MoE token dispatch on Hopper — the scatter of routed tokens into
per-expert capacity buffers, in every MoE layer of every prefill and decode
step.

Replaces the TPU kernel :func:`repro.kernels.moe_dispatch._dispatch_kernel`
(a one-hot ``(C, block)`` MXU product per (expert, token block) grid cell,
accumulated into the expert's VMEM-resident buffer) with the hand-written
CUDA C++ kernel ``csrc/moe_dispatch.cu`` for ``sm_90a``: one block per
token row, each kept row added into a float32 ``(E, C, D)`` buffer with
float32 atomics, so that rows sharing an (expert, slot) pair are summed as
the TPU kernel sums them; see the note in the source.

``num_experts``, ``capacity`` and D are run-time integers.  For a tensor on
the CPU the wrapper computes the plain version
:func:`repro_torch.kernels.ref.moe_dispatch_ref`; for a CUDA tensor it
launches the kernel or raises.

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
    fn.argtypes = [p, p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _check(tokens, expert_ids, slot_ids, num_experts, capacity) -> None:
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_dispatch: tokens on {tokens.device}, need cuda")
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


def moe_dispatch(
    tokens: torch.Tensor,  # (T, D) float32 or bfloat16
    expert_ids: torch.Tensor,  # (T,) int32
    slot_ids: torch.Tensor,  # (T,) int32
    num_experts: int,
    capacity: int,
) -> torch.Tensor:
    """``(num_experts, capacity, D)`` buffers: row ``t`` of ``tokens`` added
    at ``(expert_ids[t], slot_ids[t])``, in float32, cast back to the
    tokens' dtype; rows with an expert id outside ``[0, num_experts)`` or a
    slot outside ``[0, capacity)`` are dropped, and rows that share a pair
    are summed.  Each kernel launch adds one to ``moe_dispatch.launches``."""
    if tokens.device.type == "cpu":
        return moe_dispatch_ref(tokens, expert_ids, slot_ids, num_experts,
                                capacity)
    _check(tokens, expert_ids, slot_ids, num_experts, capacity)
    t, d = tokens.shape
    e, c = int(num_experts), int(capacity)
    out = torch.zeros((e, c, d), dtype=torch.float32, device=tokens.device)
    if t and d and e and c:
        with torch.cuda.device(tokens.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _kernel(tokens.dtype)(
                tokens.data_ptr(), expert_ids.data_ptr(), slot_ids.data_ptr(),
                out.data_ptr(), t, d, e, c, stream,
            )
        if rc != 0:
            raise RuntimeError(f"moe_dispatch: kernel launch failed with CUDA "
                               f"error {rc}")
        moe_dispatch.launches += 1
    return out.to(tokens.dtype)


moe_dispatch.launches = 0
