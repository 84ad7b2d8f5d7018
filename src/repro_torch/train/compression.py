"""Error-feedback gradient compression for the cross-pod (DCN) hop:
:mod:`repro.train.compression` on torch.

``compress_int8``/``decompress_int8`` implement stochastic-rounding int8
with a per-row scale (row = last axis), and ``ef_compress_tree`` bf16
truncation too; the residual buffer is part of the train state.  The
int8 rounding noise comes from a ``torch.Generator`` (the train step
seeds it from the state's rng words), so it is not jax's stream: int8
agrees with the reference in its properties, bf16 bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.model import _tree_map
from .optim import tree_get

__all__ = ["compress_int8", "decompress_int8", "ef_compress_tree", "ef_ratio"]


def compress_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise (per-row) int8 quantization with stochastic rounding.
    Returns (q int8, scale f32)."""
    xf = x.float()
    flat = xf.reshape(-1, x.shape[-1]) if x.dim() > 1 else xf.reshape(1, -1)
    scale = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = flat / scale
    noise = torch.rand(y.shape, generator=generator, device=y.device) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale.reshape(
        x.shape[:-1] + (1,) if x.dim() > 1 else (1, 1)
    )


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads, residual, generator: torch.Generator,
                     kind: str = "int8"):
    """Error-feedback compression over a gradient tree.

    Returns (compressed_then_decompressed_grads, new_residual): the grads
    that the cross-pod reduction would transport (reconstructed), and what
    compression left out of them, added back in the next step.  A ``None``
    gradient (a leaf the loss does not reach) counts as zeros."""
    if kind not in ("int8", "bf16"):
        raise ValueError(kind)
    new_res = {}

    def one(path, g):
        r = tree_get(residual, path)
        gf = r if g is None else g.float() + r  # no gradient: zeros
        if kind == "int8":
            # the reference's reconstruction of a 1-D leaf broadcasts to
            # (1, D), and with it the leaf's moments and parameter; the port
            # keeps the leaf's shape
            rec = decompress_int8(*compress_int8(gf, generator)).reshape(gf.shape)
        else:
            rec = gf.to(torch.bfloat16).float()
        new_res[path] = gf - rec
        return rec if g is None else rec.to(g.dtype)

    out = _tree_map(one, grads)
    return out, _tree_map(lambda path, _: new_res[path], grads)


def ef_ratio(kind: str) -> float:
    """Bytes-on-the-wire ratio vs f32 (for the roofline's collective term)."""
    return {"int8": 0.25, "bf16": 0.5, "none": 1.0}[kind]
