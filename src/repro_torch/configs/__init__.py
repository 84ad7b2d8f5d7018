"""Architecture registry + assigned input shapes.

``get_config(name)`` — the exact published config; ``--arch <id>`` in the
launchers resolves here.  The architecture files are the reference's with
only their import line changed.  ``input_specs`` and ``cache_specs`` give
the dry run's stand-ins for a shape's inputs and decode cache: tensors on
the meta device, shapes and dtypes without storage (the reference's
``ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ArchConfig

from .llama4_scout_17b_a16e import CONFIG as _llama4
from .granite_moe_3b_a800m import CONFIG as _granite
from .phi3_vision_4_2b import CONFIG as _phi3v
from .olmo_1b import CONFIG as _olmo
from .mistral_nemo_12b import CONFIG as _nemo
from .qwen3_1_7b import CONFIG as _qwen3
from .stablelm_1_6b import CONFIG as _stablelm
from .recurrentgemma_9b import CONFIG as _rgemma
from .falcon_mamba_7b import CONFIG as _fmamba
from .musicgen_large import CONFIG as _musicgen

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "cache_specs", "cells",
           "get_config", "input_specs", "padded_for_tp", "shape_supported"]

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _llama4, _granite, _phi3v, _olmo, _nemo,
        _qwen3, _stablelm, _rgemma, _fmamba, _musicgen,
    ]
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def padded_for_tp(cfg: ArchConfig, tp: int) -> ArchConfig:
    """TP-divisibility padding (DESIGN.md §TP-padding).

    * KV heads are *repeated* up to a multiple of ``tp`` — exact for GQA
      (each repeated head serves fewer query heads).
    * Query heads are padded to the next count divisible by both ``tp`` and
      the padded KV count — the extra heads are dead weight whose FLOPs
      surface in the roofline's MODEL_FLOPS/HLO_FLOPS ratio.
    * Vocab is padded to a multiple of ``tp``; padded logits are masked to
      -inf in forward (``vocab_real``), so semantics are exact.

    ``n_params()`` of the returned config counts padded shapes; roofline
    code uses the *original* config for MODEL_FLOPS.
    """
    changes = {}
    has_attn = any(b.mixer == "attn" for b in cfg.pattern + cfg.tail)
    if has_attn:
        kv = cfg.n_kv_heads
        if kv % tp and tp % kv == 0:
            kv = tp
        elif kv % tp:
            kv = -(-kv // tp) * tp
        hq = cfg.n_heads
        lcm = np.lcm(tp, kv)
        if hq % lcm:
            hq = int(-(-hq // lcm) * lcm)
        if (hq, kv) != (cfg.n_heads, cfg.n_kv_heads):
            changes.update(
                n_heads=int(hq), n_kv_heads=int(kv), head_dim=cfg.head_dim_
            )
    if cfg.vocab % tp:
        changes.update(
            vocab=int(-(-cfg.vocab // tp) * tp), vocab_real=cfg.vocab
        )
    return dataclasses.replace(cfg, **changes) if changes else cfg


def shape_supported(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (skip rationale in
    DESIGN.md §Shape-skips); everything else runs everywhere."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


def cells():
    """All supported (arch, shape) dry-run cells."""
    out = []
    for a, cfg in ARCHS.items():
        for s in SHAPES:
            if shape_supported(cfg, s):
                out.append((a, s))
    return out


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of the given shape.

    train:   {tokens|embeds, labels}
    prefill: {tokens|embeds}
    decode:  {tokens|embeds, positions} (+ cache, built separately by
             ``cache_specs``)
    """
    spec = SHAPES[shape]
    B, T = spec.global_batch, spec.seq_len
    i32 = torch.int32

    def text_or_embed(bt):
        if cfg.frontend == "embed":
            return {"embeds": _spec(bt + (cfg.d_model,), dtype)}
        return {"tokens": _spec(bt, i32)}

    if spec.kind == "train":
        out = text_or_embed((B, T))
        out["labels"] = _spec((B, T), i32)
        return out
    if spec.kind == "prefill":
        return text_or_embed((B, T))
    # decode: one new token against a cache of length seq_len
    out = text_or_embed((B, 1))
    out["positions"] = _spec((B, 1), i32)
    return out


def cache_specs(cfg: ArchConfig, shape: str,
                dtype: torch.dtype = torch.bfloat16, kv_int8: bool = False):
    """The decode cache of a decode shape on the meta device: the port's
    ``init_cache`` without storage."""
    from repro_torch.models import model as M

    spec = SHAPES[shape]
    assert spec.kind == "decode"
    return M.init_cache(cfg, spec.global_batch, spec.seq_len, dtype,
                        kv_int8=kv_int8, device="meta")
