"""AdamW from scratch over the parameter dict, with global-norm clipping
and a linear-warmup cosine schedule: :mod:`repro.train.optim` on torch.

The arithmetic is the reference's, in float32 and in its order: clip,
then moments, then bias corrections, then decoupled decay.  The step, the
learning rate and the bias corrections stay device tensors, so an update
waits for nothing on the host.  ``adamw_update`` writes the new
parameters and moments into their tensors (PyTorch's optimizer idiom: a
functional update would hold two copies of the state at once) and
returns them in a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..models.model import _tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: parameters whose path contains any of these substrings are excluded
    #: from weight decay (norms, biases, router plan tensors).
    no_decay: tuple = ("norm", "bias", "scale", "plan_", "A_log", "dt_bias")


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """The tensors of a dict tree, in its order."""
    out = []
    _tree_map(lambda _, a: out.append(a), tree)
    return out


def tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def adamw_init(params) -> AdamWState:
    zeros = lambda: _tree_map(lambda _, a: torch.zeros_like(a), params)  # noqa: E731
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(), v=zeros())


def cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int, min_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr(step)``: a float32 tensor on the step's device."""
    def lr(step):
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0,
        )
        # the cosine of the float32 angle taken in float64 and rounded, as
        # XLA's float32 cos gives it; torch's float32 cos is an ulp off at
        # some steps
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos((math.pi * prog).double()).float()))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def _decay_mask(params, no_decay) -> Any:
    return _tree_map(lambda path, _: not any(s in "/".join(path)
                                             for s in no_decay), params)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32; ``None`` leaves
    add nothing."""
    sq = sum(torch.sum(torch.square(a.float()))
             for a in tree_leaves(tree) if a is not None)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params,
    grads,
    state: AdamWState,
    lr_fn: Optional[Callable] = None,
) -> tuple:
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    parameter and moment tensors are updated in place.  A ``None``
    gradient (a leaf the loss does not reach) counts as zeros, as jax
    gives them: its moments decay and its weight decay applies."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    lr = lr_fn(state.step) if lr_fn is not None else cfg.lr
    decay = _decay_mask(params, cfg.no_decay)

    def upd(path, p):
        g = tree_get(grads, path)
        g = (torch.zeros_like(p, dtype=torch.float32) if g is None
             else (g * scale).float())
        m, v = tree_get(state.m, path), tree_get(state.v, path)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if tree_get(decay, path):
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        return p

    new_params = _tree_map(upd, params)
    return new_params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr,
    }
