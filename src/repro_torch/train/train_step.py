"""The training step: microbatched gradient accumulation, AdamW, optional
error-feedback gradient compression — :mod:`repro.train.train_step` on
one device.

``make_train_step`` returns the step function.  The reference's
``lax.scan`` over microbatches is a Python loop that sums the gradients in
float32; its ``jax.value_and_grad`` is ``torch.autograd.grad`` over the
parameters' leaves.  ``state_shardings`` is not ported: it needs a mesh,
and multi-GPU training is a later item of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..models import model as M
from ..models.config import ArchConfig
from .compression import ef_compress_tree
from .optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    tree_get, tree_leaves)

__all__ = ["TrainState", "TrainConfig", "make_train_step", "init_state",
           "prng_key"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    residual: Any  # error-feedback residual (zeros when compression off)
    rng: torch.Tensor  # (2,) uint32 on the CPU: the reference's key words
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    remat: bool = True
    compute_dtype: Any = torch.bfloat16
    compression: str = "none"  # none | bf16 | int8
    use_kernels: bool = False
    z_loss: float = 1e-4


def prng_key(seed: int) -> torch.Tensor:
    """The two words of ``jax.random.PRNGKey(seed)``, as uint32."""
    return torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        dtype=torch.uint32)


def _split(rng: torch.Tensor):
    """(the next rng words, a 64-bit seed for this step's draws): a
    deterministic function of the words, drawn on the host."""
    hi, lo = (int(w) for w in rng.tolist())
    gen = torch.Generator()
    gen.manual_seed((hi << 32) | lo)
    words = torch.randint(0, 1 << 32, (4,), generator=gen, dtype=torch.int64)
    w = words.tolist()
    return (torch.tensor(w[:2], dtype=torch.uint32), (w[2] << 32) | w[3])


def init_state(cfg: ArchConfig, params, seed: int = 0,
               compression: str = "none") -> TrainState:
    device = tree_leaves(params)[0].device
    residual = (
        M._tree_map(lambda _, a: torch.zeros_like(a, dtype=torch.float32),
                    params)
        if compression != "none"
        else M._tree_map(lambda _, a: torch.zeros((), device=device), params)
    )
    return TrainState(
        params=params,
        opt=adamw_init(params),
        residual=residual,
        rng=prng_key(seed),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_train_step(
    cfg: ArchConfig,
    tcfg: TrainConfig,
    mesh=None,
    lr_fn: Optional[Callable] = None,
) -> Callable:
    """The train-step function ``step(state, batch) -> (state, metrics)``;
    ``batch`` holds tensors on the parameters' device.  The state's
    tensors are updated in place and returned in a new ``TrainState``;
    ``metrics`` are device tensors (reading one waits for the step)."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU training is not ported (ROADMAP.md queue 1, the "
            "multi-GPU item): train on one device")

    def grads_of(params, batch):
        """(loss, metrics, grads): grads in float32, ``None`` for a leaf the
        loss does not reach (``adamw_update`` counts it as zeros, as jax
        gives them)."""
        leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), params)
        loss, metrics = M.loss_fn(
            cfg, leaves, batch, use_kernels=tcfg.use_kernels,
            compute_dtype=tcfg.compute_dtype, remat=tcfg.remat,
            z_loss=tcfg.z_loss,
        )
        gs = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                      allow_unused=True))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                M._tree_map(lambda *_: next(gs), leaves))

    def train_step(state: TrainState, batch):
        k = tcfg.microbatches
        if k > 1:
            parts = {name: a.reshape((k, a.shape[0] // k) + a.shape[1:])
                     for name, a in batch.items()}
            grads, loss = None, torch.zeros((), device=state.step.device)
            for i in range(k):
                l, metrics, g = grads_of(state.params,
                                         {n: a[i] for n, a in parts.items()})
                loss = loss + l
                grads = g if grads is None else M._tree_map(
                    lambda path, a: a if a is None
                    else a.add_(tree_get(g, path)), grads)
            grads = M._tree_map(lambda _, a: a if a is None else a / k, grads)
            loss = loss / k
        else:
            loss, metrics, grads = grads_of(state.params, batch)

        rng, seed = _split(state.rng)
        residual = state.residual
        if tcfg.compression != "none":
            gen = torch.Generator(device=state.step.device)
            gen.manual_seed(seed)
            grads, residual = ef_compress_tree(grads, residual, gen,
                                               kind=tcfg.compression)

        params, opt, opt_metrics = adamw_update(
            tcfg.adamw, state.params, grads, state.opt, lr_fn
        )
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return (
            TrainState(params=params, opt=opt, residual=residual,
                       rng=rng, step=state.step + 1),
            metrics,
        )

    return train_step

