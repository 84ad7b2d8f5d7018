"""The training step: microbatched gradient accumulation, AdamW, optional
error-feedback gradient compression — :mod:`repro.train.train_step`.

``make_train_step`` returns the step function.  The reference's
``lax.scan`` over microbatches is a Python loop that sums the gradients in
float32; its ``jax.value_and_grad`` is ``torch.autograd.grad`` over the
parameters' leaves.

On a mesh (``mesh=``, a ``DeviceMesh`` over the default process group)
the state is DTensors placed by :func:`state_shardings`: FSDP over
``data``, tensor and expert parallel over ``model``, moments and
residuals like their parameters.  The step hands the parameters to the
model as they rest: :func:`repro_torch.models.model.forward` gathers one
group's parameters over ``data`` when the group runs (and again in
remat's recompute), every dense layer computes on this rank's ``model``
shard, and the loss is this rank's rows' (its shard of the batch over
the batch axes).  The gradients come back from autograd in the
parameters' placements: the gathers' backward reduce-scatters them over
``data`` and averages them over ``pod`` (and over ``data`` for a leaf
replicated there), and along ``model`` each rank's shard has its own.
AdamW then runs on the DTensors, DTensor's sharding propagation doing
the reductions of the global gradient norm.  No step gathers the whole
parameter tree.

With gradient compression on a mesh, the step compresses what one device
compresses: the averaged global gradient of each leaf, whole.  Each
gradient and each residual is all-gathered, every rank runs
``ef_compress_tree`` over the whole leaves with the generator seeded
alike (so each leaf's per-row scales and noise are the one-device draws),
then keeps its own shard of the result and of the new residual (a local
slice).  Per step and rank that is an all-gather of the float32
gradients and one of the residuals, each the size of the parameters, on
top of the uncompressed step's reduce-scatters.
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
           "prng_key", "state_shardings", "place_state"]


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


def state_shardings(cfg: ArchConfig, state: TrainState, mesh) -> TrainState:
    """The :class:`~repro_torch.models.sharding.NamedSharding` of every
    leaf of the train state, under the active rules: optimizer moments and
    residuals shard exactly like their parameters; scalars replicate.  The
    rng is the host's key words, alike on every rank, and stays a plain
    tensor (``None``)."""
    from ..models.sharding import NamedSharding

    named = M.param_named_shardings(cfg, state.params, mesh)
    rep = NamedSharding.of(mesh, ())

    def like_params(tree):
        # moments/residual trees mirror params; scalar placeholders replicate
        return M._tree_map(lambda path, leaf: rep if leaf.ndim == 0
                           else tree_get(named, path), tree)

    return TrainState(
        params=named,
        opt=AdamWState(step=rep, m=like_params(state.opt.m),
                       v=like_params(state.opt.v)),
        residual=like_params(state.residual),
        rng=None,
        step=rep,
    )


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` (full tensors, alike on every rank) as DTensors placed by
    ``shardings``; a leaf whose sharding is ``None`` stays as it is."""
    def place(tree, sh):
        if sh is None:
            return tree
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(place(getattr(tree, f), getattr(sh, f))
                                for f in tree._fields))
        if isinstance(tree, dict):
            return {k: place(v, sh[k]) for k, v in tree.items()}
        return sh.place(tree)

    return place(state, shardings)


def _local_rows(batch, mesh):
    """This rank's rows of a global batch: its shard over the batch axes
    (the reference's ``P(("pod", "data"))`` on the batch dim)."""
    axes = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    index, count = 0, 1
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        index, count = index * n + mesh.get_local_rank(a), count * n
    out = {}
    for name, a in batch.items():
        if a.shape[0] % count:
            raise ValueError(f"batch of {a.shape[0]} rows does not split "
                             f"over {count} batch shards")
        rows = a.shape[0] // count
        out[name] = a[index * rows:(index + 1) * rows]
    return out, axes


def make_train_step(
    cfg: ArchConfig,
    tcfg: TrainConfig,
    mesh=None,
    lr_fn: Optional[Callable] = None,
) -> Callable:
    """The train-step function ``step(state, batch) -> (state, metrics)``;
    ``batch`` holds tensors on the parameters' device (on a mesh: the whole
    global batch, alike on every rank; each rank takes its rows).  The
    state's tensors are updated in place and returned in a new
    ``TrainState``; ``metrics`` are device tensors (reading one waits for
    the step)."""
    def grads_of(params, batch):
        """(loss, metrics, grads): grads in float32, ``None`` for a leaf the
        loss does not reach (``adamw_update`` counts it as zeros, as jax
        gives them)."""
        leaves = M._tree_map(lambda _, a: a.detach().requires_grad_(), params)
        loss, metrics = M.loss_fn(
            cfg, leaves, batch, mesh=mesh, use_kernels=tcfg.use_kernels,
            compute_dtype=tcfg.compute_dtype, remat=tcfg.remat,
            z_loss=tcfg.z_loss,
        )
        gs = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                      allow_unused=True))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                M._tree_map(lambda *_: next(gs), leaves))

    def compressed_on_mesh(grads, state: TrainState, gen):
        """``ef_compress_tree`` over the whole averaged gradients and the
        whole residuals (all-gathered), alike on every rank; each rank
        keeps its shards of both results."""
        from ..models.sharding import NamedSharding

        def whole(tree):
            return M._tree_map(lambda _, a: a if a is None
                               else a.full_tensor(), tree)
        out, res = ef_compress_tree(whole(grads), whole(state.residual), gen,
                                    kind=tcfg.compression)

        def like(tree, ref):
            # a whole value's shard is a local slice: no communication
            return M._tree_map(lambda path, a: NamedSharding(
                mesh, tuple(tree_get(ref, path).placements)).place(a), tree)
        return like(out, state.params), like(res, state.residual)

    def train_step(state: TrainState, batch):
        axes = ()
        params = state.params
        if mesh is not None:
            batch, axes = _local_rows(batch, mesh)
        k = tcfg.microbatches
        if k > 1:
            parts = {name: a.reshape((k, a.shape[0] // k) + a.shape[1:])
                     for name, a in batch.items()}
            grads = None
            loss = torch.zeros((), device=tree_leaves(params)[0].device)
            for i in range(k):
                l, metrics, g = grads_of(params,
                                         {n: a[i] for n, a in parts.items()})
                loss = loss + l
                grads = g if grads is None else M._tree_map(
                    lambda path, a: a if a is None
                    else a.add_(tree_get(g, path)), grads)
            grads = M._tree_map(lambda _, a: a if a is None else a / k, grads)
            loss = loss / k
        else:
            loss, metrics, grads = grads_of(params, batch)
        compress = tcfg.compression != "none"
        if mesh is not None:
            from ..models.sharding import mean_over, sum_over

            # the global batch's loss: every shard holds as many tokens
            loss = mean_over(loss, mesh, axes)
            tokens = metrics["tokens"]
            for a in axes:
                tokens = sum_over(tokens, mesh, a)
            metrics = dict(metrics, ce=mean_over(metrics["ce"], mesh, axes),
                           z_loss=mean_over(metrics["z_loss"], mesh, axes),
                           tokens=tokens)

        rng, seed = _split(state.rng)
        residual = state.residual
        if compress:
            gen = torch.Generator(device=state.step.device)
            gen.manual_seed(seed)
            if mesh is None:
                grads, residual = ef_compress_tree(grads, residual, gen,
                                                   kind=tcfg.compression)
            else:
                grads, residual = compressed_on_mesh(grads, state, gen)

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

