"""Logical-axis sharding (MaxText-style) — :mod:`repro.models.sharding` on
DTensor.

Model code annotates tensors with *logical* axis names; a rules table maps
logical names to physical mesh axes.  Outside any mesh context, or on a
plain (non-DTensor) tensor, the annotations are no-ops, so the same model
code runs single-device and on a mesh unchanged.

A spec (:func:`spec_for`) is what the reference's ``PartitionSpec`` holds:
one entry per tensor dim, ``None``, a mesh axis name, or a tuple of them,
each axis used at most once.  DTensor describes the same layout the other
way round, one placement per *mesh* dim: :func:`placements_for` turns a
spec into those placements (a tensor dim over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple, Union

import torch

__all__ = ["axis_rules", "shard", "spec_for", "placements_for",
           "NamedSharding", "DEFAULT_RULES", "SP_RULES", "INFERENCE_RULES"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

#: logical-name → physical mesh axis (or tuple of axes, or None).
#: Baseline layout: DP over (pod, data); TP/EP over model; FSDP-style
#: parameter sharding over data.
DEFAULT_RULES: Dict[str, Union[None, str, Tuple[str, ...]]] = {
    # --- activations ---
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_ffn": "model",
    "act_vocab": "model",
    "act_exp": "model",
    # --- parameters ---
    "vocab": "model",
    "embed": "data",  # fsdp
    "heads": "model",
    "kv_heads": "model",
    "qkv_fsdp": "data",
    "ffn": "model",
    "ffn_fsdp": "data",
    "experts": "model",
    # experts are 2D-sharded: EP over 'model' AND FSDP over 'data' on the
    # d_model dim (the reference's layout, sized for its production mesh)
    "expert_in": "data",
    "expert_out": None,
    "ssm_inner": "model",
    "ssm_fsdp": "data",
    "ssm_state": None,
}

#: Sequence-parallel variant: long-prefill shapes shard the sequence
#: dimension over the data axis (batch is then replicated or pod-sharded).
SP_RULES = dict(DEFAULT_RULES, act_seq="data", act_batch="pod")

#: Inference variant: no optimizer state exists, so FSDP-sharding
#: parameters over 'data' only buys per-layer all-gathers.  Replicate
#: params across 'data' (pure TP over 'model').
INFERENCE_RULES = dict(
    DEFAULT_RULES,
    embed=None, qkv_fsdp=None, ffn_fsdp=None, ssm_fsdp=None,
)

_ctx = threading.local()


def _current():
    return getattr(_ctx, "mesh", None), getattr(_ctx, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict] = None):
    """Activate a mesh (a ``DeviceMesh`` with named dims, or ``None``) and a
    logical-rules table for model code in scope, on this thread."""
    prev = _current()
    _ctx.mesh = mesh
    _ctx.rules = dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def _spec(names, rules, keep=lambda axis: True) -> Spec:
    axes, used = [], set()
    for n in names:
        ax = rules.get(n) if n else None
        flat = () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))
        # an axis may appear at most once in a spec
        flat = tuple(a for a in flat if keep(a) and a not in used)
        used.update(flat)
        axes.append(None if not flat else (flat[0] if len(flat) == 1 else flat))
    return tuple(axes)


def spec_for(*names: Optional[str]) -> Spec:
    """The spec of a tensor whose dims carry the logical ``names`` (None =
    replicated), under the active rules: the entries of the reference's
    ``PartitionSpec``."""
    return _spec(names, _current()[1])


def placements_for(mesh, spec: Spec):
    """DTensor placements, one per dim of ``mesh``, for ``spec``: mesh dim
    ``m`` is ``Shard(d)`` where tensor dim ``d``'s entry names it, else
    ``Replicate()``.  Axes the mesh lacks are ignored."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for axis in (() if entry is None else
                     ((entry,) if isinstance(entry, str) else entry)):
            owner[axis] = d
    return tuple(Shard(owner[name]) if name in owner else Replicate()
                 for name in mesh.mesh_dim_names)


def shard(x, *names: Optional[str]):
    """Annotate ``x`` with logical axes: a no-op outside a mesh context or
    on a plain tensor; a DTensor is redistributed to the layout the rules
    give (mesh axes the active mesh lacks are dropped), the counterpart of
    ``with_sharding_constraint``."""
    mesh, rules = _current()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    names_ = mesh.mesh_dim_names
    placements = placements_for(
        mesh, _spec(names, rules, keep=lambda a: a in names_))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a mesh: the counterpart of jax's
    ``NamedSharding``, as DTensor placements (one per mesh dim)."""

    mesh: Any
    placements: Tuple[Any, ...]

    @classmethod
    def of(cls, mesh, spec: Spec) -> "NamedSharding":
        return cls(mesh, placements_for(mesh, spec))

    def place(self, tensor: torch.Tensor):
        """A DTensor of ``tensor``, which every rank holds in full, laid
        out as this sharding says (each rank keeps its shard)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, list(self.placements))


# ---------------------------------------------------------------------------
# collectives inside a model's forward, with the gradients of SPMD code
# ---------------------------------------------------------------------------
#
# Model code on a mesh computes on this rank's local tensors and reduces
# across a mesh dim's process group.  Each op below has the backward that
# makes autograd give the gradient of the ranks' common objective: the
# mean over the batch axes of each rank's loss, one copy per replica along
# the other axes (where every rank computes the same values).


class _SumOverGroup(torch.autograd.Function):
    """Sum of each rank's partial value; downstream every rank computes the
    same thing, so the gradient reaches each contribution unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumOverGroup(torch.autograd.Function):
    """Identity into a computation that each rank does for its part (its
    local experts); the gradients of the parts are summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOverGroup(torch.autograd.Function):
    """Mean over the group of values that differ by rank (a statistic of
    each rank's tokens): the gradient of a mean is the mean."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` over mesh dim ``axis`` of per-rank parts of one value."""
    return _SumOverGroup.apply(x, mesh.get_group(axis))


def grad_sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, its gradient summed over mesh dim ``axis``."""
    return _GradSumOverGroup.apply(x, mesh.get_group(axis))


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean`` over the mesh dims ``axes`` (one after the other: equal
    group sizes make the mean of the means the mean)."""
    for axis in axes:
        x = _MeanOverGroup.apply(x, mesh.get_group(axis))
    return x

