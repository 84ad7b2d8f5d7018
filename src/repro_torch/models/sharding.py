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
           "NamedSharding", "DEFAULT_RULES", "SP_RULES", "INFERENCE_RULES",
           "axis_size", "axis_rank", "tp_size", "tp_rank", "local_range",
           "expect_local", "column_in", "row_out", "gather_plan",
           "gather_param", "assemble", "sum_over", "grad_sum_over",
           "mean_over", "max_over"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
#: batch axes of a mesh, outermost first
BATCH_AXES = ("pod", "data")

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
        out as this sharding says: each rank slices its shard out of its
        own copy, with no communication."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            local_shard(tensor, self.mesh, self.placements), self.mesh,
            list(self.placements), run_check=False, shape=tensor.shape,
            stride=tensor.stride())


def local_shard(tensor: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``tensor`` under ``placements`` (a copy): mesh
    dims left to right, each a ``torch.chunk`` of its tensor dim, as
    DTensor lays a ``Shard`` out."""
    t = tensor
    for m, p in enumerate(placements):
        if p.is_shard():
            chunks = torch.chunk(t, mesh.size(m), dim=p.dim)
            i = mesh.get_local_rank(m)
            t = chunks[i] if i < len(chunks) else t.narrow(p.dim, 0, 0)
    # a copy: a view would keep the whole tensor alive with the shard
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# the mesh as model code sees it
# ---------------------------------------------------------------------------

def axis_size(mesh, axis: str) -> int:
    """Ranks along mesh dim ``axis`` (1 without a mesh or that dim)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along mesh dim ``axis`` (0 without it)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def tp_size(mesh) -> int:
    """The tensor-parallel degree: ranks along ``"model"``."""
    return axis_size(mesh, "model")


def tp_rank(mesh) -> int:
    return axis_rank(mesh, "model")


def local_range(n_local: int, mesh) -> Tuple[int, int]:
    """The global ``[lo, hi)`` of this rank's ``n_local`` entries of a dim
    split evenly over ``"model"``."""
    lo = tp_rank(mesh) * n_local
    return lo, lo + n_local


def expect_local(n_local: int, n_global: int, mesh, what: str) -> None:
    """Raise unless ``n_local`` is this rank's even share of ``n_global``
    over ``"model"``: model code on a mesh takes the local shards of its
    weights, never whole ones (pad the config with
    ``configs.padded_for_tp``)."""
    tp = tp_size(mesh)
    if n_local * tp != n_global:
        raise ValueError(f"{what}: {n_local} local of {n_global} on a mesh "
                         f"with {tp} 'model' ranks (the layers take each "
                         "rank's shard of the weights; pad the config for "
                         "this tensor-parallel degree)")


def column_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-parallel product (or of any work each
    ``"model"`` rank does on its own shard): ``x`` as it is, its gradient
    summed over ``"model"``."""
    return grad_sum_over(x, mesh, "model") if tp_size(mesh) > 1 else x


def row_out(y: torch.Tensor, mesh) -> torch.Tensor:
    """The output of a row-parallel product: each ``"model"`` rank's
    partial sum, summed."""
    return sum_over(y, mesh, "model") if tp_size(mesh) > 1 else y


# ---------------------------------------------------------------------------
# parameters at rest and the per-layer gather
# ---------------------------------------------------------------------------

def gather_plan(leaf, mesh, shift: int = 0, blocks: int = 1):
    """How ``leaf`` (a DTensor at rest, or a plain tensor: whole along the
    batch axes) becomes the tensor its layer computes with: ``(shards,
    means, regroup)``.  ``shards`` are the ``(axis, tensor dim + shift)``
    of each batch axis that shards it (outermost first), ``means`` the
    batch axes it is replicated over (axes of one rank are left out).
    ``regroup`` is ``(dim, blocks)`` for a leaf whose dim is the
    concatenation of ``blocks`` equal blocks and rests sharded over
    ``"model"`` in one piece (Mamba's ``in_proj``, [x | z]): its layer
    takes this rank's share of every block, else ``None``.  ``shift`` -1 is
    the plan of one group's slice of a group-stacked leaf."""
    shards, means, regroup = [], [], None
    placements = getattr(leaf, "placements", None)
    for axis in BATCH_AXES:
        if axis_size(mesh, axis) == 1:
            continue
        p = (placements[mesh.mesh_dim_names.index(axis)]
             if placements is not None else None)
        if p is not None and p.is_shard():
            shards.append((axis, p.dim + shift))
        else:
            means.append(axis)
    if blocks > 1 and placements is not None and tp_size(mesh) > 1:
        p = placements[mesh.mesh_dim_names.index("model")]
        if p.is_shard():
            regroup = (p.dim + shift, blocks)
    return tuple(shards), tuple(means), regroup


def gather_param(x: torch.Tensor, mesh, plan) -> torch.Tensor:
    """A parameter's local shard ``x`` as one layer computes with it:
    all-gathered over the batch axes that shard it (``plan`` from
    :func:`gather_plan`), its ``"model"`` shard kept (for a regrouped
    leaf: all-gathered over ``"model"`` too, then this rank's share of
    each block taken).  The backward gives the gradient of the ranks'
    common objective (the mean over the batch axes of each rank's loss):
    a reduce-scatter over each sharding axis (the regrouped leaf's
    zero-padded over ``"model"`` first) and an all-reduce over each
    replicating one, each divided by its ranks."""
    shards, means, regroup = plan
    if not shards and regroup is None and not (means and x.requires_grad):
        return x
    return _GatherParam.apply(x, mesh, shards, means, regroup)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    gt = g.movedim(dim, 0).contiguous()
    if gt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                         f"over {n} ranks")
    out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shards, means, regroup):
        ctx.mesh, ctx.shards, ctx.means, ctx.regroup = (mesh, shards, means,
                                                        regroup)
        for axis, dim in reversed(shards):  # innermost axis first
            x = _all_gather(x, dim, mesh.get_group(axis),
                            axis_size(mesh, axis))
        if regroup is not None:
            dim, blocks = regroup
            tp, r = tp_size(mesh), tp_rank(mesh)
            whole = _all_gather(x, dim, mesh.get_group("model"), tp)
            split = whole.unflatten(dim, (blocks, whole.shape[dim] // blocks))
            share = split.shape[dim + 1] // tp
            x = split.narrow(dim + 1, r * share, share).flatten(dim, dim + 1)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        mesh = ctx.mesh
        if ctx.regroup is not None:
            dim, blocks = ctx.regroup
            tp, r = tp_size(mesh), tp_rank(mesh)
            part = g.unflatten(dim, (blocks, g.shape[dim] // blocks))
            share = part.shape[dim + 1]
            shape = list(part.shape)
            shape[dim + 1] = tp * share
            whole = part.new_zeros(shape)
            whole.narrow(dim + 1, r * share, share).copy_(part)
            g = _reduce_scatter(whole.flatten(dim, dim + 1), dim,
                                mesh.get_group("model"), tp)
        for axis, dim in ctx.shards:
            n = axis_size(mesh, axis)
            g = _reduce_scatter(g, dim, mesh.get_group(axis), n) / n
        for axis in ctx.means:
            g = g.clone()
            dist.all_reduce(g, group=mesh.get_group(axis))
            g = g / axis_size(mesh, axis)
        return g, None, None, None, None


def assemble(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The whole of a tensor whose pieces along ``dim`` lie on the ranks of
    mesh dims ``axes`` (outermost first, in rank order), all-gathered.  No
    gradient (serving reads it)."""
    for axis in reversed(tuple(axes)):
        if axis_size(mesh, axis) > 1:
            x = _all_gather(x, dim % x.dim(), mesh.get_group(axis),
                            axis_size(mesh, axis))
    return x


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


def max_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum over mesh dim ``axis``, detached (a softmax's
    shift, which no gradient needs)."""
    import torch.distributed as dist

    x = x.detach()
    if axis_size(mesh, axis) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return x

