"""Multi-pod dry run: trace every (arch × shape × mesh) on one rank of a
fake world — :mod:`repro.launch.dryrun` on torch.

For each cell this script

  1. starts a fake process group of the mesh's size (256 ranks for the
     16×16 pod, 512 for 2×16×16; no process talks to another) unless the
     process already has one, and builds the mesh on it;
  2. builds this rank's stand-ins on the meta device, shapes and dtypes
     without storage: the train state placed by ``state_shardings`` or the
     serving parameters by ``model.param_named_shardings`` (each leaf a
     DTensor of its local shard), this rank's rows of the batch
     (``configs.input_specs``) and of the decode cache (``model.init_cache``
     at this rank's rows, kv heads and channels), so no memory is ever
     allocated;
  3. runs the port's own step function on them (``make_train_step``,
     ``model.prefill``, ``model.decode_step``) under :class:`DeviceCounter`,
     a dispatch mode that sees every op on this rank's local tensors and
     counts its flops, the bytes it reads and writes, the bytes live on the
     device, and each collective's kind, per-rank result bytes and group;
  4. writes a JSON report per cell (``.FAILED`` with the traceback for a
     cell that fails, or whose peak exceeds one card's memory).

The port has no compiler: there is no HLO, and nothing is fused.  The
report keeps every key of the reference's whose meaning carries over and
names the port's own counts otherwise (README, "The dry run").  The
group loop and ``chunked_attention``'s block loop run every iteration in
Python, so one trace counts every layer and every attention block: there
is no rolled build, and ``analysis=`` changes nothing.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both --out reports/
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
        --device cpu   # on a host without a card
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import resolve_device
from repro_torch.configs import (SHAPES, cells, get_config, input_specs,
                                 padded_for_tp)
from repro_torch.launch.analysis import attention_flops
from repro_torch.launch.mesh import PRODUCTION_SHAPES, batch_axes, make_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step, state_shardings)

__all__ = ["run_cell", "collective_bytes", "DeviceCounter", "CARD_BYTES",
           "COLLECTIVE_KINDS"]

#: one H100's memory: a cell whose peak exceeds it does not fit
CARD_BYTES = 80e9
#: the caching allocator's block: every CUDA allocation is a multiple
ALLOC_BLOCK = {"cuda": 512}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: collective op → kind: the functional collectives (DTensor's) and the
#: c10d ops (``torch.distributed``'s, the model's ``sum_over``/``mean_over``)
_COLLECTIVES = {
    "_c10d_functional": {
        "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
        "all_reduce_coalesced": "all-reduce",
        "all_reduce_coalesced_": "all-reduce",
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_out": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all",
    },
    "c10d": {
        "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
        "allgather_": "all-gather", "_allgather_base_": "all-gather",
        "allgather_coalesced_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "reduce_scatter_tensor_coalesced_": "reduce-scatter",
        "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    },
}
#: ops of those namespaces that move no data
_NOT_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
                "monitored_barrier_"}


def collective_bytes(records: Sequence[Tuple[str, Union[int, Sequence[int]],
                                             int]]) -> Dict[str, float]:
    """Per-device bytes moved by each collective kind, from one rank's
    records ``(kind, S, G)``: S the per-rank result bytes (a sequence for
    a tuple result, summed), G the group size.

    The reference's ring-model accounting per op: all-reduce 2·S·(G−1)/G,
    all-gather S·(G−1)/G, reduce-scatter S·(G−1) (operand = G·S),
    all-to-all S·(G−1)/G, collective-permute S; a group of one rank moves
    nothing.
    """
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    for kind, size, g in records:
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        size = size if isinstance(size, int) else sum(size)
        if g <= 1:
            continue
        if kind == "all-reduce":
            out[kind] += 2.0 * size * (g - 1) / g
        elif kind == "all-gather":
            out[kind] += size * (g - 1) / g
        elif kind == "reduce-scatter":
            out[kind] += float(size) * (g - 1)
        elif kind == "all-to-all":
            out[kind] += size * (g - 1) / g
        else:  # collective-permute
            out[kind] += float(size)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    """The plain tensors of a tree (a DTensor's local tensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Uncacheable(Exception):
    pass


def _desc(a):
    """A hashable description of an op argument for the meta cache; raises
    ``_Uncacheable`` for a real tensor or an object."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise _Uncacheable
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return ("seq",) + tuple(_desc(v) for v in a)
    if isinstance(a, dict):
        return ("dict",) + tuple((k, _desc(v)) for k, v in a.items())
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.layout, torch.memory_format)):
        return a
    if isinstance(a, torch.device) and a.type == "meta":
        return a
    raise _Uncacheable


def _layout_of(t: torch.Tensor):
    return (tuple(t.shape), t.stride(), t.storage_offset(),
            t.untyped_storage().nbytes())


class DeviceCounter(TorchDispatchMode):
    """What one rank does, op by op, under this mode: every op on a DTensor
    is handed back to DTensor (``NotImplemented``), so the mode sees the
    ops on the local tensors it runs them as, and counts

    * ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
      convolutions, attention; an elementwise op counts 0), as
      ``FlopCounterMode`` counts them, but per rank (``FlopCounterMode``
      counts a DTensor op at its global size);
    * ``operand_bytes``: the bytes each op reads and writes, unfused (a
      view moves nothing);
    * ``live``/``peak``: bytes of the storages alive on ``device_type``
      (each rounded up to ``block``, the allocator's), from
      :meth:`arguments` on; a storage is freed when the last tensor on it
      dies, as the allocator frees it;
    * ``collectives``: ``(kind, per-rank result bytes, group size)`` of
      every collective, in order (see :func:`collective_bytes`).

    On meta tensors an op runs once per distinct (op, shapes, strides,
    dtypes, arguments); after that its result is rebuilt from what that
    run recorded: fresh outputs, the written argument of an in-place op, a
    view of the first argument.  A meta op that runs in Python costs about
    100 µs, and a 32k-token prefill runs millions of them.
    """

    def __init__(self, device_type: str = "meta", block: int = 1):
        super().__init__()
        self.device_type = device_type
        self.block = block
        self.flops = 0
        self.operand_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self._storages: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self._cache: Dict[Any, Any] = {}
        self._kinds: Dict[Any, Any] = {}

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = -(-st.nbytes() // self.block) * self.block
        self._storages[key] = n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)
        self._refs.pop(key, None)

    def arguments(self, *trees) -> int:
        """Count the storages of ``trees`` (the step's arguments, made
        before the mode) as live; returns their bytes."""
        before = self.live
        for tree in trees:
            for t in _tensors(tree):
                self._track(t)
        return self.live - before

    def storage_bytes(self, *trees) -> int:
        """Bytes of the distinct storages of ``trees`` on the device."""
        seen = {}
        for tree in trees:
            for t in _tensors(tree):
                if t.device.type == self.device_type:
                    st = t.untyped_storage()
                    seen[st._cdata] = -(-st.nbytes() // self.block) * self.block
        return sum(seen.values())

    # -- collectives ----------------------------------------------------------
    def _collective(self, func, args, kwargs, out) -> None:
        ns, name = func.namespace, func._opname
        kind = _COLLECTIVES.get(ns, {}).get(name)
        if kind is None:
            if name in _NOT_TRAFFIC:
                return
            raise NotImplementedError(
                f"the dry run has no byte accounting for {func}")
        bound = dict(zip((a.name for a in func._schema.arguments), args),
                     **kwargs)
        if ns == "c10d":
            # in place: the first argument holds the result
            result, pg = args[0], bound["process_group"]
            if not isinstance(pg, torch.distributed.ProcessGroup):
                pg = torch.distributed.ProcessGroup.unbox(pg)
            group = pg.size()
        else:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group

            result = out
            group = _resolve_process_group(bound["group_name"]).size()
        self.collectives.append((kind, _nbytes(result), int(group)))

    # -- dispatch -------------------------------------------------------------
    def _kind(self, func):
        """How a meta run of ``func`` can be replayed: ``"fresh"`` (new
        outputs), ``"inplace"`` (returns its first argument, written),
        ``"view"`` (returns a view of its first argument), or ``None``."""
        kind = self._kinds.get(func, 0)
        if kind == 0:
            schema, kind = func._schema, None
            rets = schema.returns
            if (func.namespace in _COLLECTIVES
                    or "nondeterministic_seeded" in func.tags):
                pass
            elif not schema.is_mutable and all(r.alias_info is None
                                               for r in rets):
                kind = "fresh"
            elif (len(rets) == 1 and rets[0].alias_info is not None
                  and schema.arguments
                  and schema.arguments[0].alias_info is not None
                  and set(rets[0].alias_info.before_set)
                  == set(schema.arguments[0].alias_info.before_set)
                  and str(rets[0].type) == "Tensor"):
                write = rets[0].alias_info.is_write
                others_written = any(
                    a.alias_info is not None and a.alias_info.is_write
                    for a in schema.arguments[1:])
                if not others_written:
                    kind = "inplace" if write else "view"
            self._kinds[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor, fake = _subclasses()
        if (torch._C._meta_in_tls_dispatch_include()
                or any(issubclass(t, fake) for t in types)):
            # DTensor's sharding propagation runs ops on fake tensors of
            # the global shapes: no rank does that work
            return func(*args, **kwargs)
        if any(issubclass(t, dtensor) for t in types):
            return NotImplemented  # DTensor runs it on the local tensors
        self.ops += 1
        kind = self._kind(func)
        key = None
        if kind is not None:
            try:
                key = (func, _desc(args), _desc(kwargs))
            except _Uncacheable:
                key = None
            else:
                hit = self._cache.get(key)
                if hit is not None:
                    return self._replay(kind, hit, args)
        before = _layout_of(args[0]) if kind == "inplace" else None
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.namespace in _COLLECTIVES:
            self._collective(func, args, kwargs, out)
            flops = moved = 0
        else:
            flops = self._flops(func, args, kwargs, out)
            moved = 0 if kind == "view" else _nbytes((args, kwargs)) + \
                _nbytes(out)
        self.flops += flops
        self.operand_bytes += moved
        for t in outs:
            self._track(t)
        if key is not None:
            self._remember(key, kind, args, out, outs, flops, moved, before)
        return out

    def _remember(self, key, kind, args, out, outs, flops, moved,
                  before) -> None:
        if not outs or any(t.device.type != "meta" for t in outs):
            return
        first = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if kind == "fresh":
            if isinstance(out, torch.Tensor):
                structure = None
            elif isinstance(out, (tuple, list)) and len(outs) == len(out):
                structure = type(out)
            else:
                return
            # an op that hands back an input's storage (``_unsafe_view``)
            # allocates nothing: never rebuild it as a fresh tensor
            ins = {t.untyped_storage()._cdata for t in _tensors(args)}
            if any(t.untyped_storage()._cdata in ins for t in outs):
                return
            record = ([(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                      structure)
        elif kind == "inplace":
            # an in-place op that reshapes its argument (``unsqueeze_``,
            # ``resize_``) must run every time
            if out is not first or _layout_of(first) != before:
                return
            record = None
        else:
            if (first is None or out.dtype != first.dtype
                    or out.untyped_storage()._cdata
                    != first.untyped_storage()._cdata):
                return
            record = (tuple(out.shape), out.stride(),
                      out.storage_offset() - first.storage_offset())
        self._cache[key] = (record, flops, moved)

    def _replay(self, kind, hit, args):
        record, flops, moved = hit
        self.flops += flops
        self.operand_bytes += moved
        if kind == "inplace":
            return args[0]
        if kind == "view":
            size, stride, delta = record
            return args[0].as_strided(size, stride,
                                      args[0].storage_offset() + delta)
        metas, structure = record
        outs = [torch.empty_strided(s, st, dtype=d, device="meta")
                for s, st, d in metas]
        for t in outs:
            self._track(t)
        return outs[0] if structure is None else structure(outs)

    @staticmethod
    def _flops(func, args, kwargs, out) -> int:
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func._overloadpacket)
        return int(count(*args, **kwargs, out_val=out)) if count else 0

    @contextlib.contextmanager
    def memoized(self, owner, name: str):
        """Within: ``owner.<name>``, a function whose ops follow from its
        arguments' shapes alone, is traced once per distinct signature on
        meta tensors that no gradient flows through; a later call with
        the same signature adds what the first one counted (flops, bytes,
        ops, collectives, its peak above the live bytes at entry) and
        returns fresh outputs of the recorded shapes (a tensor or a tuple
        of them).  A first call that leaves anything alive but its own
        outputs is never replayed."""
        from torch.utils._python_dispatch import _disable_current_modes

        fn = getattr(owner, name)
        memo: Dict[Any, Any] = {}

        def fresh(out, ins) -> bool:
            inputs = {t.untyped_storage()._cdata for t in ins}
            outs = _tensors(out)
            return (len({t.untyped_storage()._cdata for t in outs})
                    == len(outs)
                    and all(t.is_contiguous()
                            and t.untyped_storage().nbytes()
                            == t.numel() * t.element_size()
                            and t.untyped_storage()._cdata not in inputs
                            for t in outs))

        def traced_once(*args, **kwargs):
            ins = _tensors((args, kwargs))
            key = None
            if all(t.device.type == "meta" and not t.requires_grad
                   for t in ins):
                try:
                    key = (_desc(args), _desc(kwargs))
                except _Uncacheable:
                    key = None
            hit = memo.get(key) if key is not None else None
            if hit is not None:
                flops, moved, ops, colls, rise, metas, single = hit
                self.flops += flops
                self.operand_bytes += moved
                self.ops += ops
                self.collectives.extend(colls)
                self.peak = max(self.peak, self.live + rise)
                with _disable_current_modes():
                    outs = tuple(torch.empty_strided(sh, st, dtype=dt,
                                                     device="meta")
                                 for sh, st, dt in metas)
                for t in outs:
                    self._track(t)
                return outs[0] if single else outs
            start = (self.flops, self.operand_bytes, self.ops,
                     len(self.collectives), self.live, self.peak)
            self.peak = self.live
            out = fn(*args, **kwargs)
            rise = self.peak - start[4]
            self.peak = max(self.peak, start[5])
            single = isinstance(out, torch.Tensor)
            if (key is not None
                    and (single or (isinstance(out, tuple) and all(
                        isinstance(t, torch.Tensor) for t in out)))
                    and fresh(out, ins)
                    and self.live - start[4] == self.storage_bytes(out)):
                memo[key] = (self.flops - start[0],
                             self.operand_bytes - start[1],
                             self.ops - start[2],
                             self.collectives[start[3]:], rise,
                             [(tuple(t.shape), t.stride(), t.dtype)
                              for t in _tensors(out)], single)
            return out

        setattr(owner, name, traced_once)
        try:
            yield
        finally:
            setattr(owner, name, fn)


_SUBCLASSES: List[type] = []


def _subclasses() -> List[type]:
    """(DTensor, FakeTensor), imported once."""
    if not _SUBCLASSES:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        _SUBCLASSES.extend((DTensor, FakeTensor))
    return _SUBCLASSES


# ---------------------------------------------------------------------------
# the fake world and the stand-ins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks in which this process is rank 0
    and no collective moves data (torch's ``fake`` backend), unless the
    process already has one; left in a ``finally``."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    # importing the module registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def forget_layouts() -> None:
    """Clear DTensor's caches of sharding propagation and redistribution.
    They key layouts by mesh equality, and a mesh of one world equals the
    same-shaped mesh of an earlier world: a cached layout would carry the
    earlier world's process groups."""
    from torch.distributed.tensor import DTensor, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    fast = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if fast is not None:
        fast()


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


def meta_params(cfg, dtype: torch.dtype = torch.float32, tp: int = 1):
    """``model.init``'s parameter tree as meta tensors: shapes and dtypes of
    the port's own init (traced on fake tensors), no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = M.init(cfg, torch.Generator(), device="cpu", dtype=dtype,
                        tp=tp)
    return M._tree_map(lambda _, a: _meta_like(a), params)


def _shard_like(t: torch.Tensor, sharding):
    """This rank's shard of ``t`` (a meta tensor) placed by ``sharding``, as
    a DTensor over a meta local tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(
        t.shape, sharding.mesh, sharding.placements)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), sharding.mesh,
        sharding.placements, run_check=False, shape=t.shape,
        stride=t.stride())


def _placed(tree, shardings):
    """``tree`` of meta tensors as DTensors placed by ``shardings`` (a leaf
    whose sharding is ``None`` stays as it is)."""
    if shardings is None:
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_placed(getattr(tree, f), getattr(shardings, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    return _shard_like(tree, shardings)


def _batch_shards(mesh) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in batch_axes(mesh))


def _local_rows(batch, nb: int):
    """Fresh meta tensors of this rank's rows of ``batch``: dim 0 over
    ``nb`` shards when it divides, else whole (the reference's
    ``_batch_shardings`` rule)."""
    out = {}
    for name, a in batch.items():
        shape = list(a.shape)
        if nb > 1 and shape[0] % nb == 0:
            shape[0] //= nb
        out[name] = torch.empty(shape, dtype=a.dtype, device="meta")
    return out


def _mesh_label(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _layout(kind: str, mesh, spec, nb: int, rows: int, moe: bool,
            rules_name: str) -> Dict[str, str]:
    """What the port ran on this mesh (README, "The dry run")."""
    axes = batch_axes(mesh)
    out = {}
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    gathered = ("each group's parameters all-gathered over the batch axes "
                "that shard them when the group runs")
    dense = (f"every dense layer tensor parallel over 'model' ({tp} ranks): "
             "its heads, ffn and Mamba/RG-LRU channels split, all-reduces "
             "at the row-parallel outputs; the embedding and the logits "
             "vocab parallel")
    if kind == "train":
        out["parameters"] = (
            "float32 masters, AdamW moments and residuals at rest as "
            "state_shardings places them (FSDP over 'data', TP/EP over "
            f"'model'); {gathered} (again in remat's recompute), their "
            "backward the reduce-scatter of the gradients")
        out["batch"] = (f"the global batch of {spec.global_batch} rows on "
                        f"every rank; each rank trains on its {rows} rows "
                        f"over {axes}")
    else:
        out["parameters"] = (f"at rest as the rules ({rules_name}) place "
                             f"them in the compute dtype; {gathered}")
        out["batch"] = (f"{rows} of {spec.global_batch} rows on each rank "
                        f"(over {axes} where {nb} shards divide the batch, "
                        "else whole)")
        if kind == "decode":
            out["cache"] = ("this rank's rows of the cache (where the batch "
                            "divides), its kv heads and Mamba/RG-LRU "
                            "channels")
    out["dense layers"] = dense
    if moe:
        out["experts"] = ("each rank routes its tokens over all experts "
                          "and runs the experts of its 'model' shard; the "
                          "outputs summed over 'model'")
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    compute_dtype=torch.bfloat16,
    donate: bool = True,
    mesh=None,
    reduced: bool = False,
    analysis: bool = True,
    variant: str = "baseline",  # baseline | infer_tp | kv_int8 | last_only, joined by '+'
    microbatches: int = 1,
    device=None,
) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell for rank 0 on stand-ins; return
    the report.

    ``mesh`` is ``None`` (the production 16×16, or 2×16×16 with
    ``multi_pod``), a ``(shape, axes)`` pair, or a ``DeviceMesh``; without
    a process group, a fake world of the mesh's size is started and left
    in a ``finally``.  ``device`` (default: the process default, the card)
    is where the step would run: the mesh's device type and the
    allocator's rounding; nothing is allocated there.  ``donate`` and
    ``analysis`` are the reference's and change nothing: the port's steps
    update the state and the cache in place, and one trace counts every
    loop iteration."""
    del donate, analysis
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cell = (cfg, arch, shape, dev, compute_dtype, variant, microbatches)
    forget_layouts()
    try:
        if mesh is not None and not isinstance(mesh, tuple):
            return _trace(mesh, *cell)
        shape_, axes = mesh or PRODUCTION_SHAPES[bool(multi_pod)]
        with fake_world(math.prod(shape_)):
            return _trace(make_mesh(shape_, axes, dev.type), *cell)
    finally:
        forget_layouts()


def _trace(mesh, cfg_orig, arch, shape, dev, compute_dtype, variant,
           microbatches):
    spec = SHAPES[shape]
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    # TP-divisibility padding, as the reference pads (exact semantics)
    cfg = padded_for_tp(cfg_orig, tp)
    nb = _batch_shards(mesh)
    rules, rules_name = DEFAULT_RULES, "DEFAULT_RULES"
    if "infer_tp" in variant and spec.kind != "train":
        from repro_torch.models.sharding import INFERENCE_RULES

        rules, rules_name = INFERENCE_RULES, "INFERENCE_RULES"
    report: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": _mesh_label(mesh),
        "n_devices": int(mesh.size()), "kind": spec.kind,
        "model_params": cfg_orig.n_params(),
        "model_active_params": cfg_orig.n_active_params(),
        "padded_params": cfg.n_params(),
        "padded_active_params": cfg.n_active_params(),
        "attn_flops_total": attention_flops(
            cfg, spec.kind, B=spec.global_batch,
            T=spec.seq_len if spec.kind != "decode" else 1,
            cache_len=spec.seq_len if spec.kind == "decode" else 0),
        "variant": variant, "microbatches": microbatches,
        "device": dev.type, "rules": rules_name,
    }
    counter = DeviceCounter("meta", ALLOC_BLOCK.get(dev.type, 1))
    batch = input_specs(cfg, shape, dtype=compute_dtype)
    if spec.kind == "train":
        tcfg = TrainConfig(compute_dtype=compute_dtype, remat=True,
                           use_kernels=False, microbatches=microbatches)
        state = init_state(cfg, meta_params(cfg, torch.float32, tp))
        with axis_rules(mesh, rules):
            state = _placed(state, state_shardings(cfg, state, mesh))
        step = make_train_step(cfg, tcfg, mesh=mesh)
        args = (state, batch)
        rows = spec.global_batch // nb
    else:
        params = meta_params(cfg, compute_dtype, tp)
        with axis_rules(mesh, rules):
            params = _placed(params, M.param_named_shardings(cfg, params,
                                                             mesh))
        batch = _local_rows(batch, nb)
        rows = next(iter(batch.values())).shape[0]
        if spec.kind == "prefill":
            last_only = "last_only" in variant

            def step(params, batch):
                return M.prefill(cfg, params, batch,
                                 max_cache_len=spec.seq_len, mesh=mesh,
                                 last_only=last_only)
            args = (params, batch)
        else:
            # this rank's rows (where the batch divides), kv heads and
            # channels of the cache
            cache = M.init_cache(cfg, rows, spec.seq_len, compute_dtype,
                                 kv_int8="kv_int8" in variant, device="meta",
                                 mesh=mesh)

            def step(params, batch, cache):
                return M.decode_step(cfg, params, batch, cache, mesh=mesh)
            args = (params, batch, cache)
    report["layout"] = _layout(spec.kind, mesh, spec, nb, rows,
                               bool(cfg.n_experts), rules_name)
    t0 = time.perf_counter()
    from repro_torch.kernels import ref
    from repro_torch.models import layers

    with axis_rules(mesh, rules), counter, \
            counter.memoized(layers, "chunked_attention"), \
            counter.memoized(ref, "mamba_scan_ref"), \
            counter.memoized(ref, "rglru_scan_ref"):
        report["argument_size_in_bytes"] = counter.arguments(*args)
        out = step(*args)
        report["output_size_in_bytes"] = counter.storage_bytes(out)
        del out
    report["trace_s"] = round(time.perf_counter() - t0, 2)
    report["per_device_bytes"] = int(counter.peak)
    report["fits_card"] = bool(counter.peak <= CARD_BYTES)
    report["flops_per_device"] = int(counter.flops)
    report["unfused_operand_bytes_per_device"] = int(counter.operand_bytes)
    report["ops_per_device"] = int(counter.ops)
    report["collectives_per_device_bytes"] = collective_bytes(
        counter.collectives)
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, _, _ in counter.collectives:
        counts[kind] += 1
    report["collectives_per_device_count"] = counts
    report["collectives"] = [list(c) for c in counter.collectives]
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the process default, cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    failures = []
    for arch, shape in todo:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            failed = path + ".FAILED"
            if (args.skip_done and os.path.exists(path)
                    and not os.path.exists(failed)):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            if os.path.exists(failed):
                os.remove(failed)
            try:
                rep = run_cell(arch, shape, mp, device=device)
                with open(path, "w") as f:
                    json.dump(rep, f, indent=1)
                coll = rep["collectives_per_device_bytes"]["total"]
                print(f"  trace={rep['trace_s']}s "
                      f"mem/dev={rep['per_device_bytes'] / 2**30:.2f}GiB "
                      f"flops/dev={rep['flops_per_device']:.3g} "
                      f"coll/dev={coll / 2**20:.1f}MiB", flush=True)
                if not rep["fits_card"]:
                    # the counterpart of the reference's compile-time OOM;
                    # the report stays beside the .FAILED file
                    raise MemoryError(
                        f"per_device_bytes {rep['per_device_bytes']} exceeds "
                        f"one card's {CARD_BYTES:.0f}")
            except Exception as e:  # a failing cell is a framework bug
                failures.append((tag, repr(e)))
                with open(failed, "w") as f:
                    f.write(traceback.format_exc())
                print(f"  FAILED: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("\nall cells traced.")


if __name__ == "__main__":
    main()
