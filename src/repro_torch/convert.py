"""Carry the reference's state across into the port's objects.

The reference's platforms and plans arrive as plain dicts of numpy arrays
and scalars — the form :func:`dataclasses.asdict` gives of a
``repro.core.platform.Platform`` or ``repro.core.plan.ExecutionPlan``,
nested ``Substrate``, ``CapacityTrace`` and ``FailureTrace`` fields
included — an LM's parameters as a nested dict of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives), and a train state as the
reference's ``TrainState`` of numpy arrays, read by its field names, so
that this module needs nothing of the reference package.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.plan import ExecutionPlan
from .core.platform import (
    CapacityTrace,
    FailureEvent,
    FailureTrace,
    Platform,
    Substrate,
)
from .models.config import ArchConfig
from .train.optim import AdamWState
from .train.train_step import TrainState

__all__ = ["lm_params_from_numpy", "plan_from_fields", "platform_from_fields",
           "substrate_from_fields", "train_state_from_numpy"]

_CAPACITIES = ("B_sm", "B_mr", "C_m", "C_r")
_CLUSTERS = ("cluster_s", "cluster_m", "cluster_r")


def _traces(fields: Optional[Mapping[str, Any]]):
    if fields is None:
        return None
    return {
        name: CapacityTrace(times=tuple(t["times"]), values=tuple(t["values"]))
        for name, t in fields.items()
    }


def _failures(fields: Optional[Mapping[str, Any]]):
    if fields is None:
        return None
    return FailureTrace(events=tuple(FailureEvent(**ev)
                                     for ev in fields["events"]))


def substrate_from_fields(fields: Mapping[str, Any]) -> Substrate:
    """A :class:`Substrate` from its fields, traces and failures included."""
    return Substrate(
        **{k: np.asarray(fields[k]) for k in _CAPACITIES + _CLUSTERS},
        name=str(fields.get("name", "substrate")),
        traces=_traces(fields.get("traces")),
        failures=_failures(fields.get("failures")),
    )


def platform_from_fields(fields: Mapping[str, Any]) -> Platform:
    """A :class:`Platform` from its fields, with its optional substrate."""
    sub = fields.get("substrate")
    return Platform(
        D=np.asarray(fields["D"]),
        **{k: np.asarray(fields[k]) for k in _CAPACITIES + _CLUSTERS},
        alpha=float(fields["alpha"]),
        name=str(fields.get("name", "platform")),
        substrate=None if sub is None else substrate_from_fields(sub),
    )


def plan_from_fields(fields: Mapping[str, Any]) -> ExecutionPlan:
    """An :class:`ExecutionPlan` from ``x``, ``y`` and ``meta``."""
    return ExecutionPlan(x=np.asarray(fields["x"]), y=np.asarray(fields["y"]),
                         meta=str(fields.get("meta", "")))


def lm_params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                         dtype: Optional[torch.dtype] = None,
                         device=None) -> dict:
    """The port's parameters of ``cfg`` from the reference's parameter tree
    as numpy arrays.  The port keeps the reference's layout, ``groups``
    stacked on a leading axis included, so each leaf maps one to one.  With
    ``dtype``, float leaves but ``final_norm``'s are cast to it (the
    compute dtype, cast once); ``device`` defaults to the process default.
    """
    dev = resolve_device(device)
    expected = {"embed", "groups", "final_norm"}
    if cfg.tail:
        expected.add("tail")
    if not cfg.tie_embeddings:
        expected.add("unembed")
    if set(tree) != expected:
        raise ValueError(f"{cfg.name}: parameter tree has {sorted(tree)}, "
                         f"expected {sorted(expected)}")

    def convert(node, top):
        if isinstance(node, Mapping):
            return {k: convert(v, top) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))
        if dtype is not None and t.is_floating_point() and top != "final_norm":
            t = t.to(dtype)
        return t.to(dev)

    return {k: convert(v, k) for k, v in tree.items()}


def train_state_from_numpy(cfg: ArchConfig, state_tree: Any,
                           device=None) -> TrainState:
    """The port's :class:`~repro_torch.train.train_step.TrainState` from
    the reference's, as numpy arrays (``jax.tree.map(np.asarray, state)``):
    params, ``opt.step``/``m``/``v`` and the residual on ``device``
    (default: the process default), in their stored dtypes; ``rng``'s two
    uint32 words on the CPU, where the port keeps them."""
    dev = resolve_device(device)

    def tree(t):
        return lm_params_from_numpy(cfg, t, device=dev)

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=dev)

    opt = state_tree.opt
    return TrainState(
        params=tree(state_tree.params),
        opt=AdamWState(step=scalar(opt.step), m=tree(opt.m), v=tree(opt.v)),
        residual=tree(state_tree.residual),
        rng=torch.from_numpy(np.array(state_tree.rng, dtype=np.uint32)),
        step=scalar(state_tree.step),
    )
