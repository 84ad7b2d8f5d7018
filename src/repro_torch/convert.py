"""Carry the reference's state across into the port's objects.

The reference's platforms and plans arrive as plain dicts of numpy arrays
and scalars — the form :func:`dataclasses.asdict` gives of a
``repro.core.platform.Platform`` or ``repro.core.plan.ExecutionPlan``,
nested ``Substrate``, ``CapacityTrace`` and ``FailureTrace`` fields
included — so that this module needs nothing of the reference package.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from .core.plan import ExecutionPlan
from .core.platform import (
    CapacityTrace,
    FailureEvent,
    FailureTrace,
    Platform,
    Substrate,
)

__all__ = ["plan_from_fields", "platform_from_fields", "substrate_from_fields"]

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
