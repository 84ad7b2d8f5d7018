"""Structural input validators and the executor's runtime audits, on the
port.

* :mod:`repro_torch.analysis.validate` — a byte-identical copy of
  :mod:`repro.analysis.validate`, the input validators shared with the core
  model layers.
* :mod:`repro_torch.analysis.audit` — a byte-identical copy of
  :mod:`repro.analysis.audit`: conservation, snapshot and determinism
  audits of the port's discrete-event executor
  (``python -m repro_torch.analysis``).

The repo-specific lint stays in the reference package
(``python -m repro.analysis --lint-only``); it walks every file under
``src/``, the port's included.

``validate`` is imported eagerly (a numpy-only leaf that
:mod:`repro_torch.core` itself depends on); ``audit`` is exposed lazily
because it imports the executor, which would otherwise close an import
cycle through this package.
"""
from __future__ import annotations

from . import validate  # noqa: F401  (numpy-only leaf)

__all__ = ["audit", "validate"]


def __getattr__(name):
    if name == "audit":
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
