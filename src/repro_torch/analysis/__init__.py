"""Structural input validators shared with the core model layers (a
byte-identical copy of :mod:`repro.analysis.validate`).  The lint and the
executor audits stay in the reference package for now."""
from __future__ import annotations

from . import validate  # noqa: F401  (numpy-only leaf)

__all__ = ["validate"]
