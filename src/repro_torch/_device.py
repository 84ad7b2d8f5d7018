"""The process default device of the port.

Entry points that touch tensors take ``device=`` and fall back to the
process default, which starts as ``"cuda"``: the port runs on the card
unless the caller asks for the CPU.  Without CUDA, a request for the card
raises with the fix in the message; nothing continues on the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "set_default_device",
           "synchronize"]

DeviceLike = Union[str, torch.device]

_DEFAULT = {"device": torch.device("cuda")}


def set_default_device(device: DeviceLike) -> None:
    """Set the device every entry point uses when called without
    ``device=`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``)."""
    _DEFAULT["device"] = torch.device(device)


def default_device() -> torch.device:
    return _DEFAULT["device"]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """``device``, or the process default when ``None``; raises when the
    result is a CUDA device and CUDA is absent."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' or call repro_torch.set_default_device('cpu') "
            "to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait until ``device`` has finished its queued work (a no-op on the
    CPU): read a host clock after this, or it times the launches, not the
    work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
