"""Where the port's entry points run: on the card unless told otherwise.

Every constructor of the port that takes a ``device`` resolves ``None`` to
the CUDA card.  A caller who wants the CPU passes ``device="cpu"``; on a
machine without CUDA the default raises PyTorch's own error, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "bind_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as
    ``torch.device`` reads it.  Touches no card."""
    return torch.device("cuda" if device is None else device)


def bind_device(device=None) -> torch.device:
    """The resolved device with its index filled in ("cuda" -> "cuda:0",
    the current card), so that it compares equal to a tensor's device.
    Raises PyTorch's own error where the device does not exist."""
    return torch.empty(0, device=resolve_device(device)).device
