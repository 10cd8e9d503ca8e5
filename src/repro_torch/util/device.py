"""Explicit device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, or raise.

    Asking for CUDA on a machine without a usable card raises instead of
    carrying on quietly on the CPU; the CPU is used only when asked for,
    and so is the meta device (shapes without storage, the dry run's).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
