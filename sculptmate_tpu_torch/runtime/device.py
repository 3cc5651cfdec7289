"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``. Without a usable CUDA device they raise: they never fall
back to the CPU on their own.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on, the card by default. A card
    without an index is pinned to the current one's (``canonical``), so a
    model keeps naming the card it was made on when a device mesh later
    makes another card current."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return canonical(dev)


def device_scope(device: torch.device):
    """Make ``device`` the current CUDA device for the block (a no-op for the
    CPU), so a kernel launched through a raw library call, which runs on the
    current device, lands on the device its tensors are on."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device
    (``torch.device("cuda") != torch.device("cuda:0")`` although both name
    it)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d
