"""Device selection for the PyTorch port.

Counterpart of `incubator_mxnet_tpu/device.py`. The port's entry points
run on the card: the default device is `cuda`, and the CPU is used only
when a caller asks for it (`device="cpu"`, as the tests do). Asking for
`cuda` where no card is present raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["default_device", "resolve_device"]


def default_device():
    """The device entry points use when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None):
    """`device` (None, a string or a `torch.device`) as a `torch.device`;
    a CUDA device always carries its index (the current device's when
    none is given), so threads can select it. Raises `MXNetError` for a
    CUDA device when PyTorch sees no card."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
