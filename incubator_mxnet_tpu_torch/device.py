"""Devices of the PyTorch port: MXNet's `Device` / `Context` over
`torch.device`.

Counterpart of `incubator_mxnet_tpu/device.py`. The port's entry points
run on the card: the default device is `cuda`, and the CPU is used only
when a caller asks for it (`device="cpu"`, `mx.cpu()`, inside `with
mx.cpu():`, or `MXNET_DEFAULT_DEVICE=cpu(0)` as in the JAX package), as
the tests do. Asking for `cuda` where no card is present
raises in `resolve_device`, the one place that does; nothing falls back to
the CPU.

`gpu(i)` names card i. `tpu(i)` names the same card, as the JAX package's
`gpu(i)` names its accelerator, so scripts written for either run
unmodified. `with device:` sets the current device of the calling thread.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from .base import MXNetError, get_env

__all__ = ["Device", "Context", "cpu", "gpu", "tpu", "current_device",
           "current_context", "num_gpus", "num_tpus", "MemoryInfo",
           "device_memory_info", "gpu_memory_info", "default_device",
           "resolve_device"]

_state = threading.local()


class Device:
    """A named device with `with` scoping (≙ mxnet Context): "cpu" or
    "gpu" (the card; "tpu" is taken as its alias)."""

    _KINDS = ("cpu", "gpu", "tpu")

    def __init__(self, device_type="gpu", device_id=0):
        if isinstance(device_type, Device):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self._KINDS:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = "gpu" if device_type == "tpu" else device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        """The `torch.device` (unchecked: `resolve_device` checks)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()

    def __eq__(self, other):
        if isinstance(other, (str, torch.device)):
            try:
                other = as_device(other)
            except (MXNetError, RuntimeError):
                return False
        return (isinstance(other, Device)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


# MXNet 2.0 names the same object Context and Device
Context = Device


def cpu(device_id=0):
    return Device("cpu", device_id)


def gpu(device_id=0):
    """Card `device_id`."""
    return Device("gpu", device_id)


def tpu(device_id=0):
    """Card `device_id` (the JAX package's accelerator name)."""
    return Device("gpu", device_id)


def as_device(device):
    """A `Device` for a `Device`, a `torch.device` or a name ("cpu",
    "cuda", "cuda:1", "gpu(0)")."""
    if isinstance(device, Device):
        return device
    if isinstance(device, str) and "(" in device:
        kind, _, idx = device.partition("(")
        return Device(kind, int(idx.rstrip(")") or 0))
    dev = torch.device(device)
    if dev.type == "cpu":
        return cpu(0)
    if dev.type == "cuda":
        return gpu(dev.index or 0)
    raise MXNetError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


def _default_device():
    """`MXNET_DEFAULT_DEVICE` read as the JAX package reads it ("cpu",
    "cpu(N)", "gpu(N)" or "tpu(N)", the last two naming card N), else the
    card."""
    override = get_env("MXNET_DEFAULT_DEVICE")
    if override:
        kind, _, idx = override.partition("(")
        return Device(kind, int(idx.rstrip(")") or 0))
    return gpu(0)


def current_device():
    """The calling thread's device: the innermost `with device:`, else
    `MXNET_DEFAULT_DEVICE`, else the card."""
    stack = getattr(_state, "stack", None)
    if stack:
        return stack[-1]
    return _default_device()


current_context = current_device


def default_device():
    """The `torch.device` entry points use when the caller names none:
    the current device (the card outside any `with mx.cpu():`)."""
    return current_device().torch_device


def resolve_device(device=None):
    """`device` (None, a `Device`, a string or a `torch.device`) as a
    `torch.device`; None is the current device. A CUDA device always
    carries its index (the current card's when none is given), so threads
    can select it. Raises `MXNetError` for a CUDA device when PyTorch sees
    no card."""
    if device is None:
        dev = default_device()
    elif isinstance(device, Device):
        dev = device.torch_device
    elif isinstance(device, str) and "(" in device:
        dev = as_device(device).torch_device
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' (or mx.cpu()) to run on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def num_gpus():
    """The number of cards PyTorch sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


num_tpus = num_gpus


class MemoryInfo(NamedTuple):
    """`device_memory_info`'s result: free and total bytes, and whether
    they are known (False without a card: no data, not a full card)."""

    free: int
    total: int
    known: bool


def device_memory_info(device_id=0):
    """Free and total memory of card `device_id`
    (`torch.cuda.mem_get_info`); `known=False` with zeros without a
    card."""
    if not torch.cuda.is_available():
        return MemoryInfo(0, 0, False)
    free, total = torch.cuda.mem_get_info(device_id)
    return MemoryInfo(int(free), int(total), True)


gpu_memory_info = device_memory_info
