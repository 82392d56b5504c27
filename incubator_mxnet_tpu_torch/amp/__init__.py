"""Automatic mixed precision of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/amp/__init__.py` and of the AMP half of
its op dispatch (`ops/registry.py::_amp_dtype`). The same list-driven
policy: while AMP is active, each op of the port casts its floating-point
inputs on entry (`cast_inputs`) to the dtype its name or class asks for,

  * the name lists first (`lists.BF16_FUNCS` -> the target dtype,
    `lists.FP32_FUNCS` -> float32),
  * else the op's class: `safe` -> the target dtype, `unsafe` -> float32,
  * else the inputs keep their dtypes.

`torch.autocast` is not used: its op lists differ from these, and the
port must cast exactly where the JAX package casts. Master weights stay
float32 and are cast at use; a cast's backward casts the gradient back.

  amp.init("bfloat16")   activate (process-wide)
  amp.uninit()           deactivate
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .lists import BF16_FUNCS, FP32_FUNCS

__all__ = ["init", "uninit", "is_active", "amp_dtype_for", "op_dtype",
           "cast_inputs", "BF16_FUNCS", "FP32_FUNCS"]

_state = {"active": False, "target_dtype": "bfloat16"}

_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init(target_dtype="bfloat16"):
    """Activate autocast (as `amp.init` of the JAX package, with its
    default op lists). bfloat16 only: of the port's kernels only the pool
    takes float16 yet."""
    if target_dtype != "bfloat16":
        raise MXNetError("target_dtype must be bfloat16 (the port's kernels "
                         "other than the pool take float32 and bfloat16)")
    _state["active"] = True
    _state["target_dtype"] = target_dtype


def uninit():
    _state["active"] = False


def is_active():
    return _state["active"]


def amp_dtype_for(op_name):
    """The name-list policy alone: 'bfloat16', 'float32' or
    None (the lists do not know the op, or AMP is off)."""
    if not is_active():
        return None
    base = op_name.split(".")[-1]
    if base in BF16_FUNCS:
        return _state["target_dtype"]
    if base in FP32_FUNCS:
        return "float32"
    return None


def op_dtype(op_name, amp_class="neutral"):
    """The dtype name an op's float inputs take under the active policy:
    the name lists first, then the op's class; None leaves them alone."""
    dt = amp_dtype_for(op_name)
    if dt is None and is_active() and amp_class != "neutral":
        return _state["target_dtype"] if amp_class == "safe" else "float32"
    return dt


def cast_inputs(op_name, amp_class, *tensors):
    """`tensors` with every floating-point one cast to the op's AMP dtype
    (None and non-float entries pass through). Returns them as a tuple."""
    dt = op_dtype(op_name, amp_class)
    if dt is None:
        return tensors
    want = _TORCH[dt]
    return tuple(t.to(want) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != want else t
                 for t in tensors)
