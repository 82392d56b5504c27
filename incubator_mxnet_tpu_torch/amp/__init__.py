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
The target dtype is bfloat16 or float16; every CUDA kernel of the port
takes both.

Dynamic loss scaling for float16 acts on a `gluon.Trainer`, as the JAX
package's does:

  amp.init("float16")            activate (process-wide)
  amp.init_trainer(trainer)      attach a LossScaler
  with amp.scale_loss(loss, trainer) as scaled:
      autograd.backward(scaled)  # the trainer divides the scale back out
  amp.step_with_overflow_check(trainer, batch_size)  # skips on inf/nan
  amp.uninit()                   deactivate
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..base import MXNetError
from .lists import BF16_FUNCS, FP32_FUNCS

__all__ = ["init", "uninit", "is_active", "target_dtype", "amp_dtype_for",
           "op_dtype", "cast_inputs", "all_finite", "LossScaler",
           "init_trainer", "scale_loss", "step_with_overflow_check",
           "BF16_FUNCS", "FP32_FUNCS"]

_state = {"active": False, "target_dtype": "bfloat16"}

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def init(target_dtype="bfloat16"):
    """Activate autocast (as `amp.init` of the JAX package, with its
    default op lists)."""
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError(f"target_dtype must be bfloat16 or float16; got "
                         f"{target_dtype!r}")
    _state["active"] = True
    _state["target_dtype"] = target_dtype


def uninit():
    _state["active"] = False


def is_active():
    return _state["active"]


def target_dtype():
    """The autocast target dtype name ("bfloat16" or "float16")."""
    return _state["target_dtype"]


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


# ---------------------------------------------------------------------------
# loss scaling (the JAX package's amp.scale_loss + dynamic LossScaler)
# ---------------------------------------------------------------------------
def all_finite(tensors):
    """True iff every element of every tensor is finite (one device scan,
    one host read)."""
    flags = [torch.isfinite(t).all() for t in tensors]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


class LossScaler:
    """Dynamic loss scaler: x2 after `scale_window` good steps in a row, /2
    (never below 1) on an overflow, whose update is skipped."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """Scan the gradients of `params` (gluon `Parameter`s); adjust the
        scale; True when one of them is not finite."""
        grads = [p.grad() for p in params
                 if p.grad_req != "null" and p._data is not None]
        if not grads:
            return False
        if not all_finite(grads):
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._unskipped >= self._window:
            self.loss_scale *= self._factor
            self._unskipped = 0
        return False


def init_trainer(trainer):
    """Attach a `LossScaler` to a `gluon.Trainer`."""
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_scale = trainer._scale


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: autograd.backward(scaled)``

    Scales the loss up by the trainer's loss scale; `trainer.step` divides
    the gradients back down (its rescale_grad absorbs 1/scale)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def step_with_overflow_check(trainer, batch_size):
    """`trainer.step(batch_size)`, skipped (the gradients marked consumed,
    the weights untouched) when a gradient overflowed. Returns whether the
    step ran."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is not None and scaler.has_overflow(trainer._params):
        trainer._mark_consumed()
        return False
    trainer.step(batch_size)
    return True
