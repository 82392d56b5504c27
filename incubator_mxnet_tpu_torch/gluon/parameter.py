"""`gluon.Parameter` of the PyTorch port: a trainable value with its
gradient request, learning-rate and weight-decay multipliers and deferred
initialization.

Counterpart of `incubator_mxnet_tpu/gluon/parameter.py`. A Parameter owns
one tensor and registers it in the block (or blocks, once shared) that
declared it: as a `torch.nn.Parameter` for a trainable value, as a buffer
for state such as BatchNorm's running statistics, so `named_parameters()`
and `named_buffers()` keep working. Until it is initialized the block
holds a `meta` tensor of the declared shape, 0 standing for a dimension
not known yet.

A shape with an unknown dimension defers the initialization: the block's
first forward infers the shape from its input and draws the value then,
on the input's device, from the same per-name seeded generator an eager
initialization would use, so a value does not depend on when it was
drawn. Accessing a deferred value raises `DeferredInitializationError`.

`grad_req` is "write", "add" or "null", with the semantics of
`autograd` (the Parameter's tensor is an autograd variable).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A Parameter's value was asked for before its shape is known."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


def _dtype(name):
    return name if isinstance(name, torch.dtype) else torch_dtype(name)


class Parameter:
    """A trainable (or, with grad_req "null", frozen) value."""

    def __init__(self, shape=None, dtype="float32", init=None,
                 grad_req="write", lr_mult=1.0, wd_mult=1.0, name=None,
                 memory_format=None, state=False):
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = str(dtype).replace("torch.", "")
        self.init = init
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self._grad_req = grad_req
        self._memory_format = memory_format
        self._state = state        # a buffer (running stats), not a weight
        self._data = None
        self._deferred_init = None  # (init, default_init, seed, device)
        self._name = name or "param"
        self._structural_name = None
        self._owners = []           # (block, attribute name) registering it
        # a sparse-gradient Embedding's weight: the index tensors of the
        # recorded forwards since the Trainer's last update (None: none)
        self._sparse_grad = False
        self._last_tokens = None

    # ------------------------------------------------------------------
    @property
    def name(self):
        return self._structural_name or self._name

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if new_shape is None:
            return
        if isinstance(new_shape, int):
            new_shape = (new_shape,)
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape)
                or any(s not in (0, -1, n)
                       for s, n in zip(self._shape, new_shape))):
            raise MXNetError(f"inferred shape {new_shape} incompatible with "
                             f"declared shape {self._shape} for parameter "
                             f"{self.name}")
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        self._grad_req = req
        if self._data is not None:
            self._install(self._data.detach())

    # ------------------------------------------------------------------
    # the tensor and the blocks that hold it
    # ------------------------------------------------------------------
    def _placeholder(self):
        """The unmaterialized value: a meta tensor of the declared shape
        (0 for an unknown dimension)."""
        shape = tuple(max(int(s), 0) for s in (self._shape or ()))
        return torch.empty(shape, dtype=_dtype(self.dtype), device="meta")

    def _wrap(self, value):
        if self._state:
            return value
        return torch.nn.Parameter(value, requires_grad=False)

    def _register(self, block, attr):
        """Hold this Parameter's tensor in `block` under `attr`."""
        if (block, attr) not in self._owners:
            self._owners.append((block, attr))
        t = self._data if self._data is not None \
            else self._wrap(self._placeholder())
        self._put(block, attr, t)

    def _put(self, block, attr, t):
        if self._state:
            block._buffers[attr] = t
        else:
            block._parameters[attr] = t

    def _install(self, value):
        """Make `value` this Parameter's tensor, in every block that holds
        it, as an autograd variable with the Parameter's grad_req."""
        if self._memory_format is not None and value.dim() == (
                5 if self._memory_format == torch.channels_last_3d else 4):
            value = value.contiguous(memory_format=self._memory_format)
        t = self._wrap(value)
        if not self._state:
            autograd.attach(t, self._grad_req)
        self._data = t
        self._deferred_init = None
        for block, attr in self._owners:
            self._put(block, attr, t)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def initialize(self, init=None, device=None, default_init=None,
                   force_reinit=False, seed=0):
        """Draw the value on `device` (a `torch.device`): `init`, else the
        Parameter's own initializer, else `default_init` (`Uniform()`).
        With a dimension unknown, the draw waits for the first forward."""
        if self._data is not None and not force_reinit:
            return
        if not _shape_known(self._shape):
            self._deferred_init = (init, default_init, seed, device)
            return
        self._finish_init(init, default_init, seed, device)

    def _finish_init(self, init, default_init, seed, device):
        spec = init if init is not None else self.init
        initializer = init_mod.create(spec if spec is not None
                                      else default_init)
        gen = torch.Generator().manual_seed(
            (seed + zlib.crc32(self.name.encode("utf-8"))) & 0x7FFFFFFF)
        value = initializer(init_mod.InitDesc(self.name), self._shape, gen)
        self._install(value.to(device=device, dtype=_dtype(self.dtype)))

    def _finish_deferred_init(self, device=None):
        """Draw a deferred value now that the shape is known, on `device`
        (the first input's), else the device given to `initialize`."""
        if self._deferred_init is None:
            return
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                f"parameter {self.name} shape {self._shape} still unknown")
        init, default_init, seed, dev = self._deferred_init
        self._finish_init(init, default_init, seed,
                          dev if device is None else device)

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter {self.name} has deferred init pending shape "
                f"inference (shape={self._shape})")
        raise MXNetError(f"parameter {self.name} has not been initialized; "
                         f"call .initialize() on the Block")

    def data(self, device=None):
        """The value (a tensor; `device` is accepted for the JAX package's
        signature: a Parameter lives on one device)."""
        self._check_initialized()
        return self._data

    def grad(self, device=None):
        """The gradient buffer (zeros until a backward writes it)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError(f"cannot get gradient of parameter {self.name}: "
                             f"grad_req='null'")
        t = self._data
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad

    def set_data(self, data, device=None):
        """Replace the value (a tensor or numpy array of the shape); on a
        Parameter not yet drawn this resolves a deferred shape and
        initializes it on `device` (default: the device given to
        `initialize`, else the card)."""
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if self._data is None:
            self.shape = tuple(data.shape)
            if device is None and self._deferred_init is not None:
                device = self._deferred_init[3]
            if device is None:
                from ..device import resolve_device
                device = resolve_device(None)
            self._install(data.detach().to(device=device,
                                           dtype=_dtype(self.dtype)).clone())
            return
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError(f"set_data shape {tuple(data.shape)} != "
                             f"parameter shape {tuple(self._data.shape)} for "
                             f"{self.name}")
        with torch.no_grad():
            self._data.copy_(data)

    def zero_grad(self):
        """Zero the gradient buffer."""
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    def cast(self, dtype):
        """Cast the value (and drop the gradient buffer) to `dtype`."""
        self.dtype = str(dtype).replace("torch.", "")
        if self._data is not None:
            self._install(self._data.detach().to(_dtype(self.dtype)))

    def reset_ctx(self, device):
        """Move the value to `device`."""
        if self._data is not None:
            self._install(self._data.detach().to(torch.device(device)))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A frozen value given at construction."""

    def __init__(self, value, name=None):
        value = np.asarray(value, dtype=np.float32) \
            if not isinstance(value, np.ndarray) else value
        self.value = value
        super().__init__(shape=value.shape, dtype=str(value.dtype),
                         init=_ConstInit(value), grad_req="null",
                         name=name or "const")


class _ConstInit(init_mod.Initializer):
    def __init__(self, value):
        super().__init__()
        self._value = value

    def __call__(self, name, shape, generator):
        return torch.from_numpy(np.array(self._value, copy=True))
