"""NDArray: the array of the PyTorch port's frontend (`mx.nd`, `mx.np`).

Counterpart of `incubator_mxnet_tpu/ndarray/__init__.py`. An NDArray wraps
one `torch.Tensor`, as the JAX package's wraps one `jax.Array`. It is not a
`Tensor` subclass: `size`, `dtype`, `T`, `device`, `reshape`, `max` and
`grad` mean something else on a Tensor. Its `__torch_function__` unwraps,
so `torch.*` functions take it (and return tensors).

What carries over from the JAX package:

  * `dtype` is a numpy dtype (`base.BFLOAT16`, equal to "bfloat16", for
    bfloat16 arrays); arrays made from 64-bit sources hold the 32-bit type;
  * basic indexing returns a view that writes through to its base, and the
    base's writes reach the view (torch views do this natively); advanced
    indexing copies. `x[:] = y` copies y into x's storage;
  * `x += y` outside `record()` writes in place (through views) where the
    result keeps x's dtype and shape; otherwise, and always inside
    `record()` or under AMP, x takes the out-of-place result and its tape
    entry, as the JAX package's `_adopt` does;
  * `attach_grad` marks the array as a variable through
    `autograd.attach` (its gradient lands in the buffer `grad` returns),
    `backward()` on a per-sample head seeds ones, and a head computed
    outside `record()` raises;
  * `asnumpy` copies to the host (bfloat16 widened to float32: numpy has no
    bfloat16 without `ml_dtypes`); `wait_to_read` synchronizes the
    tensor's stream, `waitall` the card;
  * `save` / `load` use the JAX package's `.npz` layout, so a file written
    by either package loads in the other; `mx.nd.reshape` keeps the legacy
    0 / -1 / `reverse` magic.

Every op goes through `ops.registry.invoke` (AMP at dispatch, no taping
outside `record()`, the dispatch counters).
"""
from __future__ import annotations

import operator

import numpy as _np
import torch

from .. import amp as _amp
from .. import autograd
from ..base import (MXNetError, NARROW, from_torch_dtype, numeric_types,
                    to_torch_dtype)
from ..device import Device, as_device, resolve_device
from ..ops.registry import _STATS, as_tensor, invoke

__all__ = [
    "NDArray", "array", "zeros", "ones", "full", "empty", "arange",
    "zeros_like", "ones_like", "concat", "stack", "waitall", "save", "load",
    "from_numpy", "from_dlpack", "to_dlpack_for_read", "reshape",
]

# the frontend's `mx.np` module, set when it is imported (the methods
# delegate to its functions, so they dispatch under the same names)
_np_ops = None


def _mxnp():
    global _np_ops
    if _np_ops is None:
        from .. import numpy as m
        _np_ops = m
    return _np_ops


def _wrap(t):
    """Wrap a tensor without a copy (the dispatch path's constructor)."""
    nd = _new(NDArray)
    nd._t = t
    return nd


_new = object.__new__


def _unwrap(x):
    if type(x) is NDArray:
        return x._t
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _narrow(t):
    d = NARROW.get(t.dtype)
    return t if d is None else t.to(d)


def _tensor(source, device=None, dtype=None):
    """A tensor for `source` (an NDArray, a tensor, a numpy array, a list
    or a scalar) on `device` (None: a tensor's own device, else the
    current device) of `dtype` (None: the source's 32-bit type). A tensor
    that needs neither a move nor a cast is returned as it is."""
    want = None if dtype is None else to_torch_dtype(dtype)
    if type(source) is NDArray:
        source = source._t
    if isinstance(source, torch.Tensor):
        t = source if want is not None else _narrow(source)
        if device is not None:
            t = t.to(resolve_device(device))
        return t if want is None else t.to(want)
    dev = resolve_device(device)
    if want is not None and want != torch.bfloat16:
        np_dt = from_torch_dtype(want)
        arr = _np.asarray(source, dtype=np_dt)
    else:
        arr = _np.asarray(source)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            # bfloat16 numpy values (`ml_dtypes`), as raw bits
            t = torch.from_numpy(arr.view(_np.int16).copy()).view(
                torch.bfloat16)
            return t.to(dev) if want is None else t.to(dev).to(want)
    t = as_tensor(arr, dev)
    return t if want is None else t.to(want)


class NDArray:
    """Multi-dimensional array on a device (≙ mxnet.nd.NDArray)."""

    __slots__ = ("_t", "__weakref__")

    # win against numpy in mixed dunder dispatch
    __array_priority__ = 1000.0

    def __init__(self, source_array=None, device=None, dtype=None):
        self._t = _tensor(source_array, device, dtype)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap(args), **_unwrap(kwargs or {}))

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return from_torch_dtype(self._t.dtype)

    @property
    def size(self):
        return self._t.numel()

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def itemsize(self):
        return self._t.element_size()

    @property
    def T(self):
        return self.transpose()

    @property
    def device(self):
        return as_device(self._t.device)

    ctx = device
    context = device

    @property
    def stype(self):
        """Storage type: dense only here (`ndarray.sparse` is ROADMAP
        A12)."""
        return "default"

    @property
    def grad(self):
        """The gradient buffer of a variable (an NDArray over the same
        storage), or None."""
        g = self._t.grad
        return None if g is None else _wrap(g)

    # ------------------------------------------------------------------
    # host copies and synchronization
    # ------------------------------------------------------------------
    def asnumpy(self):
        """A host copy (bfloat16 as float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
        return a.copy() if self._t.device.type == "cpu" else a

    def item(self):
        return self._t.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def wait_to_read(self):
        """Block until the work queued on the tensor's stream is done
        (≙ NDArray.WaitToRead)."""
        if self._t.device.type == "cuda":
            torch.cuda.current_stream(self._t.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, **kwargs):
        return self._t.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._t.__dlpack_device__()

    # ------------------------------------------------------------------
    # conversion and movement
    # ------------------------------------------------------------------
    def astype(self, dtype, copy=True):
        dt = to_torch_dtype(dtype)
        if not copy and self._t.dtype == dt:
            return self
        return invoke(_astype, (self,), name="astype", kwargs={"dt": dt})

    def copy(self):
        return invoke(torch.clone, (self,), name="copy")

    def copyto(self, other):
        """Copy into `other` (an NDArray: in place, cast to its dtype) or
        onto a device (≙ CopyFromTo)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._t.copy_(self._t)
            return other
        if isinstance(other, (Device, str, torch.device)):
            return _wrap(self._t.to(resolve_device(other), copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, device):
        dev = resolve_device(device)
        if dev == self._t.device:
            return self
        return _wrap(self._t.to(dev))

    as_in_ctx = as_in_context
    to_device = as_in_context

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    def detach(self):
        return _wrap(self._t.detach())

    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable whose gradient lands in a zeroed
        buffer (`grad`), per `grad_req` (≙ attach_grad /
        Imperative::MarkVariables). A result of recorded ops becomes a
        fresh leaf over the same storage."""
        t = self._t
        if not t.is_leaf:
            t = self._t = t.detach()
        autograd.attach(t, grad_req,
                        None if grad_req == "null" else torch.zeros_like(t))

    def drop_grad(self):
        self._t = self._t.detach()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Backpropagate from this head (seeded with ones when `out_grad`
        is None, whatever its shape)."""
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # shape and reductions (numpy's argument names; `mx.np` does the work)
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """numpy semantics: -1 infers, 0 is a literal zero-size dim (the
        legacy copy-dim 0 is `mx.nd.reshape`)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if 0 in shape and self.size != 0:
            raise MXNetError(
                f"cannot reshape array of size {self.size} into shape "
                f"{shape}: 0 is a literal zero-size dim under np semantics; "
                f"for the legacy 0=copy-dim magic use mx.nd.reshape(a, "
                f"shape)")
        return _mxnp().reshape(self, shape)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _mxnp().transpose(self, axes or None)

    def swapaxes(self, a1, a2):
        return _mxnp().swapaxes(self, a1, a2)

    def flatten(self):
        """Collapse all axes but the first (MXNet's Flatten)."""
        return self.reshape((self.shape[0], -1) if self.ndim > 1 else (-1,))

    def squeeze(self, axis=None):
        return _mxnp().squeeze(self, axis)

    def expand_dims(self, axis):
        return _mxnp().expand_dims(self, axis)

    def broadcast_to(self, shape):
        return _mxnp().broadcast_to(self, shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def repeat(self, repeats, axis=None):
        return _mxnp().repeat(self, repeats, axis)

    def tile(self, reps):
        return _mxnp().tile(self, reps)

    def split(self, indices_or_sections, axis=0):
        return _mxnp().split(self, indices_or_sections, axis)

    def sum(self, axis=None, keepdims=False, dtype=None):
        return _mxnp().sum(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        return _mxnp().mean(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False):
        return _mxnp().max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _mxnp().min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return _mxnp().prod(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, keepdims=False, ddof=0):
        return _mxnp().std(self, axis=axis, keepdims=keepdims, ddof=ddof)

    def var(self, axis=None, keepdims=False, ddof=0):
        return _mxnp().var(self, axis=axis, keepdims=keepdims, ddof=ddof)

    def argmax(self, axis=None):
        return _mxnp().argmax(self, axis=axis)

    def argmin(self, axis=None):
        return _mxnp().argmin(self, axis=axis)

    def cumsum(self, axis=None, dtype=None):
        return _mxnp().cumsum(self, axis=axis, dtype=dtype)

    def clip(self, a_min=None, a_max=None):
        return _mxnp().clip(self, a_min, a_max)

    def abs(self):
        return _mxnp().abs(self)

    def exp(self):
        return _mxnp().exp(self)

    def log(self):
        return _mxnp().log(self)

    def sqrt(self):
        return _mxnp().sqrt(self)

    def sign(self):
        return _mxnp().sign(self)

    def round(self):
        return _mxnp().round(self)

    def dot(self, other):
        return _mxnp().dot(self, other)

    def norm(self, ord=None, axis=None, keepdims=False):
        return _mxnp().linalg.norm(self, ord=ord, axis=axis,
                                   keepdims=keepdims)

    def take(self, indices, axis=None, mode="clip"):
        return _mxnp().take(self, indices, axis=axis, mode=mode)

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage types are ROADMAP A12 in the "
                             "port")
        return self

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        key, flips = _index(key, self._t)
        key = _ints_apart(_clamped(key, self._t.shape))
        return invoke(_getitem, (self,), name="getitem",
                      kwargs={"key": key, "flips": flips})

    def __setitem__(self, key, value):
        key, flips = _index(key, self._t)
        t = self._t
        if type(value) is NDArray:
            value = value._t
        elif not isinstance(value, (numeric_types, bool, torch.Tensor)):
            value = as_tensor(value)
        if isinstance(value, torch.Tensor):
            value = value.to(device=t.device, dtype=t.dtype)
        with torch.no_grad():
            if flips:
                target = t[key]
                value = torch.as_tensor(value, dtype=t.dtype,
                                        device=t.device).expand(
                    target.shape).flip(flips)
            t[key] = value

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------
    def _binop(self, other, name, fn, reflect=False):
        if type(other) is NDArray or isinstance(
                other, (numeric_types, bool, _np.ndarray)):
            a, b = (other, self) if reflect else (self, other)
            return invoke(fn, (a, b), name=name)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "add", _add)
    def __radd__(self, o): return self._binop(o, "add", _add, True)
    def __sub__(self, o): return self._binop(o, "subtract", _sub)
    def __rsub__(self, o): return self._binop(o, "subtract", _sub, True)
    def __mul__(self, o): return self._binop(o, "multiply", _mul)
    def __rmul__(self, o): return self._binop(o, "multiply", _mul, True)
    def __truediv__(self, o): return self._binop(o, "true_divide", _div)
    def __rtruediv__(self, o):
        return self._binop(o, "true_divide", _div, True)
    def __floordiv__(self, o):
        return self._binop(o, "floor_divide", _floordiv)
    def __rfloordiv__(self, o):
        return self._binop(o, "floor_divide", _floordiv, True)
    def __mod__(self, o): return self._binop(o, "mod", _mod)
    def __rmod__(self, o): return self._binop(o, "mod", _mod, True)
    def __pow__(self, o): return self._binop(o, "power", _pow)
    def __rpow__(self, o): return self._binop(o, "power", _pow, True)
    def __matmul__(self, o): return self._binop(o, "matmul", _matmul)
    def __rmatmul__(self, o):
        return self._binop(o, "matmul", _matmul, True)

    def _inplace(self, other, name, fn, method):
        """`x op= y`: in place outside record() (and AMP) where the result
        keeps x's dtype and shape, else x takes the result (and its tape
        entry)."""
        t = self._t
        o = other._t if type(other) is NDArray else other
        if (not autograd.is_taping() and not _amp.is_active()
                and isinstance(o, (numeric_types, bool, torch.Tensor))
                and torch.result_type(t, o) == t.dtype
                and (not isinstance(o, torch.Tensor)
                     or torch.broadcast_shapes(t.shape, o.shape)
                     == t.shape)):
            _STATS["dispatch"] += 1
            _STATS["eager_fallback"] += 1
            with torch.no_grad():
                getattr(t, method)(o)
            return self
        out = self._binop(other, name, fn)
        if out is NotImplemented:
            return out
        self._t = out._t
        return self

    def __iadd__(self, o): return self._inplace(o, "add", _add, "add_")
    def __isub__(self, o):
        return self._inplace(o, "subtract", _sub, "sub_")
    def __imul__(self, o):
        return self._inplace(o, "multiply", _mul, "mul_")
    def __itruediv__(self, o):
        return self._inplace(o, "true_divide", _div, "div_")

    def __neg__(self):
        return invoke(operator.neg, (self,), name="negative")

    def __abs__(self):
        return self.abs()

    def __eq__(self, o): return self._binop(o, "equal", operator.eq)
    def __ne__(self, o): return self._binop(o, "not_equal", operator.ne)
    def __lt__(self, o): return self._binop(o, "less", operator.lt)
    def __le__(self, o): return self._binop(o, "less_equal", operator.le)
    def __gt__(self, o): return self._binop(o, "greater", operator.gt)
    def __ge__(self, o): return self._binop(o, "greater_equal", operator.ge)

    def __invert__(self):
        return _mxnp().invert(self)

    def __and__(self, o): return _mxnp().bitwise_and(self, o)
    def __or__(self, o): return _mxnp().bitwise_or(self, o)
    def __xor__(self, o): return _mxnp().bitwise_xor(self, o)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self._t.reshape(-1)[0].item())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        if self.ndim == 0 and not self._t.is_floating_point() \
                and self._t.dtype != torch.bool:
            return int(self._t.item())
        raise TypeError("only integer scalar arrays can be converted to an "
                        "index")

    def __repr__(self):
        return f"{self.asnumpy()!r} <NDArray {self.shape} @{self.device}>"

    def __str__(self):
        return str(self.asnumpy())

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": self.dtype.name,
                "device": repr(self.device)}

    def __setstate__(self, state):
        self._t = _tensor(state["data"], "cpu", state.get("dtype"))


# the ops the dunders dispatch (64-bit results narrowed, as JAX computes in
# 32 bits: a bool array plus an int is int32)
def _add(a, b): return _narrow(a + b)
def _mul(a, b): return _narrow(a * b)
def _div(a, b): return _narrow(a / b)
def _floordiv(a, b): return _narrow(_int_by_zero(torch.floor_divide, a, b))
def _mod(a, b): return _narrow(_int_by_zero(torch.remainder, a, b))


def _int_by_zero(f, a, b):
    """f(a, b) for floor_divide, remainder or fmod, with XLA's answers where
    an integer divisor is 0 (PyTorch raises): a // 0 is -1 for a == 0 and
    -2 otherwise in a signed type, the type's highest value in an unsigned
    one; a % 0 is 0."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, device=a.device if isinstance(a, torch.Tensor)
                         else None)
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, device=b.device)
    if a.is_floating_point() or b.is_floating_point() or a.is_complex() \
            or b.is_complex() or torch.bool in (a.dtype, b.dtype):
        return f(a, b)
    zero = b == 0
    r = f(a, torch.where(zero, torch.ones_like(b), b))
    if f is not torch.floor_divide:
        return torch.where(zero, torch.zeros_like(r), r)
    info = torch.iinfo(r.dtype)
    fill = (torch.where(a == 0, -1, -2).to(r.dtype) if info.min < 0
            else torch.full_like(r, info.max))
    return torch.where(zero, fill, r)


def _pow(a, b):
    """a ** b, refusing a negative Python int exponent of an integer (or
    bool) array, as jnp.power's integer_pow does."""
    if isinstance(a, torch.Tensor) and type(b) is int and b < 0 \
            and not (a.is_floating_point() or a.is_complex()):
        raise TypeError(
            "Integers cannot be raised to negative powers, got "
            f"integer_pow({str(a.dtype).replace('torch.', '')}"
            f"{list(a.shape)}, {b})")
    return _narrow(a ** b)
def _matmul(a, b): return a @ b


def _sub(a, b):
    # torch refuses `-` on bools; JAX promotes a bool array to int32
    if getattr(a, "dtype", None) == torch.bool:
        a = a.to(torch.int32)
    if getattr(b, "dtype", None) == torch.bool:
        b = b.to(torch.int32)
    return _narrow(a - b)


def _astype(x, dt):
    return x.to(dt, copy=True)


def _getitem(x, key, flips):
    out = x[key]
    return out.flip(flips) if flips else out


def _as_nd(x, device=None, dtype=None):
    if type(x) is NDArray:
        return x
    return NDArray(x, device=device, dtype=dtype)


def _index(key, t):
    """`key` with NDArray, numpy and list parts as tensors on t's device,
    and, for a basic key, each negative-step slice as its positive-step
    twin plus the output dims to flip."""
    def conv(k):
        if type(k) is NDArray:
            return k._t
        if isinstance(k, (list, _np.ndarray)):
            a = _np.asarray(k)
            return torch.from_numpy(a if a.dtype == _np.bool_
                                    else a.astype(_np.int64)).to(t.device)
        if isinstance(k, _np.integer):
            return int(k)
        return k
    key = tuple(conv(k) for k in key) if isinstance(key, tuple) \
        else conv(key)
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return key, ()
    if not all(isinstance(k, (int, slice)) or k is None or k is Ellipsis
               for k in parts):
        raise MXNetError("a negative-step slice mixed with an array index "
                         "is not supported")
    n_real = sum(1 for k in parts if k is not None and k is not Ellipsis)
    out, flips, in_dim, out_dim = [], [], 0, 0
    for k in parts:
        if k is Ellipsis:
            skip = t.dim() - n_real
            in_dim += skip
            out_dim += skip
            out.append(k)
        elif k is None:
            out_dim += 1
            out.append(k)
        elif isinstance(k, int):
            in_dim += 1
            out.append(k)
        else:
            if k.step is not None and k.step < 0:
                idx = range(t.shape[in_dim])[k]
                k = slice(0, 0) if len(idx) == 0 else \
                    slice(idx[-1], idx[0] + 1, -k.step)
                flips.append(out_dim)
            out.append(k)
            in_dim += 1
            out_dim += 1
    return tuple(out), tuple(flips)


def _gathers(k):
    return ((isinstance(k, int) and not isinstance(k, bool))
            or (isinstance(k, torch.Tensor) and k.dtype != torch.bool))


def _ints_apart(key):
    """`key` with each Python int made an integer tensor when it and an
    array index are advanced indices apart from each other (a slice, an
    Ellipsis or None between them). numpy (and the JAX package) count such
    an int among the advanced indices, which then, being apart, put their
    broadcast axes first; PyTorch reads the int as a basic index and keeps
    the array's axes in place. A full tensor of the broadcast shape makes
    PyTorch read it numpy's way; other keys pass unchanged."""
    if not isinstance(key, tuple):
        return key
    arrays = [k for k in key if isinstance(k, torch.Tensor)]
    ints = [i for i, k in enumerate(key)
            if isinstance(k, int) and not isinstance(k, bool)]
    if not arrays or not ints:
        return key
    adv = [i for i, k in enumerate(key)
           if isinstance(k, torch.Tensor) or i in ints]
    if adv[-1] - adv[0] + 1 == len(adv):
        return key      # adjacent: both libraries keep the axes in place
    shape = torch.broadcast_shapes(*(
        (k.nonzero().shape[0],) if k.dtype == torch.bool else k.shape
        for k in arrays))
    dev = arrays[0].device
    return tuple(torch.full(shape, k, dtype=torch.int64, device=dev)
                 if i in ints else k for i, k in enumerate(key))


def _clamped(key, shape):
    """`key` with each integer index (a Python int or an integer tensor)
    read as XLA's gather reads it: negative from the end, then clamped into
    the axis, as the JAX package's `a[idx]` returns a row for any index
    (`ops.nn.clamp_index`). PyTorch would raise, and on the card assert."""
    parts = key if isinstance(key, tuple) else (key,)
    if not any(_gathers(k) for k in parts):
        return key
    from ..ops.nn import clamp_index
    # A bool mask spans as many axes as it has; any other index (an int,
    # an integer array of any rank, a slice) indexes one axis.
    used = sum(k.dim() if isinstance(k, torch.Tensor)
               and k.dtype == torch.bool else 1
               for k in parts if k is not None and k is not Ellipsis
               and not isinstance(k, bool))
    out, d = [], 0
    for k in parts:
        if k is Ellipsis:
            d += len(shape) - used
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            d += k.dim()
        elif k is not None and not isinstance(k, bool):
            if _gathers(k) and d < len(shape) and shape[d]:
                n = shape[d]
                if isinstance(k, torch.Tensor):
                    k = clamp_index(k, n)
                else:
                    k = min(max(k + n if k < 0 else k, 0), n - 1)
            d += 1
        out.append(k)
    return tuple(out) if isinstance(key, tuple) else out[0]


# ---------------------------------------------------------------------------
# creation and io (the mx.nd surface)
# ---------------------------------------------------------------------------
def array(source_array, device=None, dtype=None, ctx=None):
    """An NDArray of `source_array` on `device` (default: the current
    device, the card unless inside `with mx.cpu():`; without a card that
    raises). A tensor that needs no move or cast is wrapped without a
    copy."""
    return NDArray(source_array, device=device or ctx, dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, device=None, dtype=None, ctx=None, **kwargs):
    return _wrap(torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                             device=resolve_device(device or ctx)))


def ones(shape, device=None, dtype=None, ctx=None, **kwargs):
    return _wrap(torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                            device=resolve_device(device or ctx)))


def full(shape, val, device=None, dtype=None, ctx=None):
    return _wrap(torch.full(_shape(shape), val, dtype=to_torch_dtype(dtype),
                            device=resolve_device(device or ctx)))


def empty(shape, device=None, dtype=None, ctx=None):
    return zeros(shape, device=device or ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, device=None, dtype=None,
           ctx=None):
    """`start` to `stop` by `step`, float32 unless `dtype` says otherwise
    (the JAX package's default)."""
    if stop is None:
        start, stop = 0, start
    dev = resolve_device(device or ctx)
    dt = to_torch_dtype(dtype or "float32")
    n = max(int(_np.ceil((stop - start) / step)), 0)
    out = (start + step * torch.arange(n, dtype=torch.float64)).to(dt)
    if repeat != 1:
        out = out.repeat_interleave(repeat)
    return _wrap(out.to(dev))


def reshape(a, shape, reverse=False):
    """Legacy mx.nd.reshape with MXNet's magic values: 0 copies the input
    dim, -1 infers; `reverse=True` aligns the magic from the right."""
    if isinstance(shape, int):
        shape = (shape,)
    if reverse:
        in_rev = a.shape[::-1]
        shape = tuple(in_rev[i] if s == 0 else s
                      for i, s in enumerate(shape[::-1]))[::-1]
    else:
        shape = tuple(a.shape[i] if s == 0 else s
                      for i, s in enumerate(shape))
    return a.reshape(shape)


def zeros_like(a):
    return _wrap(torch.zeros_like(_as_nd(a)._t))


def ones_like(a):
    return _wrap(torch.ones_like(_as_nd(a)._t))


def concat(*arrays, dim=1):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return _mxnp().concatenate(arrays, axis=dim)


def stack(*arrays, axis=0):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return _mxnp().stack(arrays, axis=axis)


def waitall():
    """Block until every card has finished its queued work (≙
    Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def from_numpy(a, zero_copy=False):
    return NDArray(a)


def from_dlpack(capsule):
    return _wrap(torch.from_dlpack(capsule))


def to_dlpack_for_read(arr):
    return arr._t.detach().__dlpack__()


def save(fname, data):
    """Save an NDArray, a list or a dict of them in the JAX package's
    `.npz` layout (bfloat16 values as float32)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        payload = {f"arr_{i}": a.asnumpy() for i, a in enumerate(data)}
        payload["__mx_list__"] = _np.array(1)
    elif isinstance(data, dict):
        payload = {k: v.asnumpy() for k, v in data.items()}
    else:
        raise TypeError("save expects NDArray, list or dict")
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname, device=None):
    """Load what `save` (of either package) wrote: a list or a dict of
    NDArrays on `device` (default: the current device)."""
    with _np.load(fname, allow_pickle=False) as f:
        keys = [k for k in f.files if k != "__mx_list__"]
        if "__mx_list__" in f.files:
            keys.sort(key=lambda k: int(k.split("_")[1]))
            return [array(f[k], device=device) for k in keys]
        return {k: array(f[k], device=device) for k in keys}


def __getattr__(name):
    """mx.nd.<op>: the legacy namespace shares its ops with mx.np and
    mx.npx, as in the JAX package."""
    fn = getattr(_mxnp(), name, None)
    if fn is None:
        from .. import numpy_extension as _mxnpx
        fn = getattr(_mxnpx, name, None)
    if fn is None:
        raise AttributeError(f"module 'mx.nd' has no attribute {name!r}")
    globals()[name] = fn
    return fn
