"""The op registry and the one dispatch point of the array frontend.

Counterpart of `incubator_mxnet_tpu/ops/registry.py`. Every `mx.np`,
`mx.npx` and NDArray op goes through `invoke(fn, args, name)`, which

  * unwraps NDArrays to their tensors (a numpy array argument becomes a
    tensor on the device of the first NDArray argument);
  * applies AMP by op name, as the JAX package's dispatch does: the
    name lists first (`amp.lists`), then the op's registered class
    (`safe` -> the target dtype, `unsafe` -> float32), through
    `amp.cast_inputs`. Ops whose body casts already (the Gluon layers'
    ops of `ops.nn` and `ops.fused`, registered with `casts_inside=True`)
    are not cast twice;
  * runs `fn` under `torch.no_grad()` unless `autograd.is_taping()`
    (inside `record()` or `FusedTrainStep`'s scope), so nothing is taped
    outside `record()`, as in the JAX package;
  * wraps the tensor outputs as NDArrays (tuples and lists element by
    element);
  * counts itself in `dispatch_stats()`: "dispatch" (every call) and
    "eager_fallback" (calls run op by op: every call here), the names the
    JAX package's `ops/segment.py` `DISPATCH_STATS` gives them.

The JAX package also defers eager ops into bulked segments and keeps a
per-key cache of jitted kernels; PyTorch runs each op as it is called, so
neither has a counterpart here and their counters are absent.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import amp as _amp
from .. import autograd
from ..base import MXNetError

__all__ = ["OpInfo", "register_op", "get_op", "list_ops", "apply_op",
           "record_key", "invoke", "dispatch_stats", "as_tensor"]

_OP_REGISTRY = {}
_STATS = {"dispatch": 0, "eager_fallback": 0}


def dispatch_stats(reset=False):
    """A snapshot of the dispatch counters; `reset` zeroes them."""
    snap = dict(_STATS)
    if reset:
        for k in _STATS:
            _STATS[k] = 0
    return snap


class OpInfo:
    """A registry entry: the op's name, function, AMP class ("safe",
    "unsafe" or "neutral"), docstring, and whether its body casts under
    AMP itself (`casts_inside`)."""

    __slots__ = ("name", "fn", "amp", "doc", "casts_inside")

    def __init__(self, name, fn, amp="neutral", doc="", casts_inside=False):
        self.name = name
        self.fn = fn
        self.amp = amp
        self.doc = doc
        self.casts_inside = casts_inside


def register_op(name, fn=None, amp="neutral", doc="", casts_inside=False):
    """Register an op (decorator or direct call); ≙ NNVM_REGISTER_OP."""
    def _reg(f):
        _OP_REGISTRY[name] = OpInfo(name, f, amp, doc or (f.__doc__ or ""),
                                    casts_inside)
        return f
    if fn is not None:
        return _reg(fn)
    return _reg


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(_OP_REGISTRY)


def record_key(base_key, kwargs):
    """The JAX package's dispatch key of a record and call kwargs. The
    port keeps no kernel cache, so the key only names the call: (base
    key, sorted kwargs), or None when there is no base key."""
    if base_key is None:
        return None
    if not kwargs:
        return base_key
    return (base_key, tuple(sorted(kwargs.items(), key=lambda kv: kv[0])))


def apply_op(name, *args, **kwargs):
    """Call a registered op by name on NDArray or array arguments."""
    return get_op(name).fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
_NDArray = None
_wrap = None


def _lazy_init():
    global _NDArray, _wrap
    from ..ndarray import NDArray, _wrap as w
    _NDArray = NDArray
    _wrap = w


def as_tensor(x, device=None):
    """A numpy array (or scalar numpy value) as a tensor on `device` (None:
    the CPU) of its 32-bit type (float64 as float32, int64 as int32). The
    tensor never shares the numpy array's memory."""
    arr = _np.asarray(x)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    elif arr.dtype == _np.int64:
        arr = arr.astype(_np.int32)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device or "cpu", copy=True)


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o) for o in out) \
            if type(out) in (tuple, list) else out
    return out


_EMPTY = {}
_amp_state = _amp._state
_Tensor = torch.Tensor
_set_grad = torch._C._set_grad_enabled


def invoke(fn, args, name="", op=None, kwargs=None, wrap=True):
    """`fn(*tensors, **kwargs)` over `args` with NDArrays unwrapped, cast
    by the op's AMP policy, taped only inside `record()`; returns the
    outputs as NDArrays (`wrap=False`: as tensors).

    The hot path of every eager op: outside `record()` grad mode is turned
    off around `fn` only when an input requires a gradient (otherwise
    nothing can be taped anyway)."""
    if _NDArray is None:
        _lazy_init()
    _STATS["dispatch"] += 1
    _STATS["eager_fallback"] += 1
    raw = []
    dev = None
    grad_in = False
    host = False
    for a in args:
        if type(a) is _NDArray:
            a = a._t
            grad_in = grad_in or a.requires_grad
            if dev is None:
                dev = a.device
        elif type(a) is _np.ndarray:
            host = True
        raw.append(a)
    if host:
        raw = [as_tensor(a, dev) if type(a) is _np.ndarray else a
               for a in raw]
    if _amp_state["active"] and not (op is not None and op.casts_inside):
        raw = _amp.cast_inputs(name, "neutral" if op is None else op.amp,
                               *raw)
    if grad_in and not autograd.is_taping() and torch.is_grad_enabled():
        _set_grad(False)
        try:
            out = fn(*raw, **(kwargs or _EMPTY))
        finally:
            _set_grad(True)
    else:
        out = fn(*raw, **(kwargs or _EMPTY))
    if not wrap:
        return out
    if type(out) is _Tensor:
        nd = _new(_NDArray)
        nd._t = out
        return nd
    return _wrap_out(out)


_new = object.__new__
