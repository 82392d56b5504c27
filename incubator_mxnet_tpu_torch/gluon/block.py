"""`Block` and `HybridBlock` of the PyTorch port: `torch.nn.Module`s with
the JAX package's Gluon surface.

Counterpart of `incubator_mxnet_tpu/gluon/block.py`. `Block` is the base
of every layer and model; `HybridBlock` is a `Block` whose `hybridize()`
flag is recorded. What carries over:

  * `collect_params(select)` returns {structural name: `gluon.Parameter`}
    under the JAX package's names (`features.4.0.body.1.gamma`): child
    blocks are registered under the names the JAX package gives them, and
    each Parameter holds its tensor in the block as a `torch.nn.Parameter`
    (trainable values) or a buffer (BatchNorm's running stats), so
    `named_parameters()` / `named_buffers()` give the same keys;
  * `initialize(init=None, device=None)` draws every value from a
    generator seeded with `seed` and the value's structural name, on the
    device (the card unless the caller asks for the CPU; without a card,
    the default raises). A value whose shape is not known yet (a layer
    built without `in_units` / `in_channels`) is drawn at the block's first
    forward, on the input's device, from the same generator;
  * `zero_grad()`, `cast()`, `setattr()`, `share_parameters()`,
    `reset_ctx()`, the `params` property (a block's own Parameters),
    `register_child()` / `register_block()`, `apply(fn)` (children first,
    then the block; torch's `Module.apply` has that meaning already) and
    `summary(*inputs)` (the JAX package's table text);
  * `register_forward_pre_hook(hook)` / `register_forward_hook(hook)`:
    MXNet's signatures, `hook(block, args)` and `hook(block, args,
    output)`, are torch's, so these are torch's methods (their keyword
    options included; torch's machinery still sees every hook). The handle
    is a `torch.utils.hooks.RemovableHandle` that also has MXNet's
    `detach()`. A hook that returns a value replaces the input or output,
    as in torch; the JAX package ignores what a hook returns;
  * `save_parameters` / `load_parameters` / `load_dict` read and write the
    JAX package's `.npz` of structural names, with a channels-last
    convolution's weight kernel dims first (HWIO for NHWC), so a file
    written by either package loads in the other (`params_from_jax` is `load_dict` over the JAX package's arrays);
  * `hybridize()` records the flag and nothing else: the port runs
    eagerly (CUDA-graph capture of the step is later work);
  * training mode is `autograd.is_training()` (set by `autograd.record()`,
    `train_mode()`, and `FusedTrainStep`), not `torch.nn.Module.training`;
  * a block given NDArrays (`mx.np`) runs on their tensors and returns
    NDArrays; given tensors, it returns tensors;
  * a block called outside `autograd.record()` (and `FusedTrainStep`)
    records nothing: its forward runs under `torch.no_grad()`, so an
    inference `net(x)` keeps no activations and its flash attention takes
    the LSE-free forward (B5).
"""
from __future__ import annotations

import math
import re
from collections import OrderedDict

import numpy as np
import torch
from torch.utils.hooks import RemovableHandle

from .. import autograd
from ..base import MXNetError
from ..fault import atomic_output
from ..device import resolve_device
from ..ndarray import NDArray, _unwrap, _wrap
from .parameter import DeferredInitializationError, Parameter

__all__ = ["Block", "HybridBlock", "params_from_jax"]


def _wrap_tree(out):
    """Tensors in a block's output (tuples and lists too) as NDArrays."""
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if type(out) in (tuple, list):
        return type(out)(_wrap_tree(o) for o in out)
    return out


class _HookHandle(RemovableHandle):
    """torch's hook handle with MXNet's `detach()` beside `remove()`."""

    def __init__(self, handle):
        self.__dict__.update(vars(handle))

    def detach(self):
        self.remove()


class Block(torch.nn.Module):
    """Base class of the port's layers and models."""

    def __init__(self):
        super().__init__()
        self.training = False
        self._reg_params = OrderedDict()   # own name -> Parameter
        self._pending = False   # an own Parameter waits for its shape

    # ------------------------------------------------------------------
    # values
    # ------------------------------------------------------------------
    def _new_param(self, name, shape, init=None, grad_req="write",
                   memory_format=None):
        """Declare a Parameter (grad_req "write", "add" or "null"); a 0 in
        `shape` is a dimension the first forward infers."""
        p = Parameter(shape=shape, init=init, grad_req=grad_req, name=name,
                      memory_format=memory_format)
        self._adopt(name, p)
        return p

    def _new_state(self, name, shape, init=None):
        """Declare non-trainable state (a buffer Parameter, grad_req
        "null")."""
        p = Parameter(shape=shape, init=init, grad_req="null", name=name,
                      state=True)
        self._adopt(name, p)
        return p

    def _adopt(self, name, p):
        old = self._reg_params.get(name)
        if old is not None and old is not p:
            old._owners = [o for o in old._owners if o != (self, name)]
        self._reg_params[name] = p
        p._register(self, name)

    def collect_params(self, select=None):
        """OrderedDict of structural name -> Parameter: each block's own
        values in declaration order, then its children's, as the JAX
        package lists them. `select` is a regular expression the names
        must match."""
        pat = re.compile(select) if select else None
        out = OrderedDict()
        for name, p in self._iter_params(""):
            p._structural_name = name
            if pat is None or pat.match(name):
                out[name] = p
        return out

    @property
    def params(self):
        """This block's own Parameters, {name: Parameter} (its children's
        are not included; `collect_params()` gives them all)."""
        return dict(self._reg_params)

    def register_child(self, block, name=None):
        """Register `block` as a child under `name` (default: the number
        of children so far)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    register_block = register_child

    def _iter_params(self, prefix):
        for name, p in self._reg_params.items():
            yield prefix + name, p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                yield from child._iter_params(prefix + cname + ".")

    def _owner(self, structural_name):
        blk = self
        parts = structural_name.split(".")
        for part in parts[:-1]:
            blk = blk._modules[part]
        return blk, parts[-1]

    # ------------------------------------------------------------------
    # deferred shapes
    # ------------------------------------------------------------------
    def infer_shape(self, *args):
        """Fill the unknown dimensions of the own Parameters from the
        inputs; layers that declare such Parameters override it."""
        raise MXNetError(f"{type(self).__name__} has parameters with "
                         f"unknown shape but does not implement "
                         f"infer_shape(*inputs)")

    def _resolve(self, *args):
        """Infer and draw the own deferred Parameters from the first
        input, on its device."""
        pending = [p for p in self._reg_params.values()
                   if p._deferred_init is not None]
        if pending:
            self.infer_shape(*args)
            dev = next((a.device for a in args
                        if isinstance(a, torch.Tensor)), None)
            for p in pending:
                p._finish_deferred_init(dev)
        self._pending = False

    def __call__(self, *args, **kwargs):
        # NDArrays in, NDArrays out: the forward runs on their tensors
        if any(type(a) is NDArray for a in args) or any(
                type(v) is NDArray for v in kwargs.values()):
            return _wrap_tree(self.__call__(*_unwrap(args),
                                            **_unwrap(kwargs)))
        if self._pending:
            self._resolve(*args)
        # outside record() (and FusedTrainStep's scope) nothing is taped,
        # as in the JAX package: the outermost call turns grad mode off, so
        # nested calls see it off and add no work
        if torch.is_grad_enabled() and not autograd.is_taping():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def initialize(self, init=None, device=None, seed=0, force_reinit=False):
        """Draw every value on `device` (default: the card). Each value's
        own initializer wins over `init` (default `Uniform()`); each draw
        comes from a generator seeded with `seed` and the value's
        structural name. Values already drawn stay unless `force_reinit`;
        values of unknown shape wait for the first forward. Returns
        self."""
        dev = resolve_device(device)
        for _, p in self.collect_params().items():
            p.initialize(init=None, device=dev, default_init=init,
                         force_reinit=force_reinit, seed=seed)
        _refresh_pending(self)
        return self

    def hybridize(self, active=True, **kwargs):
        """Record the flag on the hybrid blocks among this block and its
        children. The port runs eagerly; nothing is compiled."""
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._active = bool(active)
        return self

    def reset_ctx(self, device):
        """Move every drawn value to `device`."""
        dev = resolve_device(device)
        for p in self.collect_params().values():
            p.reset_ctx(dev)

    reset_device = reset_ctx

    # ------------------------------------------------------------------
    # hooks: MXNet's hook signatures are torch's
    # ------------------------------------------------------------------
    def register_forward_pre_hook(self, hook, *args, **kwargs):
        """Call `hook(block, args)` before each forward; returns a handle
        with `detach()` (and torch's `remove()`)."""
        return _HookHandle(super().register_forward_pre_hook(
            hook, *args, **kwargs))

    def register_forward_hook(self, hook, *args, **kwargs):
        """Call `hook(block, args, output)` after each forward; returns a
        handle with `detach()` (and torch's `remove()`)."""
        return _HookHandle(super().register_forward_hook(
            hook, *args, **kwargs))

    def summary(self, *inputs):
        """Run `self(*inputs)` and print (and return) one row per block as
        its forward ends: its type, its output's shape and the sizes of its
        own Parameters, then the total."""
        rows = []

        def _hook(block, ins, outs):
            o = outs[0] if isinstance(outs, (list, tuple)) else outs
            n_params = sum(math.prod(p.shape or ())
                           for p in block._reg_params.values()
                           if p.shape is not None)
            rows.append((type(block).__name__,
                         tuple(getattr(o, "shape", ())), n_params))

        handles = [b.register_forward_hook(_hook) for b in self.modules()
                   if isinstance(b, Block)]
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        total = sum(r[2] for r in rows)
        lines = [f"{'Layer':<28}{'Output shape':<24}{'Params':>12}",
                 "-" * 64]
        lines += [f"{n:<28}{str(s):<24}{p:>12}" for n, s, p in rows]
        lines += ["-" * 64, f"{'Total params':<52}{total:>12}"]
        print("\n".join(lines))
        return "\n".join(lines)

    def zero_grad(self):
        """Zero every Parameter's gradient buffer."""
        for p in self.collect_params().values():
            p.zero_grad()

    def cast(self, dtype):
        """Cast every Parameter to `dtype` ("float32", "bfloat16",
        "float16"). Returns self."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def setattr(self, name, value):
        """Set an attribute on every Parameter
        (`net.setattr("grad_req", "null")`)."""
        for p in self.collect_params().values():
            setattr(p, name, value)

    def share_parameters(self, shared):
        """Adopt the Parameters of `shared` ({structural name: Parameter})
        under the same names; the blocks then hold one tensor. Returns
        self."""
        own = self.collect_params()
        for name, p in shared.items():
            if name in own:
                blk, leaf = self._owner(name)
                blk._adopt(leaf, p)
        return self

    # ------------------------------------------------------------------
    # save / load: the JAX package's .npz of structural names
    # ------------------------------------------------------------------
    def _kernel_first(self, name, t):
        """True for a channels-last convolution's weight, which the JAX
        package keeps kernel dims first: (*k, I/g, O), or (*k, O/g, I)
        for a transposed one, where the port keeps (O, I/g, *k) and
        (I, O/g, *k)."""
        blk, leaf = self._owner(name)
        return (t.dim() >= 3 and leaf == "weight"
                and getattr(blk, "_hwio_weight", False))

    def _file_layout(self, name, t):
        """A value as the JAX package stores it: a channels-last
        convolution's weight kernel dims first, bfloat16 as float32."""
        t = t.detach().cpu()
        if self._kernel_first(name, t):
            t = t.permute(*range(2, t.dim()), 1, 0)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.ascontiguousarray(t.numpy())

    def _own_layout(self, name, a):
        v = torch.from_numpy(np.array(a, copy=True))
        if self._kernel_first(name, v):
            n = v.dim()
            v = v.permute(n - 1, n - 2, *range(n - 2))
        return v

    def save_parameters(self, filename, deduplicate=False):
        """Write every drawn value to `filename` (`.npz`), atomically."""
        payload, seen = {}, set()
        for name, p in self.collect_params().items():
            if p._data is None or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            payload[name] = self._file_layout(name, p._data)
        with atomic_output(filename) as f:
            np.savez(f, **payload)

    def load_parameters(self, filename, device=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Load a file `save_parameters` (of either package) wrote."""
        with np.load(filename, allow_pickle=False) as f:
            loaded = {k: f[k] for k in f.files}
        self.load_dict(loaded, device=device, allow_missing=allow_missing,
                       ignore_extra=ignore_extra, cast_dtype=cast_dtype,
                       _where=f"file {filename}")

    def load_dict(self, param_dict, device=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False, _where="dict"):
        """Set values from {structural name: array} in the file layout;
        a value not drawn yet is created on `device` (default: the device
        given to `initialize`, else the card)."""
        params = self.collect_params()
        if not ignore_extra:
            extra = sorted(set(param_dict) - set(params))
            if extra:
                raise MXNetError(f"{_where} contains extra parameters "
                                 f"{extra}")
        dev = None if device is None else resolve_device(device)
        for name, p in params.items():
            if name not in param_dict:
                if not allow_missing:
                    raise MXNetError(f"parameter {name} missing in {_where}")
                continue
            a = np.asarray(param_dict[name])
            if cast_dtype and p.dtype != "bfloat16":
                a = a.astype(p.dtype)
            v = self._own_layout(name, a)
            p.shape = tuple(v.shape)
            p.set_data(v, device=dev)
        _refresh_pending(self)


class HybridBlock(Block):
    """A Block whose `hybridize()` flag is recorded (the port runs every
    block eagerly)."""

    def __init__(self):
        super().__init__()
        self._active = False


def _refresh_pending(net):
    """Mark each block of `net` that holds a Parameter still waiting for
    its shape."""
    for m in net.modules():
        if isinstance(m, Block):
            m._pending = any(q._deferred_init is not None
                             for q in m._reg_params.values())


def params_from_jax(net, params_np):
    """Copy the JAX package's values into a port net.

    `params_np`: {structural name: numpy array}, as the JAX package's
    `{name: p.data().asnumpy() for name, p in net.collect_params().items()}`
    gives them. A channels-last convolution's weight comes kernel dims
    first (HWIO for NHWC, (*k, I/g, O) for NWC and NDHWC, (*k, O/g, I) for
    a transposed one) and is stored as the port's (O, I/g, *k) or
    (I, O/g, *k); a channels-first net's weight and every other value keep
    their layout (a Dense weight
    (units, in_units), an Embedding or PositionalEmbedding table, a
    LayerNorm's gamma and beta). Values are cast to each Parameter's
    dtype. Unknown names, missing names and shape mismatches raise
    `MXNetError`; so does a net not initialized."""
    own = net.collect_params()
    unknown = sorted(set(params_np) - set(own))
    missing = sorted(set(own) - set(params_np))
    if unknown or missing:
        raise MXNetError(f"params_from_jax: unknown names {unknown[:5]}, "
                         f"missing names {missing[:5]}")
    for name, p in own.items():
        if p._data is None and p._deferred_init is None:
            raise MXNetError("params_from_jax: initialize the net first")
        v = net._own_layout(name, np.array(params_np[name],
                                           dtype=np.float32))
        try:
            p.shape = tuple(v.shape)
        except MXNetError:
            raise MXNetError(f"params_from_jax: {name} has shape "
                             f"{tuple(np.shape(params_np[name]))}, the "
                             f"port's {tuple(p.shape)}") from None
        if p._data is not None and tuple(v.shape) != tuple(p._data.shape):
            raise MXNetError(f"params_from_jax: {name} has shape "
                             f"{tuple(np.shape(params_np[name]))}, the "
                             f"port's {tuple(p._data.shape)}")
        p.set_data(v)
    _refresh_pending(net)
    return net


__all__ += ["DeferredInitializationError", "Parameter"]
