"""`HybridBlock` of the PyTorch port: a `torch.nn.Module` with the JAX
package's Gluon surface.

Counterpart of `incubator_mxnet_tpu/gluon/block.py`. What carries over:

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
  * `zero_grad()`, `cast()`, `setattr()`, `share_parameters()`;
  * `save_parameters` / `load_parameters` / `load_dict` read and write the
    JAX package's `.npz` of structural names, with an NHWC convolution's
    4-D weight in HWIO, so a file written by either package loads in the
    other (`params_from_jax` is `load_dict` over the JAX package's arrays);
  * `hybridize()` records the flag and nothing else: the port runs
    eagerly (CUDA-graph capture of the step is later work);
  * training mode is `autograd.is_training()` (set by `autograd.record()`,
    `train_mode()`, and `FusedTrainStep`), not `torch.nn.Module.training`;
  * a block called outside `autograd.record()` (and `FusedTrainStep`)
    records nothing: its forward runs under `torch.no_grad()`, so an
    inference `net(x)` keeps no activations and its flash attention takes
    the LSE-free forward (B5).
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, atomic_output
from ..device import resolve_device
from .parameter import DeferredInitializationError, Parameter

__all__ = ["HybridBlock", "params_from_jax"]


class HybridBlock(torch.nn.Module):
    """Base class of the port's layers and models."""

    def __init__(self):
        super().__init__()
        self.training = False
        self._reg_params = OrderedDict()   # own name -> Parameter
        self._pending = False   # an own Parameter waits for its shape
        self._active = False

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

    def _iter_params(self, prefix):
        for name, p in self._reg_params.items():
            yield prefix + name, p
        for cname, child in self._modules.items():
            if isinstance(child, HybridBlock):
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
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._pending = any(p._deferred_init is not None
                                 for p in m._reg_params.values())
        return self

    def hybridize(self, active=True, **kwargs):
        """Record the flag on this block and its children. The port runs
        eagerly; nothing is compiled."""
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._active = bool(active)
        return self

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
    def _file_layout(self, name, t):
        """A value as the JAX package stores it: an NHWC convolution's
        (O, I, kh, kw) weight as HWIO, bfloat16 as float32."""
        blk, leaf = self._owner(name)
        t = t.detach().cpu()
        if t.dim() == 4 and leaf == "weight" and getattr(blk, "_hwio_weight",
                                                         False):
            t = t.permute(2, 3, 1, 0)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.ascontiguousarray(t.numpy())

    def _own_layout(self, name, a):
        blk, leaf = self._owner(name)
        v = torch.from_numpy(np.array(a, copy=True))
        if v.dim() == 4 and leaf == "weight" and getattr(blk, "_hwio_weight",
                                                         False):
            v = v.permute(3, 2, 0, 1)      # HWIO -> (O, I, kh, kw)
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
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._pending = any(q._deferred_init is not None
                                 for q in m._reg_params.values())


def params_from_jax(net, params_np):
    """Copy the JAX package's values into a port net.

    `params_np`: {structural name: numpy array}, as the JAX package's
    `{name: p.data().asnumpy() for name, p in net.collect_params().items()}`
    gives them. A 4-D convolution weight comes in HWIO (the JAX package's
    NHWC layout) and is stored as the port's (O, I, kh, kw); an NCHW net's
    OIHW weight and every other value keep their layout (a Dense weight
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
    for m in net.modules():
        if isinstance(m, HybridBlock):
            m._pending = any(q._deferred_init is not None
                             for q in m._reg_params.values())
    return net


__all__ += ["DeferredInitializationError", "Parameter"]
