"""`HybridBlock` of the PyTorch port: a `torch.nn.Module` with the JAX
package's Gluon surface.

Counterpart of `incubator_mxnet_tpu/gluon/block.py`. What carries over:

  * `collect_params()` returns {structural name: tensor} under the JAX
    package's names (`features.4.0.body.1.gamma`): child blocks are
    registered under the names the JAX package gives them, trainable
    values are `nn.Parameter`s and non-trainable state (BatchNorm's running
    stats) buffers, so `named_parameters()`/`named_buffers()` give the
    same keys;
  * `initialize(init=None, device=None)` materializes every value from a
    seeded generator on the device (the card unless the caller asks for
    the CPU; without a card, the default raises);
  * `hybridize()` records the flag and nothing else: the port runs
    eagerly (CUDA-graph capture of the step is later work);
  * blocks start in predict mode (`training` False), as MXNet's forward
    does outside a training scope; `FusedTrainStep` switches the net to
    training mode for its step.

Channel counts are explicit: there is no deferred initialization, and a
block's values live on the `meta` device until `initialize()`.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import MXNetError
from ..device import resolve_device

__all__ = ["HybridBlock", "params_from_jax"]


class HybridBlock(torch.nn.Module):
    """Base class of the port's layers and models."""

    def __init__(self):
        super().__init__()
        self.training = False
        self._inits = {}         # own value name -> its initializer spec
        self._formats = {}       # own value name -> torch memory format
        self._active = False

    # ------------------------------------------------------------------
    # values
    # ------------------------------------------------------------------
    def _new_param(self, name, shape, init=None, grad_req="write",
                   memory_format=None):
        """Register a trainable value (grad_req 'write') or a frozen one
        ('null'), unmaterialized until `initialize()`."""
        if grad_req not in ("write", "null"):
            raise MXNetError(f"grad_req {grad_req!r} not supported "
                             f"('write' or 'null')")
        p = torch.nn.Parameter(torch.empty(shape, device="meta"),
                               requires_grad=grad_req == "write")
        p.lr_mult = 1.0
        p.wd_mult = 1.0
        self.register_parameter(name, p)
        self._inits[name] = init
        if memory_format is not None:
            self._formats[name] = memory_format
        return p

    def _new_state(self, name, shape, init=None):
        """Register non-trainable state (a buffer), unmaterialized."""
        self.register_buffer(name, torch.empty(shape, device="meta"))
        self._inits[name] = init

    def collect_params(self, select=None):
        """OrderedDict of structural name -> tensor: each block's own
        parameters, then its buffers, then its children's, in the order
        the JAX package lists them."""
        import re
        pat = re.compile(select) if select else None
        out = OrderedDict()
        for name, t in self._iter_values(""):
            if pat is None or pat.match(name):
                out[name] = t
        return out

    def _iter_values(self, prefix):
        for name, p in self._parameters.items():
            if p is not None:
                yield prefix + name, p
        for name, b in self._buffers.items():
            if b is not None:
                yield prefix + name, b
        for cname, child in self._modules.items():
            if isinstance(child, HybridBlock):
                yield from child._iter_values(prefix + cname + ".")

    def _owner(self, structural_name):
        blk = self
        parts = structural_name.split(".")
        for part in parts[:-1]:
            blk = blk._modules[part]
        return blk, parts[-1]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def initialize(self, init=None, device=None, seed=0, force_reinit=False):
        """Materialize every value on `device` (default: the card). Each
        value's own initializer wins over `init` (default `Uniform()`);
        each draw comes from a generator seeded with `seed` and the
        value's structural name. Values already materialized stay unless
        `force_reinit`. Returns self."""
        dev = resolve_device(device)
        default = init_mod.create(init)
        for name, t in self.collect_params().items():
            if t.device.type != "meta" and not force_reinit:
                continue
            blk, leaf = self._owner(name)
            spec = blk._inits.get(leaf)
            initializer = default if spec is None else init_mod.create(spec)
            gen = torch.Generator().manual_seed(
                (seed + zlib.crc32(name.encode("utf-8"))) & 0x7FFFFFFF)
            value = initializer(name, tuple(t.shape), gen).to(dev)
            fmt = blk._formats.get(leaf)
            if fmt is not None:
                value = value.contiguous(memory_format=fmt)
            if leaf in blk._parameters:
                old = blk._parameters[leaf]
                p = torch.nn.Parameter(value, requires_grad=old.requires_grad)
                p.lr_mult = getattr(old, "lr_mult", 1.0)
                p.wd_mult = getattr(old, "wd_mult", 1.0)
                blk._parameters[leaf] = p
            else:
                blk._buffers[leaf] = value
        return self

    def hybridize(self, active=True, **kwargs):
        """Record the flag on this block and its children. The port runs
        eagerly; nothing is compiled."""
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._active = bool(active)
        return self


def params_from_jax(net, params_np):
    """Copy the JAX package's values into a materialized port net.

    `params_np`: {structural name: numpy array}, as the JAX package's
    `{name: p.data().asnumpy() for name, p in net.collect_params().items()}`
    gives them. A 4-D convolution weight comes in HWIO (the JAX package's
    NHWC layout) and is stored as the port's (O, I, kh, kw); an NCHW net's
    OIHW weight and every other value keep their layout (a Dense weight
    (units, in_units), an Embedding or PositionalEmbedding table, a
    LayerNorm's gamma and beta). Unknown names,
    missing names and shape mismatches raise `MXNetError`."""
    own = net.collect_params()
    unknown = sorted(set(params_np) - set(own))
    missing = sorted(set(own) - set(params_np))
    if unknown or missing:
        raise MXNetError(f"params_from_jax: unknown names {unknown[:5]}, "
                         f"missing names {missing[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if t.device.type == "meta":
                raise MXNetError("params_from_jax: initialize the net first")
            a = np.array(params_np[name], dtype=np.float32)
            v = torch.from_numpy(a)
            blk, leaf = net._owner(name)
            if v.ndim == 4 and getattr(blk, "_hwio_weight", False) \
                    and leaf == "weight":
                v = v.permute(3, 2, 0, 1)      # HWIO -> (O, I, kh, kw)
            if tuple(v.shape) != tuple(t.shape):
                raise MXNetError(f"params_from_jax: {name} has shape "
                                 f"{tuple(a.shape)}, the port's "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(t.dtype))
    return net
