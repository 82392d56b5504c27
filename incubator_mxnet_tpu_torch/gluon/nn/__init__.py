"""gluon.nn of the PyTorch port: the layers ResNet and the transformer
blocks need.

Counterpart of `incubator_mxnet_tpu/gluon/nn/__init__.py`:
`HybridSequential`, `Conv2D`, `BatchNorm` (with `fused_forward`),
`BatchNormReLU`, `Activation`, `MaxPool2D`, `AvgPool2D`,
`GlobalAvgPool2D`, `Dense`, `Flatten`, `Dropout`, `LayerNorm` and
`Embedding`, and from `transformer`: `MultiHeadAttention`,
`TransformerEncoderCell`, `TransformerDecoderCell` and
`PositionalEmbedding`. They route
exactly as the JAX package's layers do: inside a fusion scope
(`ops.fused.fusion_enabled()`, which `FusedTrainStep` enters) a Dense or
Conv2D with bias and a fusable activation takes `fused.bias_act`, a
BatchNorm takes `fused.batch_norm`, and an average pool whose window tiles
the NHWC input (GlobalAvgPool2D included) takes `fused.avg_pool2d`;
otherwise the plain ops of `ops.nn`.

Channel counts (`in_units` of Dense, `in_channels` of Conv2D, BatchNorm
and LayerNorm) default to 0, inferred from the first input as in the JAX
package (the values are drawn then: deferred initialization); explicit
counts draw at `initialize()`. BatchNorm and Dropout read the training
flag of `autograd` (`autograd.record()`, `train_mode()`,
`FusedTrainStep`).

Differences from the JAX package: `Dropout` draws
from the port's per-device generator (`random.generator`) in training
mode, `Embedding` has no sparse gradient, and the
fused BatchNorm is taken only when the channel axis is last (NHWC),
since the apply kernel takes channels last; a channels-first BatchNorm
stays on the plain op. A strided input to a fused op is copied to a contiguous one
first and counted (`ops.fused.layout_copies()`): the kernels raise on
strided views.
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import fused as _fused
from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["HybridSequential", "Conv2D", "BatchNorm", "BatchNormReLU",
           "Activation", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "Dense", "Flatten", "Dropout", "LayerNorm", "Embedding",
           "MultiHeadAttention", "TransformerEncoderCell",
           "TransformerDecoderCell", "PositionalEmbedding"]

# activations a Dense/Conv2D may fuse: those both the kernel and the plain
# `ops.nn.activation` take, so the block also runs with fusion off
_FUSABLE_ACTS = frozenset({"relu", "sigmoid", "tanh"})


def _known(value):
    """A declared channel count, or 0 for one the first input gives."""
    return int(value) if value and value > 0 else 0


class HybridSequential(HybridBlock):
    """Children run in order; registered as '0', '1', ..."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """y = act(x @ W^T + b), W (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        self._new_param("weight", (units, _known(in_units)),
                        weight_initializer)
        if use_bias:
            self._new_param("bias", (units,), bias_initializer)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        if (self._act_type in _FUSABLE_ACTS and self.bias is not None
                and _fused.fusion_enabled()):
            y = _ops.fully_connected(x, self.weight, None, no_bias=True,
                                     flatten=self._flatten)
            return _fused.bias_act(y, self.bias, act_type=self._act_type,
                                   axis=-1)
        y = _ops.fully_connected(x, self.weight, self.bias,
                                 no_bias=self.bias is None,
                                 flatten=self._flatten)
        if self._act_type:
            y = _ops.activation(y, self._act_type)
        return y


class Dropout(HybridBlock):
    """Dropout of rate `rate` in training mode, identity otherwise."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return _ops.dropout(x, self._rate, _random.generator(x.device),
                            training=_autograd.is_training())


class LayerNorm(HybridBlock):
    """Layer norm over the last axis (epsilon 1e-5), gamma (ones) and beta
    (zeros) of `in_channels`."""

    def __init__(self, in_channels=0):
        super().__init__()
        ch = _known(in_channels)
        self._new_param("gamma", (ch,), "ones")
        self._new_param("beta", (ch,), "zeros")

    def infer_shape(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[-1],)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta)


class Embedding(HybridBlock):
    """Rows of weight (input_dim, output_dim) by index, drawn by the
    default initializer."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self._new_param("weight", (input_dim, output_dim))

    def forward(self, x):
        return _ops.embedding(x, self.weight)


class Conv2D(HybridBlock):
    """2-D convolution over NCHW or NHWC; weight (O, I/groups, kh, kw),
    kept channels-last in memory for NHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__()
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"Conv2D layout {layout!r} not supported")
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._channels = channels
        self._kernel = k
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        self._act_type = activation
        # the JAX package keeps this weight HWIO for NHWC
        self._hwio_weight = layout == "NHWC"
        self._new_param(
            "weight", (channels, _known(in_channels) // groups) + k,
            weight_initializer,
            memory_format=torch.channels_last if layout == "NHWC" else None)
        if use_bias:
            self._new_param("bias", (channels,), bias_initializer)
        else:
            self.bias = None

    def _channel_axis(self):
        return 1 if self._layout == "NCHW" else 3

    def infer_shape(self, x, *args):
        in_ch = x.shape[self._channel_axis()]
        self._reg_params["weight"].shape = \
            (self._channels, in_ch // self._groups) + self._kernel

    def forward(self, x):
        bias = self.bias
        fuse_ba = (self._act_type in _FUSABLE_ACTS and bias is not None
                   and _fused.fusion_enabled() and self._layout == "NHWC")
        if fuse_ba:
            bias_arr, bias = bias, None
        y = _ops.convolution(x, self.weight, bias, stride=self._strides,
                             dilate=self._dilation, pad=self._padding,
                             num_group=self._groups, no_bias=bias is None,
                             layout=self._layout)
        if fuse_ba:
            return _fused.bias_act(_fused.contiguous_counted(y), bias_arr,
                                   act_type=self._act_type, axis=-1)
        if self._act_type:
            y = _ops.activation(y, self._act_type)
        return y


class BatchNorm(HybridBlock):
    """Batch norm over `axis`; running stats are buffers, updated in
    training mode as the JAX package updates them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._use_global_stats = use_global_stats
        ch = _known(in_channels)
        self._new_param("gamma", (ch,), gamma_initializer,
                        grad_req="write" if scale else "null")
        self._new_param("beta", (ch,), beta_initializer,
                        grad_req="write" if center else "null")
        self._new_state("running_mean", (ch,), running_mean_initializer)
        self._new_state("running_var", (ch,), running_variance_initializer)

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p.shape = (x.shape[self._axis],)

    def _channels_last(self, x):
        return self._axis % x.ndim == x.ndim - 1

    def _adopt_stats(self, new_rm, new_rv):
        if _autograd.is_training() and not self._use_global_stats:
            with torch.no_grad():
                self.running_mean.copy_(new_rm)
                self.running_var.copy_(new_rv)

    def fused_forward(self, x, act_type=None, residual=None):
        """BN + optional activation + optional pre-activation residual add
        as one fused op (`ops.fused.batch_norm`): its apply stage is one
        launch of the scale/shift/activation kernel on the card."""
        if self._pending:
            self._resolve(x)
        if not self._channels_last(x):
            raise MXNetError("BatchNorm.fused_forward takes the channel axis "
                             "last (NHWC)")
        x = _fused.contiguous_counted(x)
        if residual is not None:
            residual = _fused.contiguous_counted(residual)
        out, nm, nv = _fused.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            momentum=self._momentum, eps=self._eps,
            training=_autograd.is_training(), axis=self._axis,
            use_global_stats=self._use_global_stats, act_type=act_type,
            residual=residual)
        self._adopt_stats(nm, nv)
        return out

    def forward(self, x):
        if _fused.fusion_enabled() and self._channels_last(x):
            return self.fused_forward(x)
        out, nm, nv = _ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            momentum=self._momentum, eps=self._eps,
            training=_autograd.is_training(), axis=self._axis,
            use_global_stats=self._use_global_stats)
        self._adopt_stats(nm, nv)
        return out


class BatchNormReLU(BatchNorm):
    """BN + ReLU: one fused pass on the fused tier."""

    def forward(self, x):
        if _fused.fusion_enabled() and self._channels_last(x):
            return self.fused_forward(x, act_type="relu")
        return _ops.relu(BatchNorm.forward(self, x))


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)


class Flatten(HybridBlock):
    def forward(self, x):
        return _ops.reshape(x, (x.shape[0], -1))


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, ceil_mode=False, count_include_pad=True):
        super().__init__()
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"pooling layout {layout!r} not supported")
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._global = global_pool
        self._type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad
        self._ceil_mode = ceil_mode

    def _fused_pool_size(self, x):
        """(ph, pw) when the fused non-overlapping NHWC pool applies (avg,
        NHWC, no padding, kernel == stride dividing the spatial dims, or
        global), else None."""
        if self._type != "avg" or self._layout != "NHWC" or x.ndim != 4:
            return None
        h, w = x.shape[1], x.shape[2]
        if self._global:
            return (h, w)
        k = (self._kernel,) * 2 if isinstance(self._kernel, int) \
            else tuple(self._kernel)
        s = (self._stride,) * 2 if isinstance(self._stride, int) \
            else tuple(self._stride)
        p = (self._pad,) * 2 if isinstance(self._pad, int) \
            else tuple(self._pad)
        if len(k) == 2 and k == s and p == (0, 0) \
                and h % k[0] == 0 and w % k[1] == 0:
            return k
        return None

    def forward(self, x):
        if _fused.fusion_enabled():
            ps = self._fused_pool_size(x)
            if ps is not None:
                return _fused.avg_pool2d(_fused.contiguous_counted(x), ps,
                                         layout="NHWC")
        return _ops.pooling(x, kernel=self._kernel, pool_type=self._type,
                            stride=self._stride, pad=self._pad,
                            global_pool=self._global,
                            count_include_pad=self._count_include_pad,
                            layout=self._layout, ceil_mode=self._ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         ceil_mode, count_include_pad)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, "avg", layout)


from .transformer import (MultiHeadAttention, TransformerEncoderCell,  # noqa: E402
                          TransformerDecoderCell, PositionalEmbedding)
