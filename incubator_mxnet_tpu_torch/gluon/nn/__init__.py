"""gluon.nn of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/gluon/nn/__init__.py`: the containers
`Sequential`, `HybridSequential`, `Concatenate`, `HybridConcatenate`,
`Identity`, `Lambda` and `HybridLambda`; `Dense`, `Dropout`, `Embedding`,
`Flatten`; the norms `BatchNorm` (with `fused_forward`), `BatchNormReLU`,
`LayerNorm`, `GroupNorm`, `InstanceNorm` and `RMSNorm`; the activations
`Activation` (relu, sigmoid, tanh, softrelu, softsign, log_sigmoid, mish),
`LeakyReLU`, `PReLU`, `ELU`, `SELU`, `GELU` and `Swish` (`SiLU`); the
convolutions `Conv1D`, `Conv2D`, `Conv3D` and their transposes over one
`_Conv` (channels first or last: NCW / NWC, NCHW / NHWC, NCDHW / NDHWC);
the max, average and global pools in 1, 2 and 3 dims; `ReflectionPad2D`;
and from `transformer`: `MultiHeadAttention`, `TransformerEncoderCell`,
`TransformerDecoderCell` and `PositionalEmbedding`. They route exactly as
the JAX package's layers do: inside a fusion scope
(`ops.fused.fusion_enabled()`, which `FusedTrainStep` and `FusedInferStep`
enter) a Dense or convolution with bias and a fusable activation takes
`fused.bias_act` on its channel axis, a BatchNorm takes
`fused.batch_norm`, and an average pool whose window tiles the NHWC input
(GlobalAvgPool2D included) takes `fused.avg_pool2d`; otherwise the plain
ops of `ops.nn`.

Channel counts (`in_units` of Dense, `in_channels` of the convolutions and
the norms) default to 0, inferred from the first input as in the JAX
package (the values are drawn then: deferred initialization); explicit
counts draw at `initialize()`. BatchNorm and Dropout read the training
flag of `autograd` (`autograd.record()`, `train_mode()`,
`FusedTrainStep`).

`Embedding(sparse_grad=True)` records, under `autograd.record()`, the
indices of every forward on its weight (accumulated across calls until
the Trainer's next update); the gradient stays dense, and
`gluon.Trainer` updates only the rows those indices touched.

Differences from the JAX package: `Dropout` draws from the port's
per-device generator (`random.generator`) in training mode, and the fused
apply (a convolution's bias and
activation, a BatchNorm) is taken only when the channel axis is last,
since the apply kernel takes channels last; a channels-first layer stays
on the plain ops, where the JAX package calls its fused op and that op
takes its own plain composition. A strided input to a fused op is copied
to a contiguous one first and counted (`ops.fused.layout_copies()`): the
kernels raise on strided views. `Lambda("name")` resolves the name in
`torch` (the JAX package: in its numpy namespace).
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _autograd
from ... import initializer as _init
from ... import random as _random
from ...base import MXNetError
from ...ops import fused as _fused
from ...ops import nn as _ops
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "BatchNormReLU", "Embedding", "Flatten", "InstanceNorm",
           "LayerNorm", "GroupNorm", "RMSNorm", "Lambda", "HybridLambda",
           "Concatenate", "HybridConcatenate", "Identity", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "SiLU", "GELU",
           "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D", "MultiHeadAttention", "TransformerEncoderCell",
           "TransformerDecoderCell", "PositionalEmbedding"]

# activations a Dense/Conv2D may fuse: those both the kernel and the plain
# `ops.nn.activation` take, so the block also runs with fusion off
_FUSABLE_ACTS = frozenset({"relu", "sigmoid", "tanh"})


def _known(value):
    """A declared channel count, or 0 for one the first input gives."""
    return int(value) if value and value > 0 else 0


class Sequential(Block):
    """Children run in order, registered as '0', '1', ...; extra
    positional inputs go to the first child only."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*children[key])
            return net
        return children[key]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential, HybridBlock):
    """A Sequential whose `hybridize()` flag is recorded."""


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _resolve_fn(function):
    return getattr(torch, function) if isinstance(function, str) \
        else function


class Lambda(Block):
    """A block around `function` (a callable, or the name of a `torch`
    function)."""

    def __init__(self, function):
        super().__init__()
        self._func = _resolve_fn(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Lambda as a HybridBlock."""

    def __init__(self, function):
        super().__init__()
        self._func = _resolve_fn(function)

    def forward(self, *args):
        return self._func(*args)


class Concatenate(Sequential):
    """Every child on the same input, outputs joined along `axis`."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return _ops.concat([b(x) for b in self._modules.values()],
                           axis=self._axis)


class HybridConcatenate(HybridSequential):
    """Concatenate as a HybridBlock."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    forward = Concatenate.forward


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


class _AffineNorm(HybridBlock):
    """A norm with per-channel gamma (ones) and beta (zeros) of the
    channel count on `self._axis`; `scale` / `center` False freeze them
    (grad_req "null"), as in the JAX package, which still applies them."""

    def __init__(self, axis, center, scale, beta_initializer,
                 gamma_initializer, in_channels):
        super().__init__()
        self._axis = axis
        ch = _known(in_channels)
        self._new_param("gamma", (ch,), gamma_initializer,
                        grad_req="write" if scale else "null")
        self._new_param("beta", (ch,), beta_initializer,
                        grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[self._axis],)


class LayerNorm(_AffineNorm):
    """Layer norm over `axis` (default the last)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._eps = epsilon

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                               eps=self._eps)


class GroupNorm(_AffineNorm):
    """Group norm of channels-first data: `num_groups` groups of the
    channels (axis 1)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(1, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._num_groups = num_groups
        self._eps = epsilon

    def forward(self, x):
        return _ops.group_norm(x, self.gamma, self.beta,
                               num_groups=self._num_groups, eps=self._eps)


class InstanceNorm(_AffineNorm):
    """Instance norm of channels-first data (each sample's channel over
    its spatial dims); `axis` names the channel count's axis for the
    deferred shape, as in the JAX package."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._eps = epsilon

    def forward(self, x):
        return _ops.instance_norm(x, self.gamma, self.beta, eps=self._eps)


class RMSNorm(HybridBlock):
    """RMS norm over the last axis, times gamma (ones)."""

    def __init__(self, in_channels=0, epsilon=1e-6, gamma_initializer="ones"):
        super().__init__()
        self._eps = epsilon
        self._new_param("gamma", (_known(in_channels),), gamma_initializer)

    def infer_shape(self, x, *args):
        self._reg_params["gamma"].shape = (x.shape[-1],)

    def forward(self, x):
        return _ops.rms_norm(x, self.gamma, eps=self._eps)


class Embedding(HybridBlock):
    """Rows of weight (input_dim, output_dim) by index. With
    `sparse_grad=True` a forward under `autograd.record()` adds its
    indices to the weight's touched set (`Parameter._last_tokens`), which
    `gluon.Trainer` reads for its touched-rows update and clears; other
    forwards leave the set alone."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        self._adopt("weight", Parameter(shape=(input_dim, output_dim),
                                        dtype=dtype, init=weight_initializer,
                                        name="weight"))
        self._reg_params["weight"]._sparse_grad = self._sparse_grad

    def forward(self, x):
        if self._sparse_grad and _autograd.is_recording():
            p = self._reg_params["weight"]
            # the rows the gather reads (an index past them is clamped)
            p._last_tokens = (p._last_tokens or []) + [
                _ops.clamp_index(x.detach(), self._input_dim)]
        return _ops.embedding(x, self.weight)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class _Conv(HybridBlock):
    """Convolution or transposed convolution over channels-first or
    channels-last data of 1-3 spatial dims (the layout names them). The
    weight is (O, I/groups, *kernel), or (I, O/groups, *kernel) for a
    transposed one, kept channels-last in memory for NHWC / NDHWC."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="convolution", adj=None):
        super().__init__()
        nd = len(layout) - 2
        _ops._channels_last(layout, nd)     # raises for an unknown layout
        self._channels = channels
        self._kernel = (kernel_size,) * nd if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        self._act_type = activation
        self._op_name = op_name
        self._adj = adj
        # the JAX package keeps a channels-last weight kernel dims first
        self._hwio_weight = not layout.startswith("NC")
        fmt = {"NHWC": torch.channels_last,
               "NDHWC": torch.channels_last_3d}.get(layout)
        self._new_param("weight", self._weight_shape(_known(in_channels)),
                        weight_initializer, memory_format=fmt)
        if use_bias:
            self._new_param("bias", (channels,), bias_initializer)
        else:
            self.bias = None

    def _weight_shape(self, in_ch):
        if self._op_name == "deconvolution":
            return (in_ch, self._channels // self._groups) + self._kernel
        return (self._channels, in_ch // self._groups) + self._kernel

    def _channel_axis(self):
        return 1 if self._layout.startswith("NC") else len(self._layout) - 1

    def infer_shape(self, x, *args):
        self._reg_params["weight"].shape = self._weight_shape(
            x.shape[self._channel_axis()])

    def forward(self, x):
        bias = self.bias
        # the JAX package fuses in every layout; its fused op takes the
        # kernel only with the channels last, as the port's does
        fuse_ba = (self._act_type in _FUSABLE_ACTS and bias is not None
                   and _fused.fusion_enabled()
                   and not self._layout.startswith("NC"))
        if fuse_ba:
            bias_arr, bias = bias, None
        if self._op_name == "convolution":
            y = _ops.convolution(x, self.weight, bias, stride=self._strides,
                                 dilate=self._dilation, pad=self._padding,
                                 num_group=self._groups,
                                 no_bias=bias is None, layout=self._layout)
        else:
            y = _ops.deconvolution(x, self.weight, bias, stride=self._strides,
                                   dilate=self._dilation, pad=self._padding,
                                   adj=self._adj or 0, num_group=self._groups,
                                   no_bias=bias is None, layout=self._layout)
        if fuse_ba:
            return _fused.bias_act(_fused.contiguous_counted(y), bias_arr,
                                   act_type=self._act_type, axis=-1)
        if self._act_type:
            y = _ops.activation(y, self._act_type)
        return y


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution", adj=output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution", adj=output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution", adj=output_padding)


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
        # a rematerialized forward's recompute must not update them twice
        if _autograd.is_training() and not self._use_global_stats \
                and not _autograd.is_recomputing():
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
    """relu, sigmoid, tanh, softrelu, softsign, log_sigmoid or mish."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _ops.leaky_relu(x, "leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """x where x >= 0, else alpha * x; alpha a Parameter of `in_channels`
    (0.25), broadcast against x's trailing axes as in the JAX package."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        self._new_param("alpha", (in_channels,),
                        alpha_initializer or _init.Constant(0.25))

    def forward(self, x):
        return _ops.leaky_relu(x, "prelu", gamma=self.alpha)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _ops.elu(x, self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _ops.selu(x)


class GELU(HybridBlock):
    """GELU, exact (`approximation="erf"`) or `"tanh"`."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation != "erf"

    def forward(self, x):
        return _ops.gelu(x, approximate=self._approx)


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        if self._beta == 1.0:
            return _ops.silu(x)
        return _ops.swish(x, self._beta)


SiLU = Swish


class Flatten(HybridBlock):
    def forward(self, x):
        return _ops.reshape(x, (x.shape[0], -1))


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, ceil_mode=False, count_include_pad=True):
        super().__init__()
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


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         ceil_mode, count_include_pad)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         ceil_mode, count_include_pad)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         ceil_mode, count_include_pad)


class GlobalMaxPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, True, "max", layout)


class GlobalMaxPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, "max", layout)


class GlobalMaxPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, "max", layout)


class GlobalAvgPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, True, "avg", layout)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, "avg", layout)


class GlobalAvgPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of NCHW data's spatial dims; `padding` is one
    int or (left, right, top, bottom)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = (padding,) * 4 if isinstance(padding, int) \
            else tuple(padding)

    def forward(self, x):
        return _ops.reflection_pad2d(x, self._padding)


from .transformer import (MultiHeadAttention, TransformerEncoderCell,  # noqa: E402
                          TransformerDecoderCell, PositionalEmbedding)
