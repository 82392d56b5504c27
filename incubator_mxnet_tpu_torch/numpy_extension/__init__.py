"""mx.npx of the PyTorch port: the NumPy extensions (NN ops, the kernel
ops, control flow, the np-mode scopes).

Counterpart of `incubator_mxnet_tpu/numpy_extension/__init__.py`. Each op
is registered as "npx.<name>" with the JAX package's AMP class and
dispatches through `ops.registry.invoke` (NDArray arguments are its inputs;
array-valued keyword arguments such as masks and lengths are closed over
as tensors, as the JAX package closes them over as raw buffers).

The kernel ops run the port's hand-written CUDA kernels for CUDA arrays
(and their plain versions for CPU arrays, as the wrappers of `ops` do):
`fused_bias_act`, `fused_norm_act_residual`, `fused_bn_inference` and
`fused_batch_norm` run B1 (the scale/shift/activation apply),
`fused_avg_pool2d` B2 / B3, `flash_attention` B5-B8 (AMP class "safe"),
`paged_attention` B4 (float and int8 slabs), `box_nms` and
`multibox_detection` the NMS sweep, `proposal` the same sweep kernels
under the proposal op's pixel-inclusive IoU, `fused_image_augment` the
input path's augment kernel (port-only). An `interpret=` argument is
accepted where the JAX signature has one and changes nothing: a CUDA array
still launches the kernel or raises.

Not in this slice: `rnn`, which raises naming its queue (A12, with
`gluon.rnn`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd as _autograd
from .. import random as _grandom
from ..base import MXNetError, to_torch_dtype
from ..ndarray import NDArray, _as_nd, _wrap
from ..ops import attention as _attention
from ..ops import contrib as _contrib
from ..ops import fused as _fused
from ..ops import nn as _nn
from ..ops.registry import get_op, invoke, note_layout, register_op

__all__ = [
    "relu", "sigmoid", "tanh", "softmax", "log_softmax", "masked_softmax",
    "softmin", "gelu", "leaky_relu", "elu", "selu", "silu", "swish",
    "activation", "one_hot", "pick", "topk", "sequence_mask", "embedding",
    "dropout", "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "rms_norm", "l2_normalization", "fully_connected", "convolution",
    "deconvolution", "pooling", "foreach", "while_loop", "cond", "scan",
    "set_np", "reset_np", "is_np_array", "is_np_shape", "use_np", "erf",
    "erfinv", "gamma", "gammaln", "digamma", "multi_sum_sq",
    "clip_by_global_norm", "arange_like", "broadcast_like", "shape_array",
    "stop_gradient", "smooth_l1", "scaled_dot_product_attention", "rnn",
    "fused_bias_act", "fused_norm_act_residual", "fused_bn_inference",
    "fused_avg_pool2d", "fused_batch_norm", "fused_image_augment",
    "flash_attention", "paged_attention", "sequence_last",
    "sequence_reverse", "box_iou", "box_nms", "roi_align",
    "bilinear_resize2d", "multibox_prior", "multibox_target",
    "multibox_detection", "proposal", "deformable_convolution",
    "psroi_pooling",
]


def _raw(v):
    return v._t if isinstance(v, NDArray) else v


def _op(name, impl, amp="neutral", casts_inside=False):
    """Register `impl` (tensors in, tensors out) as "npx.<name>" and return
    its mx.npx function: positional arguments are the dispatch's inputs,
    keyword arguments are closed over (NDArrays as their tensors)."""
    register_op("npx." + name, impl, amp=amp, casts_inside=casts_inside)
    info = get_op("npx." + name)

    def fn(*arrays, **kwargs):
        kwargs.pop("interpret", None)
        arrs = tuple(a if isinstance(a, NDArray) or a is None
                     or isinstance(a, (int, float, bool)) else _as_nd(a)
                     for a in arrays)
        kw = {k: _raw(v) for k, v in kwargs.items()}
        return invoke(impl, arrs, name=name, op=info, kwargs=kw)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = impl.__doc__
    return fn


# ---------------------------------------------------------------------------
# activations and elementwise functions
# ---------------------------------------------------------------------------
relu = _op("relu", _nn.relu, casts_inside=True)
sigmoid = _op("sigmoid", _nn.sigmoid, casts_inside=True)
tanh = _op("tanh", torch.tanh)
erf = _op("erf", torch.special.erf)
erfinv = _op("erfinv", torch.special.erfinv)
gamma = _op("gamma", lambda x: torch.exp(torch.special.gammaln(x)))
gammaln = _op("gammaln", torch.special.gammaln)
digamma = _op("digamma", torch.special.digamma)
softplus = _op("softplus", F.softplus)
log_sigmoid = _op("log_sigmoid", F.logsigmoid)
silu = _op("silu", _nn.silu, casts_inside=True)
swish = silu
stop_gradient = _op("stop_gradient", torch.Tensor.detach)
activation = _op("activation", _nn.activation, casts_inside=True)
gelu = _op("gelu", _nn.gelu, casts_inside=True)
elu = _op("elu", _nn.elu, casts_inside=True)
selu = _op("selu", _nn.selu, casts_inside=True)


def _softmax(x, axis=-1, temperature=None, length=None):
    """softmax over `axis`, optionally of x / temperature and over the
    first `length` positions (the rest 0)."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is None:
        return torch.softmax(x, dim=axis)
    x = _mask_axis(x, length, axis, -math.inf)
    out = torch.softmax(x, dim=axis)
    return torch.where(torch.isnan(out), 0.0, out).to(out.dtype)


def _mask_axis(x, length, axis, value):
    n = x.shape[axis]
    idx_shape = [1] * x.ndim
    idx_shape[axis] = n
    idx = torch.arange(n, device=x.device).reshape(idx_shape)
    len_shape = [1] * x.ndim
    len_shape[0] = x.shape[0]
    lb = length.to(x.device).reshape(len_shape)
    return torch.where(idx < lb, x, torch.full((), value, dtype=x.dtype,
                                               device=x.device))


def _log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


def _softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


def _masked_softmax(x, mask, axis=-1, temperature=1.0):
    """softmax over the positions `mask` keeps (the others 0)."""
    x = torch.where(mask, x / temperature,
                    torch.full((), -1e30, dtype=x.dtype, device=x.device))
    out = torch.softmax(x, dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


softmax = _op("softmax", _softmax, amp="unsafe")
log_softmax = _op("log_softmax", _log_softmax, amp="unsafe")
softmin = _op("softmin", _softmin, amp="unsafe")
masked_softmax = _op("masked_softmax", _masked_softmax, amp="unsafe")


def _leaky_relu(x, *gamma_, act_type="leaky", slope=0.25, upper=0.334,
                lower=0.125, generator=None, training=False):
    if act_type in ("leaky", "prelu"):
        return _nn.leaky_relu(x, act_type, slope,
                              gamma_[0] if gamma_ else None)
    if act_type == "elu":
        return F.elu(x, slope)
    if act_type == "selu":
        return F.selu(x)
    if act_type in ("gelu", "gelu_tanh"):
        return F.gelu(x, approximate="tanh" if act_type == "gelu_tanh"
                      else "none")
    if act_type == "rrelu":
        if training and generator is not None:
            u = lower + (upper - lower) * torch.rand(
                x.shape, generator=generator, device=x.device)
            return torch.where(x >= 0, x, (u * x.float()).to(x.dtype))
        return torch.where(x >= 0, x, x * ((lower + upper) / 2))
    raise ValueError(f"unknown leaky_relu type {act_type!r}")


register_op("npx.leaky_relu", _leaky_relu)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25, **kwargs):
    """leaky (slope), prelu (gamma), elu, selu, gelu, gelu_tanh and rrelu
    (a slope drawn per element from the device's generator in training)."""
    kw = dict(act_type=act_type, slope=slope, **kwargs)
    if act_type == "rrelu" and _autograd.is_training():
        kw["generator"] = _grandom.generator(_as_nd(data)._t.device)
        kw["training"] = True
    arrs = (_as_nd(data),) + ((_as_nd(gamma),) if act_type == "prelu"
                              else ())
    return invoke(_leaky_relu, arrs, name="leaky_relu", kwargs=kw)


# ---------------------------------------------------------------------------
# indexing and sequences
# ---------------------------------------------------------------------------
def _one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """One row of `depth` per index: on_value at the index, off_value
    elsewhere (an index outside [0, depth) gives off_value everywhere)."""
    hot = indices.unsqueeze(-1).to(torch.int64) == torch.arange(
        depth, device=indices.device)
    dt = to_torch_dtype(dtype)
    return hot.to(dt) * (on_value - off_value) + off_value


def _topk(x, k=1, axis=-1, ret_typ="indices", is_ascend=False):
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    idx = idx.to(torch.int32)
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx


def _sequence_mask(x, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Positions at or past each sequence's length along `axis` (time-major
    by default) set to `value`."""
    if not use_sequence_length or sequence_length is None:
        return x
    n = x.shape[axis]
    batch_axis = 1 - axis
    idx_shape = [1] * x.ndim
    idx_shape[axis] = n
    idx = torch.arange(n, device=x.device).reshape(idx_shape)
    len_shape = [1] * x.ndim
    len_shape[batch_axis] = x.shape[batch_axis]
    lb = sequence_length.to(x.device).reshape(len_shape)
    return torch.where(idx < lb, x, torch.full((), value, dtype=x.dtype,
                                               device=x.device))


def _sequence_last(x, sequence_length=None, use_sequence_length=False,
                   axis=0):
    if not use_sequence_length or sequence_length is None:
        return x.select(axis, x.shape[axis] - 1)
    t = (sequence_length.to(torch.int64) - 1).clamp(0, x.shape[axis] - 1)
    moved = torch.movedim(x, axis, 0)
    idx = t.to(x.device).reshape((1, -1) + (1,) * (moved.ndim - 2))
    return torch.take_along_dim(moved, idx, dim=0)[0]


def _sequence_reverse(x, sequence_length=None, use_sequence_length=False,
                      axis=0):
    if not use_sequence_length or sequence_length is None:
        return x.flip(axis)
    moved = torch.movedim(x, axis, 0)
    T = moved.shape[0]
    t_idx = torch.arange(T, device=x.device)[:, None]
    lens = sequence_length.to(device=x.device, dtype=torch.int64)[None, :]
    rev = torch.where(t_idx < lens, lens - 1 - t_idx, t_idx)
    # a length past T reverses into positions the JAX package fills (NaN)
    out = _nn.take_fill(moved, rev.reshape(
        rev.shape + (1,) * (moved.ndim - 2)), 0)
    return torch.movedim(out, 0, axis)


one_hot = _op("one_hot", _one_hot)
pick = _op("pick", _nn.pick, casts_inside=True)
topk = _op("topk", _topk)
sequence_mask = _op("sequence_mask", _sequence_mask)
embedding = _op("embedding", _nn.embedding, casts_inside=True)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """≙ SequenceLast: each sequence's last valid step."""
    arrs = (_as_nd(data),) + (() if sequence_length is None
                              else (_as_nd(sequence_length),))
    return invoke(_sequence_last, arrs, name="sequence_last",
                  kwargs=dict(use_sequence_length=use_sequence_length,
                              axis=axis))


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """≙ SequenceReverse: each sequence's valid steps reversed."""
    arrs = (_as_nd(data),) + (() if sequence_length is None
                              else (_as_nd(sequence_length),))
    return invoke(_sequence_reverse, arrs, name="sequence_reverse",
                  kwargs=dict(use_sequence_length=use_sequence_length,
                              axis=axis))


register_op("npx.sequence_last", _sequence_last)
register_op("npx.sequence_reverse", _sequence_reverse)


def _dropout(x, p, generator, axes):
    shape = x.shape if not axes else tuple(
        x.shape[i] if i in axes else 1 for i in range(x.ndim))
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).to(
        x.dtype)


register_op("npx.dropout", _dropout)


def dropout(data, p=0.5, axes=None, training=None):
    """Zero each element (or each slice across `axes`) with probability p,
    scaling the rest by 1/(1-p), in training mode only; the mask comes
    from the device's generator."""
    if training is None:
        training = _autograd.is_training()
    data = _as_nd(data)
    if not training or p <= 0:
        return data
    return invoke(_dropout, (data,), name="dropout",
                  kwargs=dict(p=p, generator=_grandom.generator(
                      data._t.device), axes=axes))


# ---------------------------------------------------------------------------
# normalization and layers
# ---------------------------------------------------------------------------
layer_norm = _op("layer_norm", _nn.layer_norm, casts_inside=True)
group_norm = _op("group_norm", _nn.group_norm, casts_inside=True)
instance_norm = _op("instance_norm", _nn.instance_norm, casts_inside=True)
rms_norm = _op("rms_norm", _nn.rms_norm, casts_inside=True)


def _l2_normalize(x, axis=-1, eps=1e-10):
    return x / torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)


l2_normalization = _op("l2_normalization", _l2_normalize, amp="unsafe")
scaled_dot_product_attention = _op("scaled_dot_product_attention",
                                   _nn.scaled_dot_product_attention,
                                   casts_inside=True)
register_op("npx.batch_norm", _nn.batch_norm, amp="unsafe",
            casts_inside=True)
register_op("npx.fully_connected", _nn.fully_connected, amp="safe",
            casts_inside=True)
register_op("npx.convolution", _nn.convolution, amp="safe",
            casts_inside=True)
register_op("npx.deconvolution", _nn.deconvolution, amp="safe",
            casts_inside=True)
register_op("npx.pooling", _nn.pooling, amp="safe", casts_inside=True)


def _write_stats(training, running_mean, running_var, nm, nv):
    if training and isinstance(running_mean, NDArray):
        with torch.no_grad():
            running_mean._t.copy_(nm._t)
            running_var._t.copy_(nv._t)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, axis=1, use_global_stats=False, training=None,
               sync_axis_name=None):
    """Batch norm; returns the output and, in training, writes the new
    running statistics into the `running_mean` / `running_var` NDArrays."""
    if training is None:
        training = _autograd.is_training()
    out, nm, nv = invoke(
        _nn.batch_norm, (_as_nd(x), _as_nd(gamma), _as_nd(beta),
                         _as_nd(running_mean), _as_nd(running_var)),
        name="batch_norm", op=get_op("npx.batch_norm"),
        kwargs=dict(momentum=momentum, eps=eps, training=training, axis=axis,
                    use_global_stats=use_global_stats))
    _write_stats(training, running_mean, running_var, nm, nv)
    return out


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    arrs = (_as_nd(x), _as_nd(weight)) + (
        () if no_bias or bias is None else (_as_nd(bias),))
    return invoke(_nn.fully_connected, arrs, name="fully_connected",
                  op=get_op("npx.fully_connected"),
                  kwargs=dict(flatten=flatten))


def convolution(data, weight, bias=None, kernel=None, stride=1, dilate=1,
                pad=0, num_filter=None, num_group=1, no_bias=False,
                layout="NCHW"):
    """`weight` is (O, I/groups, *kernel) for every layout (the port's
    storage; the JAX package keeps a channels-last weight kernel dims
    first)."""
    arrs = (_as_nd(data), _as_nd(weight)) + (
        () if no_bias or bias is None else (_as_nd(bias),))
    info = get_op("npx.convolution")
    note_layout(info, layout)
    return invoke(_nn.convolution, arrs, name="convolution",
                  op=info,
                  kwargs=dict(stride=stride, dilate=dilate, pad=pad,
                              num_group=num_group, layout=layout))


def deconvolution(data, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_group=1, no_bias=False, layout="NCHW"):
    arrs = (_as_nd(data), _as_nd(weight)) + (
        () if no_bias or bias is None else (_as_nd(bias),))
    info = get_op("npx.deconvolution")
    note_layout(info, layout)
    return invoke(_nn.deconvolution, arrs, name="deconvolution",
                  op=info,
                  kwargs=dict(stride=stride, dilate=dilate, pad=pad, adj=adj,
                              num_group=num_group, layout=layout))


def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            ceil_mode=False, pooling_convention=None):
    if pooling_convention is not None:
        ceil_mode = pooling_convention == "full"
    info = get_op("npx.pooling")
    note_layout(info, layout)
    return invoke(_nn.pooling, (_as_nd(data),), name="pooling",
                  op=info,
                  kwargs=dict(kernel=kernel, pool_type=pool_type,
                              stride=stride, pad=pad,
                              global_pool=global_pool,
                              count_include_pad=count_include_pad,
                              layout=layout, ceil_mode=ceil_mode))


# ---------------------------------------------------------------------------
# the kernel ops
# ---------------------------------------------------------------------------
fused_bias_act = _op("fused_bias_act", _fused.bias_act, amp="safe",
                     casts_inside=True)
fused_norm_act_residual = _op("fused_norm_act_residual",
                              _fused.norm_act_residual, amp="unsafe",
                              casts_inside=True)
fused_bn_inference = _op("fused_bn_inference", _fused.bn_inference,
                         amp="unsafe", casts_inside=True)
register_op("npx.fused_batch_norm", _fused.batch_norm, amp="unsafe",
            casts_inside=True)
register_op("npx.fused_avg_pool2d", _fused.avg_pool2d, amp="safe",
            casts_inside=True)


def fused_avg_pool2d(data, pool_size, layout="NHWC", interpret=None):
    """Non-overlapping NHWC average pool (B2; its backward B3)."""
    ps = (pool_size, pool_size) if isinstance(pool_size, int) \
        else tuple(pool_size)
    info = get_op("npx.fused_avg_pool2d")
    note_layout(info, layout)
    return invoke(_fused.avg_pool2d, (_as_nd(data),), name="fused_avg_pool2d",
                  op=info,
                  kwargs=dict(pool_size=ps, layout=layout))


register_op("npx.fused_image_augment", _fused.image_augment)


def fused_image_augment(images, key, mean=None, std=None, crop_hw=None,
                        rand_mirror=False, out_dtype="float32",
                        interpret=None):
    """The input path's crop / mirror / 1/255 / mean-std / cast in one pass
    (`ops.fused.image_augment`; the augment kernel for a CUDA batch). `key`
    is the (epoch seed, batch) pair of uint32 the draws are seeded from,
    read on the host."""
    key = key.asnumpy() if isinstance(key, NDArray) else key
    key = key.tolist() if hasattr(key, "tolist") else list(key)
    return invoke(_fused.image_augment, (_as_nd(images),),
                  name="fused_image_augment",
                  op=get_op("npx.fused_image_augment"),
                  kwargs=dict(key=tuple(key), mean=mean, std=std,
                              crop_hw=crop_hw, rand_mirror=rand_mirror,
                              out_dtype=out_dtype))


def fused_batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
                     momentum=0.9, axis=1, use_global_stats=False,
                     training=None, sync_axis_name=None, act_type=None,
                     residual=None, interpret=None):
    """Batch norm whose apply (with an optional activation and residual)
    runs B1; in training the running statistics are written into the
    NDArrays, as `batch_norm` does."""
    if training is None:
        training = _autograd.is_training()
    arrs = (_as_nd(x), _as_nd(gamma), _as_nd(beta), _as_nd(running_mean),
            _as_nd(running_var))
    kw = dict(momentum=momentum, eps=eps, training=training, axis=axis,
              use_global_stats=use_global_stats, act_type=act_type)
    if residual is not None:
        arrs += (_as_nd(residual),)
        out, nm, nv = invoke(_bn_residual, arrs, name="fused_batch_norm",
                             op=get_op("npx.fused_batch_norm"), kwargs=kw)
    else:
        out, nm, nv = invoke(_fused.batch_norm, arrs,
                             name="fused_batch_norm",
                             op=get_op("npx.fused_batch_norm"), kwargs=kw)
    _write_stats(training, running_mean, running_var, nm, nv)
    return out


def _bn_residual(a, g, b, rm, rv, r, **kw):
    return _fused.batch_norm(a, g, b, rm, rv, residual=r, **kw)


def _flash(query, key, value, causal=False, scale=None, block_q=None,
           block_k=None):
    """Flash attention over (batch*heads, T, head_dim): B5 (B6 with B7 and
    B8 when a gradient is recorded) on CUDA arrays."""
    return _attention.flash_attention(query, key, value, causal=causal,
                                      scale=scale)


flash_attention = _op("flash_attention", _flash, amp="safe")


def _paged(query, k_slab, v_slab, lengths, *scales, layer):
    """Paged decode attention over a slotted KV slab (B4): lane s reads slab
    row s of `layer`; int8 slabs come with per-position scales."""
    ks, vs = scales if scales else (None, None)
    return _fused.paged_attention(query, k_slab, v_slab, lengths, layer,
                                  ks, vs)


register_op("npx.paged_attention", _paged, amp="safe")


def paged_attention(query, k_slab, v_slab, lengths, layer, k_scale=None,
                    v_scale=None, interpret=None):
    """Paged decode attention (B4): `query` (S, C, H, D) chunk queries over
    `layer` of the slab; `k_scale`/`v_scale` dequantize an int8 slab."""
    arrs = [_as_nd(query), _as_nd(k_slab), _as_nd(v_slab), _as_nd(lengths)]
    if k_scale is not None:
        arrs += [_as_nd(k_scale), _as_nd(v_scale)]
    return invoke(_paged, tuple(arrs), name="paged_attention",
                  op=get_op("npx.paged_attention"),
                  kwargs=dict(layer=int(layer)))


def _box_iou(lhs, rhs, format="corner"):
    return _contrib.box_iou(lhs, rhs, fmt=format)


box_iou = _op("box_iou", _box_iou, amp="unsafe")
box_nms = _op("box_nms", _contrib.box_nms, amp="unsafe")
multibox_target = _op("multibox_target", _contrib.multibox_target,
                      amp="unsafe")
multibox_detection = _op("multibox_detection", _contrib.multibox_detection,
                         amp="unsafe")
_multibox_prior = _op("multibox_prior", _contrib.multibox_prior,
                      amp="unsafe")


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), layout="NCHW"):
    """SSD prior boxes of a feature map (its shape only: `data` is
    detached, and the op has no backward, as in the JAX package)."""
    return _multibox_prior(_as_nd(data).detach(), sizes=tuple(sizes),
                           ratios=tuple(ratios), clip=clip,
                           steps=tuple(steps), offsets=tuple(offsets),
                           layout=layout)


# the Faster-RCNN / R-FCN tail, with the JAX package's AMP classes (the
# deformable convolution is product-bound, "safe"; the box and pooled
# sampling arithmetic stays float32, "unsafe")
_roi_align = _op("roi_align", _contrib.roi_align, amp="unsafe")
_bilinear_resize2d = _op("bilinear_resize2d", _contrib.bilinear_resize2d,
                         amp="unsafe")
_proposal = _op("proposal", _contrib.proposal, amp="unsafe")
_deformable_convolution = _op("deformable_convolution",
                              _contrib.deformable_convolution, amp="safe")
_psroi_pooling = _op("psroi_pooling", _contrib.psroi_pooling, amp="unsafe")


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=2):
    """ROI Align of `rois` (R, 5) over `data` (N, C, H, W): (R, C, ph,
    pw)."""
    if not isinstance(pooled_size, int):
        pooled_size = tuple(pooled_size)
    return _roi_align(data, rois, pooled_size=pooled_size,
                      spatial_scale=spatial_scale, sample_ratio=sample_ratio)


def bilinear_resize2d(data, height, width, layout="NCHW"):
    """`jax.image.resize`'s linear resize of an NCHW (or NHWC) batch to
    height x width."""
    return _bilinear_resize2d(data, height=int(height), width=int(width),
                              layout=layout)


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (rois (post_n, 5), and their scores with
    `output_score`); the sweep runs on the card's kernel. No backward."""
    return _proposal(cls_prob, bbox_pred, im_info,
                     rpn_pre_nms_top_n=int(rpn_pre_nms_top_n),
                     rpn_post_nms_top_n=int(rpn_post_nms_top_n),
                     threshold=float(threshold),
                     rpn_min_size=rpn_min_size, scales=tuple(scales),
                     ratios=tuple(ratios),
                     feature_stride=int(feature_stride),
                     output_score=bool(output_score),
                     iou_loss=bool(iou_loss))


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_deformable_group=1):
    """Deformable convolution v1 (offset (B, 2 G kh kw, Ho, Wo))."""
    return _deformable_convolution(
        data, offset, weight, bias, kernel=tuple(kernel),
        stride=tuple(stride), pad=tuple(pad), dilate=tuple(dilate),
        num_deformable_group=int(num_deformable_group))


def psroi_pooling(data, rois, spatial_scale, output_dim, pooled_size,
                  group_size=0):
    """Position-sensitive ROI pooling (R-FCN): (R, output_dim, P, P)."""
    return _psroi_pooling(data, rois, spatial_scale=spatial_scale,
                          output_dim=int(output_dim),
                          pooled_size=int(pooled_size),
                          group_size=int(group_size))


_RNN_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _rnn_fused(x, flat, h0, *maybe_c, mode, H, L, D, p, generator,
               training):
    """`ops.nn.rnn` over the reference's flat parameter vector: all
    W_i2h / W_h2h gate blocks layer-major (direction inner), then all
    b_i2h / b_h2h pairs in the same order."""
    G, C = _RNN_GATES[mode], x.shape[-1]
    need = sum(G * H * ((C if layer == 0 else H * D) + H + 2)
               for layer in range(L) for _ in range(D))
    if need != flat.shape[0]:
        # the reference op's parameter-size check (rnn.cc): a mismatched
        # layout must not misalign every block (the JAX package's message;
        # it raises it for a long vector, and a reshape error for a short
        # one)
        raise MXNetError(
            f"parameters has {flat.shape[0]} elements; the "
            f"{mode} L={L} D={D} H={H} C={C} layout needs {need}")
    off = 0

    def take(n, shape):
        nonlocal off
        w = flat[off:off + n].reshape(shape)
        off += n
        return w

    params = {}
    for layer in range(L):
        insz = C if layer == 0 else H * D
        for d in range(D):
            params[(layer, d)] = {"wx": take(G * H * insz, (G * H, insz)),
                                  "wh": take(G * H * H, (G * H, H))}
    for layer in range(L):
        for d in range(D):
            params[(layer, d)]["bx"] = take(G * H, (G * H,))
            params[(layer, d)]["bh"] = take(G * H, (G * H,))
    out, new_state = _nn.rnn(x, params, (h0,) + tuple(maybe_c), mode=mode,
                             num_layers=L, bidirectional=(D == 2),
                             dropout_rate=p, generator=generator,
                             training=training)
    return (out,) + tuple(new_state)


register_op("npx.rnn", _rnn_fused)


def rnn(data, parameters, state, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=False):
    """Fused multi-layer (bi)RNN on a flat parameter vector (the
    reference's `_npx.rnn`, src/operator/rnn.cc). `data` (T, N, C)
    time-major; `parameters` all W_i2h / W_h2h gate blocks layer-major
    with direction inner, then all b_i2h / b_h2h pairs in the same order;
    gate order LSTM [i, f, g, o], GRU [r, z, n]. `state` (L D, N, H) and,
    for the LSTM, `state_cell` likewise. Dropout `p` between layers in
    training, from the device's generator. Returns `out`, or (out, h_n[,
    c_n]) with `state_outputs`."""
    if state_size is None:
        raise MXNetError("state_size is required")
    if mode not in _RNN_GATES:
        raise MXNetError(f"unknown rnn mode {mode!r}")
    arrs = [_as_nd(data), _as_nd(parameters), _as_nd(state)]
    if mode == "lstm":
        if state_cell is None:
            raise MXNetError("lstm needs state_cell")
        arrs.append(_as_nd(state_cell))
    training = _autograd.is_training()
    gen = _grandom.generator(arrs[0]._t.device) \
        if (p > 0 and training) else None
    res = invoke(_rnn_fused, tuple(arrs), name="rnn_fused",
                 kwargs=dict(mode=mode, H=int(state_size),
                             L=int(num_layers), D=2 if bidirectional else 1,
                             p=p, generator=gen, training=training))
    return tuple(res) if state_outputs else res[0]


# ---------------------------------------------------------------------------
# small ops
# ---------------------------------------------------------------------------
def _smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                       x.abs() - 0.5 / s2)


smooth_l1 = _op("smooth_l1", _smooth_l1)


def _multi_sum_sq(*xs):
    return tuple(torch.sum(x * x) for x in xs)


register_op("npx.multi_sum_sq", _multi_sum_sq)


def multi_sum_sq(*arrays):
    """The sum of squares of each array."""
    return invoke(_multi_sum_sq, tuple(_as_nd(a) for a in arrays),
                  name="multi_sum_sq")


def clip_by_global_norm(arrays, max_norm):
    """Scale `arrays` in place so their global L2 norm is at most
    `max_norm` (each times max_norm / max(norm, max_norm), taken on the
    host as the JAX package takes it); returns the norm."""
    sqs = multi_sum_sq(*arrays)
    total = sqs[0]
    for s in sqs[1:]:
        total = total + s
    norm = total.sqrt()
    scale = float(max_norm) / max(float(norm.asscalar()), float(max_norm))
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return norm


def _arange_like(x, start=0.0, step=1.0, axis=None):
    n = x.numel() if axis is None else x.shape[axis]
    out = (start + step * torch.arange(n, device=x.device,
                                       dtype=torch.float64)).to(x.dtype)
    return out.reshape(x.shape) if axis is None else out


arange_like = _op("arange_like", _arange_like)
broadcast_like = _op("broadcast_like",
                     lambda a, b: a.expand(b.shape).clone())


def shape_array(data):
    """The shape of `data` as an int32 array (int64 narrowed, as in the
    JAX package) on its device."""
    d = _as_nd(data)
    return _wrap(torch.tensor(d.shape, dtype=torch.int32,
                              device=d._t.device))


# ---------------------------------------------------------------------------
# control flow (the JAX package lowers these to lax.scan / while_loop /
# cond; the port runs them as Python loops over NDArray ops, which tape and
# differentiate like any other)
# ---------------------------------------------------------------------------
def foreach(body, data, init_states):
    """Run `body(x_t, states) -> (out_t, new_states)` over axis 0 of data
    (≙ _npx_foreach); returns the stacked outputs and the final states."""
    single_data = isinstance(data, NDArray)
    datas = (data,) if single_data else tuple(data)
    single_state = isinstance(init_states, NDArray)
    states = [init_states] if single_state else list(init_states)
    outs = []
    for t in range(datas[0].shape[0]):
        xs = [d[t] for d in datas]
        out, new = body(xs[0] if single_data else xs,
                        states[0] if single_state else states)
        outs.append((out,) if isinstance(out, NDArray) else tuple(out))
        states = [new] if isinstance(new, NDArray) else list(new)
    from .. import numpy as _mxnp
    stacked = [_mxnp.stack([o[i] for o in outs])
               for i in range(len(outs[0]))]
    return (stacked[0] if len(stacked) == 1 else stacked,
            states[0] if single_state else states)


scan = foreach


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """≙ _npx_while_loop as the JAX package has it: `func(*vars)` returns
    the new loop variables while `cond_fn(*vars)` holds (at most
    `max_iterations` times); returns ([], final loop variables)."""
    single = isinstance(loop_vars, NDArray)
    lvs = [loop_vars] if single else list(loop_vars)
    i = 0
    while bool(cond_fn(*lvs)) and (max_iterations is None
                                   or i < max_iterations):
        out = func(*lvs)
        lvs = [out] if isinstance(out, NDArray) else list(out)
        i += 1
    return [], (lvs[0] if single else lvs)


def cond(pred, then_func, else_func, inputs=None):
    """≙ _npx_cond: `then_func(*inputs)` if pred (an array or a function of
    the inputs) holds, else `else_func(*inputs)`."""
    if inputs is None:
        inputs = []
    ins = [inputs] if isinstance(inputs, NDArray) else list(inputs)
    p = pred(*ins) if callable(pred) else pred
    out = (then_func if bool(p) else else_func)(*ins)
    outs = (out,) if isinstance(out, NDArray) else tuple(out)
    return outs[0] if len(outs) == 1 else list(outs)


# ---------------------------------------------------------------------------
# np-mode scopes (the numpy frontend is always on; kept for scripts)
# ---------------------------------------------------------------------------
_np_mode = {"array": True, "shape": True}


def set_np(shape=True, array=True, dtype=None):
    _np_mode["array"] = array
    _np_mode["shape"] = shape


def reset_np():
    set_np()


def is_np_array():
    return _np_mode["array"]


def is_np_shape():
    return _np_mode["shape"]


def use_np(func):
    return func


def load(fname):
    from ..ndarray import load as _load
    return _load(fname)


def save(fname, data):
    from ..ndarray import save as _save
    return _save(fname, data)
