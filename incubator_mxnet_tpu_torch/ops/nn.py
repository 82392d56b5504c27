"""Neural-network ops of the PyTorch port, in plain torch.

Counterpart of `incubator_mxnet_tpu/ops/nn.py` for what ResNet and
transformer training need: convolution, fully_connected, the unfused
batch_norm, layer_norm, pooling, activation, relu, gelu, softmax,
log_softmax, pick, embedding, dropout and scaled_dot_product_attention,
plus the elementwise `add`, the reductions and the reshapes the Gluon
layers call. The JAX package leaves these to XLA outside any Pallas
kernel, so the port leaves them to PyTorch (cuDNN and cuBLAS on the
card).

Layouts follow the JAX package at the public functions: NHWC (or NCHW)
activations, channels-minor for the fused tier. One difference: the port
keeps convolution weights as (O, I/groups, kh, kw) for both layouts (in
channels-last memory for NHWC, so cuDNN runs channels-last without a
transpose), where the JAX package keeps HWIO for NHWC;
`gluon.params_from_jax` converts.

Under AMP each op casts its float inputs on entry as the JAX package's
dispatch does (`amp.cast_inputs`, by op name and class): convolution,
fully_connected, scaled_dot_product_attention, pooling, activation,
relu, add, reshape and transpose run in the target dtype; batch_norm,
layer_norm, softmax, log_softmax, sum and mean in float32; pick,
embedding, gelu and dropout as given (no list names them and the JAX
package registers no class for them, so their inputs keep their dtypes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp
from ..base import MXNetError

__all__ = ["convolution", "fully_connected", "batch_norm", "layer_norm",
           "pooling", "activation", "relu", "gelu", "softmax", "log_softmax",
           "pick", "embedding", "dropout", "scaled_dot_product_attention",
           "add", "multiply", "sum", "mean", "reshape", "transpose"]


def _pair(v):
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise MXNetError(f"expected 2 spatial values, got {v!r}")
        return tuple(int(a) for a in v)
    return (int(v), int(v))


def _channels_last(layout):
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError(f"layout {layout!r} not supported (NCHW or NHWC)")
    return layout == "NHWC"


# ---------------------------------------------------------------------------
# dense / convolution
# ---------------------------------------------------------------------------
def fully_connected(x, weight, bias=None, no_bias=False, flatten=True):
    """y = x @ W^T + b; `flatten=True` collapses trailing dims. `weight`
    is (units, in_units), as in the JAX package."""
    b = None if no_bias else bias
    x, weight, b = amp.cast_inputs("fully_connected", "safe", x, weight, b)
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    if b is not None:
        y = y + b
    return y


def convolution(data, weight, bias=None, stride=1, dilate=1, pad=0,
                num_group=1, no_bias=False, layout="NCHW"):
    """2-D convolution over NCHW or NHWC data; `weight` is (O, I/groups,
    kh, kw) for both layouts. The bias is added after the product, as the
    JAX package adds it."""
    if data.ndim != 4:
        raise MXNetError(f"convolution takes 4-D data; got {data.ndim}-D")
    b = None if no_bias else bias
    data, weight, b = amp.cast_inputs("convolution", "safe", data, weight, b)
    cl = _channels_last(layout)
    xc = data.permute(0, 3, 1, 2) if cl else data
    y = F.conv2d(xc, weight, None, _pair(stride), _pair(pad), _pair(dilate),
                 num_group)
    if cl:
        y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + (b if cl else b.reshape(1, -1, 1, 1))
    return y


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def batch_norm(x, gamma, beta, running_mean, running_var, momentum=0.9,
               eps=1e-5, training=True, axis=1, use_global_stats=False):
    """Unfused batch norm. Returns (out, new_running_mean,
    new_running_var); the stats follow the JAX package's protocol (f32
    moments, biased var = E[x^2] - E[x]^2, new = momentum*old +
    (1-momentum)*batch) and carry no gradient."""
    x, gamma, beta, running_mean, running_var = amp.cast_inputs(
        "batch_norm", "unsafe", x, gamma, beta, running_mean, running_var)
    ax = axis % x.ndim
    reduce_axes = tuple(i for i in range(x.ndim) if i != ax)
    bshape = [1] * x.ndim
    bshape[ax] = x.shape[ax]
    if training and not use_global_stats:
        xf = x.float()
        mean = xf.mean(dim=reduce_axes)
        mean_sq = (xf * xf).mean(dim=reduce_axes)
        var = mean_sq - mean * mean
        with torch.no_grad():
            new_rm = momentum * running_mean + (1 - momentum) * mean
            new_rv = momentum * running_var + (1 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    inv = torch.rsqrt(var.float() + eps)
    out = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
    if gamma is not None:
        out = out * gamma.reshape(bshape).float()
    if beta is not None:
        out = out + beta.reshape(bshape).float()
    return out.to(x.dtype), new_rm, new_rv


def layer_norm(x, gamma, beta):
    """Normalize over the last axis in float32 (population variance,
    epsilon 1e-5), then the float32 affine; the result in x's dtype
    (float32 under AMP)."""
    x, gamma, beta = amp.cast_inputs("layer_norm", "unsafe", x, gamma, beta)
    out = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(),
                       beta.float(), 1e-5)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            ceil_mode=False):
    """2-D max / avg pooling with the JAX package's semantics: pads of
    -inf (max) or 0 (avg); ceil_mode extends the right pad so the last
    partial window counts; avg divides by the whole window when
    `count_include_pad` (or there is no pad), else by the valid count."""
    (x,) = amp.cast_inputs("pooling", "safe", data)
    if x.ndim != 4:
        raise MXNetError(f"pooling takes 4-D data; got {x.ndim}-D")
    cl = _channels_last(layout)
    if pool_type not in ("max", "avg"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    if global_pool:
        axes = (1, 2) if cl else (2, 3)
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.float().mean(dim=axes, keepdim=True).to(x.dtype)
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    p = _pair(pad)
    xc = x.permute(0, 3, 1, 2) if cl else x
    pads = []
    for size, kk, ss, pp in zip(xc.shape[2:], k, s, p):
        hi = pp
        if ceil_mode:
            out = -(-(size + 2 * pp - kk) // ss) + 1
            hi = max(pp, (out - 1) * ss + kk - size - pp)
        pads.append((pp, hi))
    plain = all(lo == hi for lo, hi in pads) and all(
        lo <= kk // 2 for (lo, _), kk in zip(pads, k))
    if pool_type == "max":
        if plain:
            y = F.max_pool2d(xc, k, s, p)
        else:
            xp = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]),
                       value=-math.inf)
            y = F.max_pool2d(xp, k, s)
    else:
        xp = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        tot = F.avg_pool2d(xp, k, s, divisor_override=1)
        if count_include_pad or all(lo == 0 and hi == 0 for lo, hi in pads):
            y = tot / float(k[0] * k[1])
        else:
            ones = F.pad(torch.ones_like(xc), (pads[1][0], pads[1][1],
                                               pads[0][0], pads[0][1]))
            y = tot / F.avg_pool2d(ones, k, s, divisor_override=1)
    return y.permute(0, 2, 3, 1) if cl else y


# ---------------------------------------------------------------------------
# activations, softmax, pick
# ---------------------------------------------------------------------------
def _act(x, act_type):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "log_sigmoid":
        return F.logsigmoid(x)
    if act_type == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"unknown activation {act_type!r}")


def activation(x, act_type):
    """relu / sigmoid / tanh / softrelu / softsign / log_sigmoid / mish."""
    (x,) = amp.cast_inputs("activation", "neutral", x)
    return _act(x, act_type)


def relu(x):
    (x,) = amp.cast_inputs("relu", "neutral", x)
    return torch.relu(x)


def gelu(x):
    """The exact (erf) GELU."""
    (x,) = amp.cast_inputs("gelu", "neutral", x)
    return F.gelu(x)


def softmax(x, axis=-1):
    (x,) = amp.cast_inputs("softmax", "unsafe", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    (x,) = amp.cast_inputs("log_softmax", "unsafe", x)
    return torch.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False):
    """Select one element along `axis` per position (indices clipped to
    the axis, as the JAX package's mode='clip')."""
    axis = axis % x.ndim
    idx = index.to(device=x.device, dtype=torch.int64).clamp(
        0, x.shape[axis] - 1)
    picked = torch.gather(x, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


def embedding(indices, weight):
    """Rows of `weight` (input_dim, output_dim) gathered by `indices`."""
    (weight,) = amp.cast_inputs("embedding", "neutral", weight)
    return F.embedding(indices.to(device=weight.device, dtype=torch.int64),
                       weight)


def dropout(x, rate, generator, training=True):
    """Zero each element with probability `rate` and scale the kept ones
    by 1/(1 - rate), drawing the mask from `generator` (a
    `torch.Generator` on x's device). Identity when not training or
    rate <= 0."""
    (x,) = amp.cast_inputs("dropout", "neutral", x)
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (the composition MultiHeadAttention takes with a mask or without
# flash; the JAX package leaves it to XLA)
# ---------------------------------------------------------------------------
def scaled_dot_product_attention(q, k, v, mask=None, causal=False):
    """q, k, v (..., T, d): the product q k^T in the inputs' dtype, times
    1/sqrt(d) in float32 (the JAX package's scale is a float64 numpy
    scalar, which promotes), masked to -1e30 (end-aligned causal, then
    `mask`, True = keep), softmax in float32 cast back to q's dtype, times
    v."""
    q, k, v = amp.cast_inputs("scaled_dot_product_attention", "safe", q, k,
                              v)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        tq, tk = logits.shape[-2:]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = logits.masked_fill(~cm, -1e30)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(device=logits.device,
                                             dtype=torch.bool), -1e30)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(w, v)


# ---------------------------------------------------------------------------
# elementwise and reductions the Gluon layers use (the JAX package's NDArray
# `+`, `*`, `.sum`, `.mean`, `.reshape`, with the same AMP names)
# ---------------------------------------------------------------------------
def add(a, b):
    a, b = amp.cast_inputs("add", "neutral", a, b)
    return a + b


def multiply(a, b):
    a, b = amp.cast_inputs("multiply", "neutral", a, b)
    return a * b


def sum(x, axis=None, keepdims=False):  # noqa: A001 - the op's name
    (x,) = amp.cast_inputs("sum", "neutral", x)
    if axis is None:
        return x.sum()
    return x.sum(dim=axis, keepdim=keepdims)


def mean(x, axis=None, keepdims=False):
    (x,) = amp.cast_inputs("mean", "neutral", x)
    if axis is None:
        return x.mean()
    return x.mean(dim=axis, keepdim=keepdims)


def reshape(x, shape):
    (x,) = amp.cast_inputs("reshape", "neutral", x)
    return x.reshape(shape)


def transpose(x, axes):
    (x,) = amp.cast_inputs("transpose", "neutral", x)
    return x.permute(axes)
