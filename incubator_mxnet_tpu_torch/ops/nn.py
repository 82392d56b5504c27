"""Neural-network ops of the PyTorch port, in plain torch.

Counterpart of `incubator_mxnet_tpu/ops/nn.py` for what the ported Gluon
layers need: convolution and deconvolution (1-D, 2-D and 3-D),
fully_connected, the unfused batch_norm, layer_norm, group_norm,
instance_norm, rms_norm, pooling (1-D, 2-D and 3-D), activation, relu,
leaky_relu (leaky, prelu), elu, selu, gelu, silu, swish, sigmoid,
softmax, log_softmax, pick, embedding, dropout,
scaled_dot_product_attention and the recurrent cells and layer
(`lstm_cell`, `gru_cell`, `rnn_relu_cell`, `rnn`, whose elementwise step
is the CUDA kernel of `ops.rnn` on the card), plus the elementwise `add`,
`clip`, the reductions, the reshapes, `concat` and the reflection pad the
Gluon layers call. The JAX package leaves these to XLA outside any Pallas kernel, so
the port leaves them to PyTorch (cuDNN and cuBLAS on the card).

Layouts follow the JAX package at the public functions: NCW / NWC,
NCHW / NHWC and NCDHW / NDHWC activations, channels-minor for the fused
tier. One difference: the port keeps convolution weights as (O, I/groups,
*kernel) and transposed-convolution weights as (I, O/groups, *kernel) for
every layout (in channels-last memory for NHWC and NDHWC, so cuDNN runs
channels-last without a transpose), where the JAX package keeps the
channels-last ones kernel dims first (HWIO); `gluon.params_from_jax`
converts. The JAX package's deconvolution is a convolution of the
stride-dilated input with the kernel as stored, not flipped; the port's
flips the kernel before `conv_transposeNd`, which flips it back, so both
compute the same function.

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

__all__ = ["convolution", "deconvolution", "fully_connected", "batch_norm",
           "layer_norm", "group_norm", "instance_norm", "rms_norm",
           "pooling", "activation", "relu", "leaky_relu", "elu", "selu",
           "gelu", "silu", "swish", "sigmoid", "softmax", "log_softmax",
           "pick", "clamp_index", "fill_value", "take_fill", "embedding", "dropout", "scaled_dot_product_attention",
           "add",
           "multiply", "clip", "sum", "mean", "reshape", "transpose",
           "concat", "reflection_pad2d", "lstm_cell", "gru_cell",
           "rnn_relu_cell", "rnn"]

# the layouts by number of spatial dims: (channels first, channels last)
_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise MXNetError(f"expected {n} spatial values, got {v!r}")
        return tuple(int(a) for a in v)
    return (int(v),) * n


def _pair(v):
    return _tuple(v, 2)


def _channels_last(layout, nd=2):
    """True for a channels-last `layout` of `nd` spatial dims; raises for
    a layout that is neither."""
    first, last = _LAYOUTS.get(nd, (None, None))
    if layout not in (first, last):
        raise MXNetError(f"layout {layout!r} not supported for {nd}-D data "
                         f"({first} or {last})")
    return layout == last


def _to_first(x, cl):
    """Channels-last data as a channels-first view (no copy)."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)) if cl else x


def _to_last(y, cl):
    return y.permute(0, *range(2, y.ndim), 1) if cl else y


def _add_bias(y, b, cl):
    if b is None:
        return y
    return y + (b if cl else b.reshape((1, -1) + (1,) * (y.ndim - 2)))


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
    """1-D, 2-D or 3-D convolution over channels-first or channels-last
    data (the layout names the rank); `weight` is (O, I/groups, *kernel)
    for every layout. The bias is added after the product, as the JAX
    package adds it."""
    nd = data.ndim - 2
    if nd not in _CONV:
        raise MXNetError(f"convolution takes 3-D to 5-D data; got "
                         f"{data.ndim}-D")
    cl = _channels_last(layout, nd)
    b = None if no_bias else bias
    data, weight, b = amp.cast_inputs("convolution", "safe", data, weight, b)
    y = _CONV[nd](_to_first(data, cl), weight, None, _tuple(stride, nd),
                  _tuple(pad, nd), _tuple(dilate, nd), num_group)
    return _add_bias(_to_last(y, cl), b, cl)


def deconvolution(data, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_group=1, no_bias=False, layout="NCHW"):
    """1-D, 2-D or 3-D transposed convolution; `weight` is (I, O/groups,
    *kernel) for every layout, `adj` the extra size on the high side of
    each output dim. Computes the JAX package's function: the input
    dilated by the stride, padded by (k_eff - 1 - pad, k_eff - 1 - pad +
    adj) and correlated with the kernel as stored."""
    nd = data.ndim - 2
    if nd not in _DECONV:
        raise MXNetError(f"deconvolution takes 3-D to 5-D data; got "
                         f"{data.ndim}-D")
    cl = _channels_last(layout, nd)
    b = None if no_bias else bias
    data, weight, b = amp.cast_inputs("deconvolution", "safe", data, weight,
                                      b)
    y = _DECONV[nd](_to_first(data, cl), weight.flip(list(range(2, nd + 2))),
                    None, _tuple(stride, nd), _tuple(pad, nd),
                    _tuple(adj, nd), num_group, _tuple(dilate, nd))
    return _add_bias(_to_last(y, cl), b, cl)


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


def _bshape(ndim, axis, c):
    shape = [1] * ndim
    shape[axis] = c
    return shape


def _normalize(xf, axes, eps):
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over `axis` in float32 (population variance), then the
    float32 affine; the result in x's dtype (float32 under AMP)."""
    x, gamma, beta = amp.cast_inputs("layer_norm", "unsafe", x, gamma, beta)
    ax = axis % x.ndim
    if ax == x.ndim - 1:
        out = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(),
                           beta.float(), eps)
        return out.to(x.dtype)
    bshape = _bshape(x.ndim, ax, x.shape[ax])
    out = _normalize(x.float(), (ax,), eps)
    out = (out * gamma.reshape(bshape).float()
           + beta.reshape(bshape).float())
    return out.to(x.dtype)


def group_norm(x, gamma, beta, num_groups, eps=1e-5):
    """Normalize each of `num_groups` channel groups of channels-first
    data over its channels and spatial dims in float32, then the
    per-channel affine."""
    x, gamma, beta = amp.cast_inputs("group_norm", "unsafe", x, gamma, beta)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    out = _normalize(xg.float(), tuple(range(2, xg.ndim)), eps)
    out = out.reshape(x.shape)
    bshape = _bshape(x.ndim, 1, c)
    out = (out * gamma.reshape(bshape).float()
           + beta.reshape(bshape).float())
    return out.to(x.dtype)


def instance_norm(x, gamma, beta, eps=1e-5):
    """Normalize each sample's channel (axis 1) over the spatial dims in
    float32, then the per-channel affine."""
    x, gamma, beta = amp.cast_inputs("instance_norm", "unsafe", x, gamma,
                                     beta)
    out = _normalize(x.float(), tuple(range(2, x.ndim)), eps)
    bshape = _bshape(x.ndim, 1, x.shape[1])
    out = (out * gamma.reshape(bshape).float()
           + beta.reshape(bshape).float())
    return out.to(x.dtype)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """x / sqrt(mean(x^2 over `axis`) + eps) in float32, times gamma
    (broadcast over the last axis)."""
    x, gamma = amp.cast_inputs("rms_norm", "unsafe", x, gamma)
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=axis, keepdim=True) + eps)
    if gamma is not None:
        out = out * gamma.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, k, s):
    """The sum of each (k, s) window of channels-first `x` (no padding;
    1-D through the 2-D op, which takes a divisor), summed in float32 and
    rounded once to x's dtype."""
    if len(k) == 1:
        return _window_sum(x.unsqueeze(-2), (1,) + k, (1,) + s).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x.float(), k, s, divisor_override=1).to(x.dtype)


def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            ceil_mode=False):
    """1-D, 2-D or 3-D max / avg pooling with the JAX package's semantics:
    pads of -inf (max) or 0 (avg); ceil_mode extends the high pad so the
    last partial window counts; avg divides by the whole window when
    `count_include_pad` (or there is no pad), else by the valid count."""
    (x,) = amp.cast_inputs("pooling", "safe", data)
    nd = x.ndim - 2
    if nd not in _MAX_POOL:
        raise MXNetError(f"pooling takes 3-D to 5-D data; got {x.ndim}-D")
    cl = _channels_last(layout, nd)
    if pool_type not in ("max", "avg"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    if global_pool:
        axes = tuple(range(1, 1 + nd)) if cl else tuple(range(2, 2 + nd))
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.float().mean(dim=axes, keepdim=True).to(x.dtype)
    k = _tuple(kernel, nd)
    s = _tuple(stride if stride is not None else kernel, nd)
    p = _tuple(pad, nd)
    xc = _to_first(x, cl)
    pads = []
    for size, kk, ss, pp in zip(xc.shape[2:], k, s, p):
        hi = pp
        if ceil_mode:
            out = -(-(size + 2 * pp - kk) // ss) + 1
            hi = max(pp, (out - 1) * ss + kk - size - pp)
        pads.append((pp, hi))
    # F.pad takes the last dim's pair first
    fpad = [v for lo_hi in reversed(pads) for v in lo_hi]
    if pool_type == "max":
        plain = all(lo == hi for lo, hi in pads) and all(
            lo <= kk // 2 for (lo, _), kk in zip(pads, k))
        if plain:
            y = _MAX_POOL[nd](xc, k, s, p)
        else:
            y = _MAX_POOL[nd](F.pad(xc, fpad, value=-math.inf), k, s)
    else:
        tot = _window_sum(F.pad(xc, fpad), k, s)
        if count_include_pad or all(lo == 0 and hi == 0 for lo, hi in pads):
            y = tot / float(math.prod(k))
        else:
            y = tot / _window_sum(F.pad(torch.ones_like(xc), fpad), k, s)
    return _to_last(y, cl)


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
    if act_type == "log_sigmoid":
        return F.logsigmoid(x)
    if act_type == "softsign":
        return _rounded_once(F.softsign, x)
    if act_type == "mish":
        return _rounded_once(lambda v: v * torch.tanh(F.softplus(v)), x)
    raise ValueError(f"unknown activation {act_type!r}")


def _rounded_once(fn, x):
    """A composite elementwise function of a 16-bit `x` computed in float32
    and rounded once, as XLA's fusion computes it for the JAX package
    (op by op in 16 bits, each step would round, forward and backward)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return fn(x.float()).to(x.dtype)
    return fn(x)


def activation(x, act_type):
    """relu / sigmoid / tanh / softrelu / softsign / log_sigmoid / mish."""
    (x,) = amp.cast_inputs("activation", "neutral", x)
    return _act(x, act_type)


def relu(x):
    (x,) = amp.cast_inputs("relu", "neutral", x)
    return torch.relu(x)


def gelu(x, approximate=False):
    """GELU: exact (erf), or the tanh approximation."""
    (x,) = amp.cast_inputs("gelu", "neutral", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, act_type="leaky", slope=0.25, gamma=None):
    """x where x >= 0, else `slope` * x ("leaky") or `gamma` * x ("prelu";
    gamma broadcasts against x's trailing axes, as in the JAX package)."""
    x, gamma = amp.cast_inputs("leaky_relu", "neutral", x, gamma)
    if act_type == "leaky":
        return torch.where(x >= 0, x, x * slope)
    if act_type == "prelu":
        return torch.where(x >= 0, x, gamma * x)
    raise ValueError(f"unknown leaky_relu type {act_type!r}")


def elu(x, alpha=1.0):
    (x,) = amp.cast_inputs("elu", "neutral", x)
    return F.elu(x, alpha)


def selu(x):
    (x,) = amp.cast_inputs("selu", "neutral", x)
    return F.selu(x)


def silu(x):
    (x,) = amp.cast_inputs("silu", "neutral", x)
    return F.silu(x)


def swish(x, beta):
    """x * sigmoid(beta * x), rounded once for a 16-bit x."""
    (x,) = amp.cast_inputs("swish", "neutral", x)
    return _rounded_once(lambda v: v * torch.sigmoid(beta * v), x)


def sigmoid(x):
    (x,) = amp.cast_inputs("sigmoid", "neutral", x)
    return torch.sigmoid(x)


def softmax(x, axis=-1):
    (x,) = amp.cast_inputs("softmax", "unsafe", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    (x,) = amp.cast_inputs("log_softmax", "unsafe", x)
    return torch.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """Select one element along `axis` per position. The indices are
    clipped to the axis in every `mode` ("clip" or "wrap"), as the JAX
    package clips them."""
    axis = axis % x.ndim
    idx = index.to(device=x.device, dtype=torch.int64).clamp(
        0, x.shape[axis] - 1)
    picked = torch.gather(x, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


def clamp_index(indices, n):
    """`indices` as int64 positions along an axis of size `n` as XLA's
    gathers read them: a negative one counts from the end, and what is
    still outside [0, n) is clamped to the nearest end. (PyTorch's index
    kernels raise instead, on the card through a device-side assert that
    leaves the context unusable.)"""
    idx = indices.to(torch.int64)
    if n == 0:
        return idx
    # [-n, n) first, then the negative ones from the end: two launches
    return torch.remainder(idx.clamp(-n, n - 1), n)


def fill_value(dtype):
    """What XLA's gathers in fill mode read at an out-of-range position:
    NaN for a float type, the lowest value of a signed integer type, the
    highest of an unsigned one, True for bool."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_fill(x, indices, dim, fill=None):
    """`torch.take_along_dim(x, indices, dim)` as the JAX package's
    `take_along_axis` reads it (XLA's fill mode): an index with
    -n <= i < 0 counts from the end, and a position whose index is still
    outside [0, n) reads `fill` (default `fill_value(x.dtype)`), with a
    zero gradient. The
    gather itself reads a clamped index, so neither device reads past the
    axis (the card would assert)."""
    dim %= x.dim()
    n = x.shape[dim]
    idx = indices.to(device=x.device, dtype=torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    if n == 0:
        # XLA's gather of an empty axis reads zeros, the JAX package's too
        shape = list(torch.broadcast_shapes(x.shape[:dim] + (1,)
                                            + x.shape[dim + 1:], idx.shape))
        shape[dim] = idx.shape[dim]
        return x.new_zeros(shape)
    fill = torch.tensor(fill_value(x.dtype) if fill is None else fill,
                        dtype=x.dtype, device=x.device)
    out = torch.take_along_dim(x, idx.clamp(0, n - 1), dim=dim)
    return torch.where(bad, fill, out)


def embedding(indices, weight):
    """Rows of `weight` (input_dim, output_dim) gathered by `indices`; an
    index outside the rows reads as `clamp_index` places it, as the JAX
    package's `weight[indices]` does."""
    (weight,) = amp.cast_inputs("embedding", "neutral", weight)
    return F.embedding(
        clamp_index(indices.to(weight.device), weight.shape[0]), weight)


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


def clip(x, a_min, a_max):
    (x,) = amp.cast_inputs("clip", "neutral", x)
    return torch.clamp(x, a_min, a_max)


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


def concat(arrays, axis=-1):
    """`arrays` joined along `axis` (the JAX package's `concatenate`)."""
    arrays = amp.cast_inputs("concatenate", "neutral", *arrays)
    return torch.cat(arrays, dim=axis)


def reflection_pad2d(x, padding):
    """Reflect-pad the last two dims of NCHW data by `padding` = (left,
    right, top, bottom), the edge row not repeated (numpy's "reflect")."""
    (x,) = amp.cast_inputs("pad", "neutral", x)
    return F.pad(x, tuple(padding), mode="reflect")


# ---------------------------------------------------------------------------
# recurrent cells and the fused multi-layer RNN (the JAX package's lax.scan
# over packed per-layer weights). A single cell is its products
# (torch.matmul / addmm) and `ops.rnn.cell`, its elementwise step. The fused
# RNN takes each (layer, direction) by `kernels.rnn_layer_route`: on
# "persistent" the whole time loop is `ops.rnn.layer` (one CUDA kernel
# launch each way on the card); on "per_step" the loop below launches the
# recurrent product and the cell once a step. On the CPU both run the
# kernels' plain versions.
# ---------------------------------------------------------------------------
def _gates(x, w, b=None):
    """x W^T (+ b) over the last axis of x."""
    if b is None:
        return torch.matmul(x, w.t())
    if x.dim() == 2:
        return torch.addmm(b, x, w.t())
    return torch.matmul(x, w.t()) + b


def lstm_cell(x, h, c, wx, wh, b):
    """One LSTM step (gates [i, f, g, o], bias b = bx + bh): (h', c')."""
    from . import rnn as _rnn
    return _rnn.cell("lstm", _gates(x, wx, b), _gates(h, wh), h, c)


def gru_cell(x, h, wx, wh, bx, bh):
    """One GRU step (gates [r, z, n], n = tanh(nx + r nh)): h'."""
    from . import rnn as _rnn
    return _rnn.cell("gru", _gates(x, wx, bx), _gates(h, wh, bh), h)


def rnn_relu_cell(x, h, wx, wh, b, act="tanh"):
    """One Elman step act(x Wx^T + h Wh^T + b), act "relu" or "tanh"."""
    from . import rnn as _rnn
    return _rnn.cell("rnn", _gates(x, wx, b), _gates(h, wh), h,
                     act="relu" if act == "relu" else "tanh")


def _scan_layer(step, gx_steps, h, c, reverse=False):
    """Run `step(gx_t, h, c) -> (h, c)` over the time steps `gx_steps`
    (backwards with `reverse`); returns (h_T, c_T, outputs stacked in time
    order)."""
    T = len(gx_steps)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = step(gx_steps[t], h, c)
        ys[t] = h
    return h, c, torch.stack(ys, 0)


_RNN_CELL = {"lstm": ("lstm", "tanh"), "gru": ("gru", "tanh"),
             "rnn_tanh": ("rnn", "tanh"), "rnn_relu": ("rnn", "relu")}


def rnn(x, params, state, mode="lstm", num_layers=1, hidden_size=None,
        bidirectional=False, dropout_rate=0.0, generator=None,
        training=False):
    """Multi-layer (bi)directional RNN over time-major x (T, N, C).

    `params` {(layer, direction): {"wx", "wh", "bx", "bh"}}, `state` (h0,)
    or (h0, c0) of shape (L D, N, H), as the JAX package's `ops.nn.rnn`.
    Returns (output (T, N, H D), new state tuple). The input product of a
    layer and direction is one product over all T N rows, ahead of the
    time loop. The loop is `ops.rnn.layer` where `kernels.rnn_layer_route`
    says "persistent" (for the shape, and on the card for its SM count),
    else one recurrent product and cell step at a time. Dropout of
    `dropout_rate` between layers in training, its masks drawn from
    `generator` (the port's, not jax.random: the masks differ from the
    JAX package's)."""
    from . import kernels, rnn as _rnn
    if mode not in _RNN_CELL:
        raise MXNetError(f"unknown rnn mode {mode!r}")
    cell_mode, act = _RNN_CELL[mode]
    ndir = 2 if bidirectional else 1
    h0 = state[0]
    c0 = state[1] if mode == "lstm" else None
    out = x
    T, N = x.shape[0], x.shape[1]
    h_list, c_list = [], []
    for layer in range(num_layers):
        dir_outs = []
        for d in range(ndir):
            p = params[(layer, d)]
            idx = layer * ndir + d
            # the GRU keeps bh in the recurrent product (n = act(nx + r nh))
            gru = mode == "gru"
            bias = p["bx"] if gru else p["bx"] + p["bh"]
            gx = torch.addmm(bias, out.reshape(T * N, -1), p["wx"].t())
            H = p["wh"].shape[1]
            cuda = gx.device.type == "cuda"
            route = kernels.rnn_layer_route(
                cell_mode, N, H, gx.dtype,
                kernels.rnn_sms(gx.device) if cuda
                else kernels.RNN_LAYER_SMS)
            if route == "persistent":
                res = _rnn.layer(cell_mode, gx.reshape(T, N, -1), p["wh"],
                                 h0[idx], None if c0 is None else c0[idx],
                                 p["bh"] if gru else None, act,
                                 reverse=(d == 1))
                ys, hT = res[0], res[1]
                cT = res[2] if mode == "lstm" else None
            else:
                if cuda:
                    kernels.count_per_step_layer()

                def step(g, h, c, wh=p["wh"], bh=p["bh"] if gru else None):
                    new = _rnn.cell(cell_mode, g, _gates(h, wh, bh), h, c,
                                    act)
                    return new if mode == "lstm" else (new, None)
                hT, cT, ys = _scan_layer(
                    step, gx.reshape(T, N, -1).unbind(0),
                    h0[idx].to(gx.dtype),
                    None if c0 is None else c0[idx].to(gx.dtype),
                    reverse=(d == 1))
            h_list.append(hT)
            if mode == "lstm":
                c_list.append(cT)
            dir_outs.append(ys)
        out = dir_outs[0] if ndir == 1 else torch.cat(dir_outs, dim=-1)
        if dropout_rate > 0 and training and layer < num_layers - 1:
            out = dropout(out, dropout_rate, generator, training=True)
    h_out = torch.stack(h_list, 0)
    if mode == "lstm":
        return out, (h_out, torch.stack(c_list, 0))
    return out, (h_out,)
