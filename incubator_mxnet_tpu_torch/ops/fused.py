"""Fused ops of the PyTorch port: each a hand-written CUDA kernel for
tensors on the card and a plain PyTorch version for tensors on the CPU.

Counterpart of `incubator_mxnet_tpu/ops/fused.py`:

  op                 kernel (ops/csrc)                  TPU kernel replaced
  -----------------  ---------------------------------  ----------------------
  bias_act           scale_shift_act.cu                 apply_scale_shift_act
  norm_act_residual  scale_shift_act.cu                 apply_scale_shift_act
  bn_inference       scale_shift_act.cu                 apply_scale_shift_act
  batch_norm         scale_shift_act.cu (apply pass)    apply_scale_shift_act
  avg_pool2d         avg_pool2d.cu (forward, backward)  avg_pool2d_fwd / _bwd
  paged_attention    paged_attention.cu                 paged_attention_fwd
  image_augment      image_augment.cu                   none (port-only)

The dispatch is by the device of the tensors alone: a CPU tensor takes the
plain version, a CUDA tensor takes the kernel or raises. No environment
variable, exception handler or shape test sends a CUDA tensor to the plain
version (the JAX package's untileable-shape fallback is not carried over).
The plain versions (`*_ref`) are also the oracles the kernels are held
against on the card.

The apply ops are `torch.autograd.Function`s, one per arity, whose
backward is plain torch ops, as the JAX package's `custom_vjp` backward is
jnp: recompute the pre-activation in f32, apply the activation's
derivative, then dx = g*scale, dscale = sum over rows of g*x, dshift = sum
over rows of g (and g itself for the residual). `avg_pool2d`'s backward is
a kernel, as the JAX package's is a Pallas kernel.

Gating (`fusion_scope`, `set_fusion_default`, `fusion_enabled`) decides
only whether Gluon blocks take these ops; once taken, the device decides
the path. Under AMP each public op casts
its inputs as the JAX package's npx wrappers do: `bias_act` and
`avg_pool2d` are `safe` (the target dtype), the batch-norm family and
`norm_act_residual` are `unsafe` (float32).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from .. import amp
from ..base import MXNetError
from . import kernels

__all__ = ["bias_act", "norm_act_residual", "bn_inference", "batch_norm",
           "avg_pool2d", "paged_attention", "image_augment",
           "image_augment_ref", "augment_draws",
           "bias_act_ref", "norm_act_residual_ref", "bn_inference_ref",
           "avg_pool2d_ref", "avg_pool2d_bwd_ref", "apply_ref",
           "paged_attention_ref",
           "fusion_scope", "fusion_enabled", "set_fusion_default",
           "contiguous_counted", "layout_copies", "reset_layout_copies",
           "FUSABLE_ACTS"]

# activations the apply kernel (and its backward) take; None = identity
FUSABLE_ACTS = (None, "relu", "sigmoid", "tanh", "silu", "gelu")


# ---------------------------------------------------------------------------
# gating: the active scope, else the process default
# ---------------------------------------------------------------------------
_SCOPE = threading.local()
_DEFAULT = [False]


@contextmanager
def fusion_scope(active=True):
    """Enable (or force-disable) the fused-op routing of Gluon blocks for
    the dynamic extent; `FusedTrainStep` enters one around its forward."""
    prev = getattr(_SCOPE, "value", None)
    _SCOPE.value = bool(active)
    try:
        yield
    finally:
        _SCOPE.value = prev


def set_fusion_default(flag):
    """Process-wide default outside any fusion_scope. Returns the
    previous default."""
    prev = _DEFAULT[0]
    _DEFAULT[0] = bool(flag)
    return prev


def fusion_enabled():
    """True when Gluon blocks should route through the fused ops: the
    active scope's flag, else the process default."""
    v = getattr(_SCOPE, "value", None)
    return _DEFAULT[0] if v is None else v


# ---------------------------------------------------------------------------
# explicit layout copies: the kernels raise on a strided view, so a caller
# that has one copies it here, where the copy is counted
# ---------------------------------------------------------------------------
_COPIES = [0]


def contiguous_counted(t):
    """`t` if contiguous, else a contiguous copy, counted in
    `layout_copies()`."""
    if t.is_contiguous():
        return t
    _COPIES[0] += 1
    return t.contiguous()


def layout_copies():
    """Copies `contiguous_counted` made since the last reset."""
    return _COPIES[0]


def reset_layout_copies():
    _COPIES[0] = 0


# ---------------------------------------------------------------------------
# plain versions — the CPU path AND the kernels' oracles
# ---------------------------------------------------------------------------
def _act32(u, act_type):
    if act_type is None:
        return u
    if act_type == "relu":
        return torch.relu(u)
    if act_type == "sigmoid":
        return torch.sigmoid(u)
    if act_type == "tanh":
        return torch.tanh(u)
    if act_type == "silu":
        return F.silu(u)
    if act_type == "gelu":
        return F.gelu(u, approximate="none")
    raise ValueError(f"unsupported fused activation {act_type!r}")


def _act_grad(u, ct, act_type):
    """d(act)/du at `u` applied to the cotangent `ct`, both f32."""
    if act_type is None:
        return ct
    if act_type == "relu":
        return torch.where(u > 0, ct, torch.zeros_like(ct))
    if act_type == "sigmoid":
        s = torch.sigmoid(u)
        return ct * (s * (1.0 - s))
    if act_type == "tanh":
        t = torch.tanh(u)
        return ct * (1.0 - t * t)
    if act_type == "silu":
        s = torch.sigmoid(u)
        return ct * (s * (1.0 + u * (1.0 - s)))
    if act_type == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(u * (1.0 / math.sqrt(2.0))))
        pdf = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
        return ct * (cdf + u * pdf)
    raise ValueError(f"unsupported fused activation {act_type!r}")


def _bshape(ndim, axis, c):
    shape = [1] * ndim
    shape[axis] = c
    return shape


def apply_ref(x, scale, shift, residual, act_type, axis=-1):
    """act(x [*scale] [+ shift] [+ residual]): f32 inside, cast to x's
    dtype on the way out — the plain version of the apply kernel."""
    axis = axis % x.ndim
    bshape = _bshape(x.ndim, axis, x.shape[axis])
    u = x.float()
    if scale is not None:
        u = u * scale.reshape(bshape).float()
    if shift is not None:
        u = u + shift.reshape(bshape).float()
    if residual is not None:
        u = u + residual.float()
    return _act32(u, act_type).to(x.dtype)


def bias_act_ref(x, bias, act_type="relu", axis=-1):
    """Plain composition of bias_act."""
    return apply_ref(x, None, bias, None, act_type, axis)


def norm_act_residual_ref(x, scale, shift, residual, act_type="relu",
                          axis=-1):
    """Plain composition of norm_act_residual."""
    return apply_ref(x, scale, shift, residual, act_type, axis)


def _fold_bn(gamma, beta, mean, var, eps):
    """(scale, shift) f32 fold of the BN affine: scale = gamma*rsqrt(var
    + eps), shift = beta - mean*scale (gamma/beta optional)."""
    inv = torch.rsqrt(var.float() + eps)
    scale = inv if gamma is None else gamma.float() * inv
    shift = -mean.float() * scale
    if beta is not None:
        shift = shift + beta.float()
    return scale, shift


def bn_inference_ref(x, gamma, beta, mean, var, eps=1e-5, axis=-1,
                     act_type=None, residual=None):
    """Plain composition of bn_inference."""
    scale, shift = _fold_bn(gamma, beta, mean, var, eps)
    return apply_ref(x, scale, shift, residual, act_type, axis)


def avg_pool2d_ref(x, pool_size, layout="NHWC"):
    """Plain non-overlapping NHWC average pool (f32 reshape + mean)."""
    ph, pw = pool_size
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h // ph, ph, w // pw, pw, c)
    return xf.mean(dim=(2, 4)).to(x.dtype)


def avg_pool2d_bwd_ref(dy, h, w, ph, pw):
    """Plain gradient of the pool: dY / (ph*pw) broadcast over each
    window, f32 inside, in dy's dtype."""
    n, ho, wo, c = dy.shape
    g = dy.float() * (1.0 / (ph * pw))
    g = g[:, :, None, :, None, :].expand(n, ho, ph, wo, pw, c)
    return g.reshape(n, h, w, c).to(dy.dtype)


def paged_attention_ref(q, k_slab, v_slab, lengths, layer, k_scale=None,
                        v_scale=None):
    """Plain paged decode attention over the serve KV-pool slab. Reads the
    WHOLE (S, T) page of each lane and masks to `[0, lengths + j]` for
    chunk query j; f32 arithmetic inside, output in q's dtype.

    `q`: (S, C, H, D) — C chunk queries per lane at positions
    `lengths[s] + j`. `k_slab`/`v_slab`: (rows, layers, T, H, D) with
    rows > S (lane s reads row s), possibly a view cut on the position
    axis, of any float dtype (q's or another), or int8 codes.
    `k_scale`/`v_scale`: the per-position f32 dequant scales
    (rows, layers, T) of int8 slabs, applied as `codes.float() * scale`
    before the score product, as the TPU kernel does. `lengths`: (S,)
    integer."""
    s_lanes, c, _h, d = q.shape
    t = k_slab.shape[2]
    kk = k_slab[:s_lanes, layer].float()
    vv = v_slab[:s_lanes, layer].float()
    if k_scale is not None:
        kk = kk * k_scale[:s_lanes, layer][..., None, None]
    if v_scale is not None:
        vv = vv * v_scale[:s_lanes, layer][..., None, None]
    scores = torch.einsum("schd,sthd->shct", q.float(), kk) * (
        1.0 / float(d) ** 0.5)
    pos = torch.arange(t, device=q.device)
    lim = lengths.to(device=q.device, dtype=torch.int64)[:, None] \
        + torch.arange(c, device=q.device)[None, :]             # (S, C)
    mask = pos[None, None, :] <= lim[:, :, None]                 # (S, C, T)
    scores = scores.masked_fill(~mask[:, None], -1e30)
    att = torch.einsum("shct,sthd->schd", torch.softmax(scores, dim=-1), vv)
    return att.to(q.dtype)


# ---------------------------------------------------------------------------
# device dispatch of the kernels
# ---------------------------------------------------------------------------
def _no_path(name, t):
    return MXNetError(f"{name}: no path for device {t.device}")


def _apply_fwd(x2d, scale, shift, res, act_type):
    dev = x2d.device.type
    if dev == "cuda":
        return kernels.scale_shift_act_cuda(x2d, scale, shift, res, act_type)
    if dev == "cpu":
        return apply_ref(x2d, scale, shift, res, act_type, -1)
    raise _no_path("scale_shift_act", x2d)


def _apply_bwd(ctx, ct, x2d, scale, shift, res):
    """(dx, dscale, dshift, dres) of act(x*scale + shift + res), each None
    where its input is absent or needs no gradient."""
    xf = x2d.float()
    u = xf if scale is None else xf * scale
    u = u + shift
    if res is not None:
        u = u + res.float()
    g = _act_grad(u, ct.float(), ctx.act_type)
    dx = (g if scale is None else g * scale).to(x2d.dtype)
    dscale = (g * xf).sum(0) if scale is not None else None
    dshift = g.sum(0)
    dres = g.to(res.dtype) if res is not None else None
    return dx, dscale, dshift, dres


class _BiasAct(torch.autograd.Function):
    """act(x2d + shift) over (M, C); shift (C,) float32."""

    @staticmethod
    def forward(ctx, x2d, shift, act_type):
        ctx.act_type = act_type
        ctx.save_for_backward(x2d, shift)
        return _apply_fwd(x2d, None, shift, None, act_type)

    @staticmethod
    def backward(ctx, ct):
        x2d, shift = ctx.saved_tensors
        dx, _, dshift, _ = _apply_bwd(ctx, ct, x2d, None, shift, None)
        return dx, dshift, None


class _ScaleShiftAct(torch.autograd.Function):
    """act(x2d*scale + shift) over (M, C); scale/shift (C,) float32."""

    @staticmethod
    def forward(ctx, x2d, scale, shift, act_type):
        ctx.act_type = act_type
        ctx.save_for_backward(x2d, scale, shift)
        return _apply_fwd(x2d, scale, shift, None, act_type)

    @staticmethod
    def backward(ctx, ct):
        x2d, scale, shift = ctx.saved_tensors
        dx, dscale, dshift, _ = _apply_bwd(ctx, ct, x2d, scale, shift, None)
        return dx, dscale, dshift, None


class _ScaleShiftActResidual(torch.autograd.Function):
    """act(x2d*scale + shift + res) over (M, C); res of x2d's dtype."""

    @staticmethod
    def forward(ctx, x2d, scale, shift, res, act_type):
        ctx.act_type = act_type
        ctx.save_for_backward(x2d, scale, shift, res)
        return _apply_fwd(x2d, scale, shift, res, act_type)

    @staticmethod
    def backward(ctx, ct):
        x2d, scale, shift, res = ctx.saved_tensors
        dx, dscale, dshift, dres = _apply_bwd(ctx, ct, x2d, scale, shift,
                                              res)
        return dx, dscale, dshift, dres, None


def _apply(x, scale, shift, residual, act_type, axis):
    """One apply through the kernel's autograd Function over the (M, C)
    view of `x` (channels on the last axis). A CUDA tensor must be
    contiguous with its channels last: otherwise this raises, and the
    caller makes (and counts) the copy with `contiguous_counted`."""
    if act_type not in FUSABLE_ACTS:
        raise ValueError(f"unsupported fused activation {act_type!r}; "
                         f"supported: {FUSABLE_ACTS}")
    if axis % x.ndim != x.ndim - 1:
        if x.is_cuda:
            raise MXNetError("the fused apply kernel takes the channel axis "
                             "last (NHWC); use layout='NHWC'")
        return apply_ref(x, scale, shift, residual, act_type, axis)
    if x.is_cuda and not (x.is_contiguous() and (
            residual is None or residual.is_contiguous())):
        raise MXNetError("the fused apply kernel takes contiguous tensors; "
                         "copy with ops.fused.contiguous_counted first")
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    shift = shift.float()
    if scale is None:
        out = _BiasAct.apply(x2d, shift, act_type)
    elif residual is None:
        out = _ScaleShiftAct.apply(x2d, scale.float(), shift, act_type)
    else:
        res2d = residual.to(x.dtype).reshape(-1, c)
        out = _ScaleShiftActResidual.apply(x2d, scale.float(), shift, res2d,
                                           act_type)
    return out.reshape(x.shape)


class _AvgPool2d(torch.autograd.Function):
    """Non-overlapping NHWC average pool with the pooling backward."""

    @staticmethod
    def forward(ctx, x, ph, pw):
        ctx.pool = (x.shape[1], x.shape[2], ph, pw)
        dev = x.device.type
        if dev == "cuda":
            return kernels.avg_pool2d_fwd_cuda(x, ph, pw)
        if dev == "cpu":
            return avg_pool2d_ref(x, (ph, pw))
        raise _no_path("avg_pool2d", x)

    @staticmethod
    def backward(ctx, dy):
        h, w, ph, pw = ctx.pool
        dev = dy.device.type
        if dev == "cuda":
            return (kernels.avg_pool2d_bwd_cuda(contiguous_counted(dy), h, w,
                                                ph, pw), None, None)
        if dev == "cpu":
            return avg_pool2d_bwd_ref(dy, h, w, ph, pw), None, None
        raise _no_path("avg_pool2d", dy)


# ---------------------------------------------------------------------------
# public fused ops
# ---------------------------------------------------------------------------
def bias_act(x, bias, act_type="relu", axis=-1):
    """Fused y = act(x + bias) with per-channel bias on `axis`."""
    x, bias = amp.cast_inputs("fused_bias_act", "safe", x, bias)
    return _apply(x, None, bias, None, act_type, axis)


def norm_act_residual(x, scale, shift, residual, act_type="relu", axis=-1):
    """Fused y = act(x*scale + shift + residual): the normalize-apply /
    activation / residual-add tail of a residual block in one pass."""
    x, scale, shift, residual = amp.cast_inputs(
        "fused_norm_act_residual", "unsafe", x, scale, shift, residual)
    return _apply(x, scale, shift, residual, act_type, axis)


def bn_inference(x, gamma, beta, mean, var, eps=1e-5, axis=-1,
                 act_type=None, residual=None):
    """Folded BN-inference scale/shift (+ optional act/residual) in one
    fused apply pass."""
    x, gamma, beta, mean, var, residual = amp.cast_inputs(
        "fused_bn_inference", "unsafe", x, gamma, beta, mean, var, residual)
    scale, shift = _fold_bn(gamma, beta, mean, var, eps)
    return _apply(x, scale, shift, residual, act_type, axis)


def batch_norm(x, gamma, beta, running_mean, running_var, momentum=0.9,
               eps=1e-5, training=True, axis=1, use_global_stats=False,
               act_type=None, residual=None):
    """Batch norm with the apply stage routed through the fused kernel.

    The JAX package's stats protocol exactly: f32 moments, var = E[x^2] -
    E[x]^2 (biased), new_rm = momentum*rm + (1-momentum)*mean and the same
    for the biased var. Returns (out, new_rm, new_rv); the new stats carry
    no gradient. Gradients flow through the batch moments into x: scale
    and shift are tracked functions of them, and the apply's backward
    chains through."""
    x, gamma, beta, running_mean, running_var, residual = amp.cast_inputs(
        "fused_batch_norm", "unsafe", x, gamma, beta, running_mean,
        running_var, residual)
    reduce_axes = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
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
    scale, shift = _fold_bn(gamma, beta, mean, var, eps)
    out = _apply(x, scale, shift, residual, act_type, axis)
    return out, new_rm, new_rv


def avg_pool2d(x, pool_size, layout="NHWC"):
    """Non-overlapping (kernel == stride, no padding) NHWC average pool,
    GlobalAvgPool2D's shape included (pool_size = the spatial dims), whose
    backward is the pooling-backward kernel on the card; float32, bfloat16
    and float16 reach the kernels."""
    ph, pw = (pool_size, pool_size) if isinstance(pool_size, int) \
        else tuple(pool_size)
    if layout != "NHWC" or x.ndim != 4:
        raise ValueError("fused avg_pool2d is NHWC 2-D only "
                         f"(got layout={layout!r}, ndim={x.ndim})")
    n, h, w, c = x.shape
    if h % ph or w % pw:
        raise ValueError(f"pool {ph}x{pw} must divide spatial dims "
                         f"{h}x{w} (non-overlapping pooling)")
    (x,) = amp.cast_inputs("fused_avg_pool2d", "safe", x)
    return _AvgPool2d.apply(x, ph, pw)


def paged_attention(q, k_slab, v_slab, lengths, layer, k_scale=None,
                    v_scale=None):
    """Paged decode attention over the slotted KV slab — the serve
    engine's per-layer attention read, in place (no per-layer copy of the
    cache). int8 slabs come with their per-position `k_scale`/`v_scale`.
    CUDA tensors launch the kernel (`ops/csrc/paged_attention.cu`), CPU
    tensors take `paged_attention_ref`."""
    dev = q.device.type
    if dev == "cuda":
        return kernels.paged_attention_cuda(q, k_slab, v_slab, lengths,
                                            layer, k_scale, v_scale)
    if dev == "cpu":
        return paged_attention_ref(q, k_slab, v_slab, lengths, layer,
                                   k_scale, v_scale)
    raise _no_path("paged_attention", q)


# ---------------------------------------------------------------------------
# the input path's augment: crop, mirror, 1/255, mean/std, cast
# ---------------------------------------------------------------------------
def _crop_hw(images, crop_hw):
    h, w = int(images.shape[1]), int(images.shape[2])
    return (h, w) if crop_hw is None else (int(crop_hw[0]), int(crop_hw[1]))


def _start(v, size, window):
    """lax.dynamic_slice's start: negative from the end, then clamped into
    [0, size - window]."""
    v = v.long()
    return torch.where(v < 0, v + size, v).clamp(0, size - window)


def _norm_consts(v):
    """mean / std as a tuple of floats (a scalar as one entry), or None."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    try:
        return tuple(float(u) for u in v)
    except TypeError:   # not a sequence, or a nested one
        pass
    try:
        return (float(v),)
    except TypeError:
        raise MXNetError("image_augment: mean and std are a scalar or a "
                         f"1-D sequence of floats; got {v!r}") from None


# what the augment reads a 64-bit integer image as: JAX with 64-bit types
# off narrows it to int32 (the port's arrays do the same, base._TO_TORCH);
# uint16 fits int32
_AUGMENT_NARROW = {torch.int64: torch.int32, torch.uint16: torch.int32}


def _augment_plan(images, crop_hw, mean, std):
    """(ch, cw, channels read, output channels), or MXNetError for what
    the JAX package refuses too (`kernels.refusal`)."""
    n, h, w, c = images.shape
    ch, cw = _crop_hw(images, crop_hw)
    lm, ls = (None if v is None else len(v) for v in (mean, std))
    why = kernels.refusal("image_augment", h=h, w=w, ch=ch, cw=cw, c=c,
                          lm=lm, ls=ls)
    if why is not None:
        raise MXNetError(f"image_augment: {why}")
    return (ch, cw) + kernels.augment_channels(c, (ch, cw) != (h, w), lm, ls)


def image_augment_ref(images, y0, x0, flips, crop_hw=None, mean=None,
                      std=None, out_dtype=torch.float32):
    """The plain version of the augment kernel, the JAX package's jnp chain
    (`ops/fused.py:500` there) on explicit draws: integer pixels times 1/255
    (bool as 0 / 1, a float input as float32; int64 narrowed to int32
    first), each image cut at (y0[n], x0[n]) to `crop_hw` (an offset read
    as lax.dynamic_slice reads a start: negative from the end, then
    clamped so the crop fits) keeping the first 3 channels when the crop
    cuts, mirrored where flips[n], minus `mean`, over `std` (each
    broadcast over the channels as numpy broadcasts), cast to `out_dtype`.
    Each step is its own rounded op. Refuses what the JAX package refuses
    (`kernels.refusal`)."""
    mean, std = _norm_consts(mean), _norm_consts(std)
    ch, cw, _, _ = _augment_plan(images, crop_hw, mean, std)
    x = images.to(_AUGMENT_NARROW.get(images.dtype, images.dtype))
    if x.is_floating_point() or x.dtype == torch.bool:
        x = x.to(torch.float32)
    else:
        x = x.to(torch.float32) * (1.0 / 255.0)
    n, h, w = x.shape[:3]
    if (ch, cw) != (h, w):
        dev = x.device
        rows = _start(y0, h, ch)[:, None] + torch.arange(ch, device=dev)
        cols = _start(x0, w, cw)[:, None] + torch.arange(cw, device=dev)
        x = x[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
              cols[:, None, :], :3]
    if flips is not None:
        x = torch.where(flips.bool()[:, None, None, None], x.flip(2), x)
    if mean is not None:
        x = x - torch.tensor(mean, dtype=torch.float32, device=x.device)
    if std is not None:
        x = x / torch.tensor(std, dtype=torch.float32, device=x.device)
    return x.to(out_dtype)


def augment_table_ref(in_dtype, cout, mean=None, std=None,
                      out_dtype=torch.float32, device="cpu"):
    """The lookup table the kernel's "table" route builds in each block, in
    plain torch: (cout, 256) entries of `out_dtype`, entry [c, v] the
    augment of the 8-bit pattern v of `in_dtype` (uint8, int8 or bool)
    through output channel c's mean and std, by the same rounded ops as
    `image_augment_ref`; gathering it at each pixel's byte gives the
    augment bit for bit."""
    v = torch.arange(256, device=device).to(torch.uint8)
    if in_dtype == torch.int8:
        v = v.view(torch.int8)
    x = v.to(torch.float32)
    if in_dtype != torch.bool:
        x = x * (1.0 / 255.0)
    x = x[None, :].expand(cout, 256)
    mean, std = _norm_consts(mean), _norm_consts(std)
    if mean is not None:
        x = x - torch.tensor(mean, dtype=torch.float32, device=device)[:, None]
    if std is not None:
        x = x / torch.tensor(std, dtype=torch.float32, device=device)[:, None]
    return x.to(out_dtype)


def _augment_fwd(images, y0, x0, flips, crop_hw, mean, std, out_dtype):
    dev = images.device.type
    if dev == "cuda":
        ch, cw = _crop_hw(images, crop_hw)
        if (ch, cw) == tuple(images.shape[1:3]):
            y0 = x0 = None
        return kernels.image_augment_cuda(images, y0, x0, flips, (ch, cw),
                                          mean, std, out_dtype)
    if dev == "cpu":
        return image_augment_ref(images, y0, x0, flips, crop_hw, mean, std,
                                 out_dtype)
    raise _no_path("image_augment", images)


class _ImageAugment(torch.autograd.Function):
    """The augment of a float input with its gradient: the JAX package
    differentiates through the affine (XLA's backward, not a Pallas
    kernel), so the backward is plain torch ops: grad / std, un-mirrored,
    summed over the channels a 1-channel image broadcast to, scattered
    into each image's crop window (the first 3 channels under a crop that
    cuts), in the input's dtype."""

    @staticmethod
    def forward(ctx, images, y0, x0, flips, crop_hw, mean, std, out_dtype):
        ctx.save_for_backward(y0, x0, flips)
        ch, cw, cr, _ = _augment_plan(images, crop_hw, mean, std)
        ctx.meta = (tuple(images.shape), images.dtype, (ch, cw), cr, std)
        return _augment_fwd(images, y0, x0, flips, crop_hw, mean, std,
                            out_dtype)

    @staticmethod
    def backward(ctx, g):
        y0, x0, flips = ctx.saved_tensors
        (n, h, w, c), dtype, (ch, cw), cr, std = ctx.meta
        g = g.to(torch.float32)
        if std is not None:
            g = g / torch.tensor(std, dtype=torch.float32, device=g.device)
        if flips is not None:
            g = torch.where(flips.bool()[:, None, None, None], g.flip(2), g)
        if g.shape[3] != cr:
            g = g.sum(3, keepdim=True)
        if (ch, cw) != (h, w):
            dev = g.device
            dx = torch.zeros((n, h, w, c), dtype=torch.float32, device=dev)
            rows = _start(y0, h, ch)[:, None] + torch.arange(ch,
                                                             device=dev)
            cols = _start(x0, w, cw)[:, None] + torch.arange(cw,
                                                             device=dev)
            dx[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
               cols[:, None, :], :cr] = g
            g = dx
        return g.to(dtype), None, None, None, None, None, None, None


def _augment_apply(images, y0, x0, flips, crop_hw=None, mean=None, std=None,
                   out_dtype=torch.float32):
    """The augment on explicit draws (int32 offsets y0 / x0 of shape (N,)
    or None, flips (N,) or None): the kernel for a CUDA batch, the plain
    version for a CPU one; a float input that requires a gradient gets
    one. int64 images are narrowed to int32 first, float16, bfloat16 and
    float64 ones cast to float32."""
    mean, std = _norm_consts(mean), _norm_consts(std)
    if images.is_floating_point():
        images = images if images.dtype == torch.float32 \
            else images.to(torch.float32)
        if images.requires_grad and torch.is_grad_enabled():
            return _ImageAugment.apply(images, y0, x0, flips, crop_hw, mean,
                                       std, out_dtype)
    elif images.dtype in _AUGMENT_NARROW:
        images = images.to(_AUGMENT_NARROW[images.dtype])
    return _augment_fwd(images, y0, x0, flips, crop_hw, mean, std,
                        out_dtype)


def augment_draws(key, n, hw, crop_hw, rand_mirror, device):
    """(y0, x0, flips) for a batch of `n` images of size `hw`: the crop
    offsets (int32, only when `crop_hw` is smaller) and the mirror bits
    (uint8, only under `rand_mirror`), drawn in that order from a
    `torch.Generator` on `device` seeded from `key`, a pair of uint32
    (epoch seed, batch number). The JAX package draws from
    `jax.random.split(key)`; the port's draws differ from those, and are a
    deterministic function of (key, device) alone."""
    k0, k1 = (int(v) & 0xFFFFFFFF for v in key)
    gen = torch.Generator(device=device)
    gen.manual_seed((k0 << 32) | k1)
    h, w = hw
    ch, cw = (h, w) if crop_hw is None else crop_hw
    y0 = x0 = flips = None
    if (ch, cw) != (h, w):
        y0 = torch.randint(0, h - ch + 1, (n,), generator=gen, device=device,
                           dtype=torch.int32)
        x0 = torch.randint(0, w - cw + 1, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    if rand_mirror:
        flips = torch.randint(0, 2, (n,), generator=gen, device=device,
                              dtype=torch.uint8)
    return y0, x0, flips


def image_augment(images, key, mean=None, std=None, crop_hw=None,
                  rand_mirror=False, out_dtype="float32"):
    """The card half of the input pipeline (the JAX package's
    `ops.fused.image_augment`): optional per-image random crop to `crop_hw`
    (when the images are larger), optional per-image horizontal mirror,
    [0, 1] scale of integer pixels, per-channel mean / std, cast to
    `out_dtype`, in one pass of `csrc/image_augment.cu` for a CUDA batch.
    `images`: (N, H, W, C) uint8 (or another integer type, scaled by 1/255;
    bool is read as 0 / 1), or a float array already in [0, 1] (gradients
    flow through the affine); a crop that cuts keeps the first 3 channels,
    and mean / std (a scalar or one entry a channel) broadcast over the
    channels as numpy broadcasts. `key`: the (epoch seed, batch)
    pair of uint32 the draws are seeded from (`augment_draws`)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    out_dtype = _augment_dtype(out_dtype)
    n, h, w = images.shape[:3]
    crop = None if crop_hw is None else (int(crop_hw[0]), int(crop_hw[1]))
    y0, x0, flips = augment_draws(key, n, (h, w), crop, rand_mirror,
                                  images.device)
    return _augment_apply(images, y0, x0, flips, crop, mean, std, out_dtype)


def _augment_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    from ..base import to_torch_dtype
    return to_torch_dtype(dtype)
