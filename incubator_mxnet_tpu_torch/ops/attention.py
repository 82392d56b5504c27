"""Flash attention of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/ops/pallas_attention.py`. Layout as
there: q (bh, Tq, d), k and v (bh, Tk, d), causal masking end-aligned
(query i sees keys j <= i + Tk - Tq). Four hand-written CUDA kernels
(`csrc/flash_attention.cu`) carry it on the card:

  launch counter  TPU kernel replaced                plain version
  --------------  ---------------------------------  ---------------------
  flash_fwd       B5 `_flash_forward_kernel`         flash_attention_ref
  flash_fwd_lse   B6 `_flash_forward_lse`            flash_forward_lse_ref
  flash_bwd_dq    B7 `_flash_backward`, dq sweep     flash_bwd_dq_ref
  flash_bwd_dkv   B8 `_flash_backward`, dk/dv sweep  flash_bwd_dkv_ref

Each of them has two kernels, chosen by dtype and head dim alone
(`kernels.flash_fwd_route`, `kernels.flash_bwd_route`, one rule):
bfloat16 and float16 at d a multiple of 8 up to 128 on the tensor cores
(`flash_fwd_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel`,
`flash_bwd_dkv_wgmma_kernel`, templates over the 16-bit type; their
launches also count in `flash_fwd_wgmma`, `flash_fwd_lse_wgmma`,
`flash_bwd_dq_wgmma` and `flash_bwd_dkv_wgmma`), float32 and other d on
the CUDA cores. Every head dim (past 256 in 128-column slices) and any bh
reach a kernel. The tensor-core kernels take P and dS into their products
as two 16-bit terms; `flash_bwd_split_ref` emulates the backward's split
(in float16 with P shifted and dS scaled per row, to keep them out of
float16's subnormals) for the tests and chip_smoke.py.

`flash_attention` is the JAX package's `custom_vjp` as one
`torch.autograd.Function`: its forward runs B6 and saves (q, k, v, o,
lse); its backward computes delta = rowsum(dO * o) in float32 with plain
torch, as the JAX package does outside Pallas, then runs B7 and B8.
Without a gradient to record (grad mode off, or no input requiring one)
the call runs B5 alone, the `custom_vjp` primal. The device decides the
path: a CUDA tensor launches the kernels or raises, a CPU tensor takes the
plain versions, the same Function wired the same way. No shape sends a
CUDA tensor elsewhere: ragged Tq and Tk are masked inside the kernels,
where the JAX package falls back to its einsum reference.

One deliberate difference: a query row that sees no key (Tq > Tk, causal)
outputs 0 with the -1e30 LSE sentinel whatever the tiling. The JAX kernel
gives 0 only where its causal block skip covers the row, and the mean of v
inside a computed block, as its `_reference` does.

Under AMP the op follows the JAX package's unregistered
`invoke(..., name="flash_attention")`: no list names it, so its inputs
keep their dtypes (bfloat16 from bfloat16 `Dense` outputs), and mixed
inputs are promoted to the widest.
"""
from __future__ import annotations

import functools
import math

import torch

from .. import amp
from ..base import MXNetError
from . import kernels
from .fused import contiguous_counted

__all__ = ["flash_attention", "flash_attention_ref", "flash_forward_lse_ref",
           "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "flash_bwd_split_ref"]

_NEG_INF = -1e30          # the mask value and the LSE sentinel
_SENTINEL_CUT = -5e29     # an lse at or below this marks a fully masked row


# ---------------------------------------------------------------------------
# plain versions — the CPU path AND the kernels' oracles
# ---------------------------------------------------------------------------
def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scores(q, k, scale, causal):
    """(bh, tq, tk) float32 scores, masked entries at -1e30, and the
    (tq, tk) live mask (None when nothing is masked)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    tq, tk = s.shape[-2:]
    live = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(
        tk - tq)
    return s.masked_fill(~live, _NEG_INF), live


def flash_forward_lse_ref(q, k, v, causal=False, scale=None):
    """(o, lse): softmax attention in float32, o in q's dtype, lse
    (bh, tq, 1) float32; a row with no live key gives o = 0 and lse =
    -1e30 (B6's function)."""
    scale = _scale(q, scale)
    bh, tq, d = q.shape
    if k.shape[1] == 0:
        return (torch.zeros_like(q),
                torch.full((bh, tq, 1), _NEG_INF, device=q.device))
    s, live = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    if live is not None:
        e = e * live
    den = e.sum(-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", e / torch.where(den == 0, 1.0, den),
                     v.float())
    lse = torch.where(den > 0, m + torch.log(den.clamp(min=1e-37)),
                      _NEG_INF)
    return o.to(q.dtype), lse


def flash_attention_ref(q, k, v, causal=False, scale=None):
    """Softmax attention in float32, in q's dtype (B5's function; the JAX
    package's `_reference` but for rows with no live key, which give 0)."""
    return flash_forward_lse_ref(q, k, v, causal, scale)[0]


def _probs(q, k, lse, causal, scale):
    """p = exp(s - lse) in float32, zero on masked keys and on rows whose
    lse is the sentinel."""
    s, live = _scores(q, k, scale, causal)
    keep = lse > _SENTINEL_CUT
    if live is not None:
        keep = keep & live
    return torch.where(keep, torch.exp(s - lse), 0.0)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """dq of the flash backward from its kernel's inputs (B7's function):
    scale * sum_k p * (dO v^T - delta) k, in q's dtype."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta)
    return (torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """(dk, dv) of the flash backward from its kernel's inputs (B8's
    function): dv = p^T dO, dk = scale * ds^T q, in k's dtype."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# The float16 tensor-core sweeps' operands (csrc/flash_attention.cu, B7/B8).
# P enters dV's product as P * 2^15 (P <= 1), so its low term stays out of
# float16's subnormals; dS as dS * 2^e with one exponent per output row (a
# query row in dq, a key row in dk), lowered tile by tile as larger values
# arrive so that the row's largest |dS| so far lies in [2^14, 2^15), kept
# over a tile of zeros, clamped to [-56, 56].
_P_SHIFT = 15
_DS_TOP = 14
_DS_EXP = 56
_SWEEP_TILE = 64          # streamed rows of a sweep's tile


def _pow2(e):
    """2^e as float32, exactly, for int32 e in [-126, 127]."""
    return ((e + 127) << 23).view(torch.float32)


def _row_exponents(x):
    """The kernel's running exponent of each (row, 64-column tile) of x
    (bh, rows, cols), spread over the tile's columns (int32)."""
    bh, rows, cols = x.shape
    nt = -(-cols // _SWEEP_TILE)
    mx = torch.nn.functional.pad(x.abs(), (0, nt * _SWEEP_TILE - cols))
    mx = mx.view(bh, rows, nt, _SWEEP_TILE).amax(-1)
    top = ((mx.view(torch.int32) >> 23) & 0xFF) - 127   # floor(log2 |x|)
    e = (_DS_TOP - top).clamp(-_DS_EXP, _DS_EXP)        # zero: the ceiling
    e = torch.cummin(e, dim=-1).values
    return e.repeat_interleave(_SWEEP_TILE, -1)[..., :cols].contiguous()


def flash_bwd_split_ref(q, k, v, do, lse, delta, causal=False, scale=None,
                        split="kernel"):
    """(dq, dk, dv) as the tensor-core sweeps compute them in q's 16-bit
    type: P and dS enter their products as operands of that type, products
    and sums in float32; the rest as `flash_bwd_dq_ref` and
    `flash_bwd_dkv_ref`. `split`: "one_term" (x rounded once), "two_term"
    (x = hi + lo, bfloat16's sweeps) or "kernel" (in float16, two terms of
    P * 2^15 and of dS scaled per output row, see `_P_SHIFT`; in bfloat16,
    "two_term"). The tests and chip_smoke.py hold the scheme and the
    kernels to it; nothing on the main path calls it."""
    scale = _scale(q, scale)
    dt = q.dtype
    ranged = split == "kernel" and dt == torch.float16
    p = _probs(q, k, lse, causal, scale)
    ds = p * (torch.einsum("bqd,bkd->bqk", do.float(), v.float()) - delta)

    def product(x, m, ranged_rows):
        """sum over x's columns of x[row] m (x (bh, rows, cols) f32, m
        (bh, cols, d)), x's terms of the type each in its own product."""
        up = down = None
        if ranged_rows:
            e = _row_exponents(x)
            up, down = _pow2(e), _pow2(-e)
            x = x * up
        hi = x.to(dt).float()
        terms = [hi] if split == "one_term" else [hi, (x - hi).to(dt).float()]
        if up is not None:
            terms = [t * down for t in terms]
        return sum(torch.einsum("brc,bcd->brd", t, m) for t in terms)

    dq = product(ds, k.float(), ranged) * scale
    dk = product(ds.transpose(1, 2), q.float(), ranged) * scale
    shift = 2.0 ** _P_SHIFT if ranged else 1.0
    dv = product(p.transpose(1, 2) * shift, do.float(), False) / shift
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# device dispatch of the kernels
# ---------------------------------------------------------------------------
def _no_path(t):
    return MXNetError(f"flash_attention: no path for device {t.device}")


def _forward(q, k, v, causal, scale, with_lse):
    dev = q.device.type
    if dev == "cuda":
        return kernels.flash_fwd_cuda(q, k, v, causal, scale, with_lse)
    if dev == "cpu":
        o, lse = flash_forward_lse_ref(q, k, v, causal, scale)
        return (o, lse) if with_lse else o
    raise _no_path(q)


def _backward(q, k, v, do, lse, delta, causal, scale):
    dev = q.device.type
    if dev == "cuda":
        dq = kernels.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = kernels.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                            scale)
        return dq, dk, dv
    if dev == "cpu":
        dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    raise _no_path(q)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's `custom_vjp`: forward B6, backward B7 + B8."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _forward(q, k, v, causal, scale, True)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = contiguous_counted(do)
        # delta = rowsum(dO * O) per query row, in float32 outside the
        # kernels (pallas_attention.py's _fa_bwd)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq, dk, dv = _backward(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise (flash) attention over q (bh, Tq, d), k and v (bh, Tk, d),
    `scale` 1/sqrt(d) by default. Differentiable through the flash
    backward (B7, B8) when a gradient is recorded; otherwise the forward
    kernel alone (B5). CUDA inputs must be contiguous (the kernels take no
    strided view)."""
    q, k, v = amp.cast_inputs("flash_attention", "neutral", q, k, v)
    wide = functools.reduce(torch.promote_types, (q.dtype, k.dtype, v.dtype))
    q, k, v = (t.to(wide) for t in (q, k, v))
    scale = _scale(q, scale)
    causal = bool(causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, False)
