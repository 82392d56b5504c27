"""The recurrent cell's elementwise step: a hand-written CUDA kernel for
tensors on the card, a plain PyTorch version for tensors on the CPU.

The JAX package has no Pallas kernel here: its cells (`ops/nn.py`
`lstm_cell`, `gru_cell`, `rnn_relu_cell`) are jnp whose elementwise part
XLA fuses inside `lax.scan`. PyTorch runs eagerly, so without a kernel
each cell step would be about ten elementwise launches; `csrc/rnn_cell.cu`
makes it one forward launch and one backward launch a step.

The step takes the gate pre-activations of one time step, the input
product `gx` = x Wx^T + bias and the recurrent product `gh` = h Wh^T
(+ bh for the GRU), both (N, G H) with the gate blocks in the reference's
order (LSTM [i, f, g, o], GRU [r, z, n]), and the previous state:

  lstm      i, f, o = sigmoid(gx + gh), g = act(gx + gh),
            c' = f c + i g, h' = o act(c')
  gru       r = sigmoid(rx + rh), z = sigmoid(zx + zh),
            n = act(nx + r nh), h' = (1 - z) n + z h
  rnn       h' = act(gx + gh)

with `act` one of `npx.activation`'s tanh, relu, sigmoid, softrelu,
softsign and log_sigmoid (mish, whose derivative its output does not
give, is not taken). The products stay `torch.matmul` / `addmm`, as
the JAX package leaves them to XLA. Every value is computed in float32
from the inputs' type (float32, bfloat16 or float16) and rounded once to
it; for the backward the forward also writes the gate activations (the
LSTM's i, f, g, o, the GRU's r, z, n) in that type.

`cell(mode, gx, gh, h, c, act)` is the one entry: a `torch.autograd.
Function` whose forward launches `rnn_cell_fwd` and whose backward
launches `rnn_cell_bwd` for CUDA tensors (the wrappers in `kernels`), and
runs `cell_fwd_ref` / `cell_bwd_ref`, the plain versions with the same
arithmetic in the same order, for CPU tensors. The device decides alone:
no exception handler, environment variable or shape test sends a CUDA
tensor to the plain version. `cell_composed` is the same step as torch ops
under autograd (the oracle of the tests and the smoke run; the port never
calls it on its paths).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import kernels

__all__ = ["MODES", "GATES", "ACTS", "cell", "cell_fwd", "cell_bwd",
           "cell_fwd_ref", "cell_bwd_ref", "cell_composed"]

# the modes, their gate counts and the activations (the kernels' tables)
MODES, GATES, ACTS = kernels.RNN_MODES, kernels.RNN_GATES, kernels.RNN_ACTS


def _check(mode, act):
    if mode not in MODES:
        raise MXNetError(f"unknown recurrent cell mode {mode!r}; "
                         f"one of {sorted(MODES)}")
    if act not in ACTS:
        raise MXNetError(f"the recurrent cell takes the activations "
                         f"{sorted(ACTS)}; got {act!r}")


# ---------------------------------------------------------------------------
# the plain versions: the kernel's arithmetic, op by op, in float32
# ---------------------------------------------------------------------------
def _sigmoid(u):
    return torch.reciprocal(torch.exp(-u) + 1.0)


def _softplus_tail(u):
    return torch.log1p(torch.exp(-u.abs()))


def _act(u, act):
    if act == "tanh":
        return torch.tanh(u)
    if act == "relu":
        return torch.relu(u)
    if act == "sigmoid":
        return _sigmoid(u)
    if act == "softrelu":
        return torch.clamp(u, min=0.0) + _softplus_tail(u)
    if act == "softsign":
        return u / (u.abs() + 1.0)
    return torch.clamp(u, max=0.0) - _softplus_tail(u)   # log_sigmoid


def _act_grad(y, act):
    """The activation's derivative from its output y."""
    if act == "tanh":
        return 1.0 - y * y
    if act == "relu":
        return (y > 0).to(y.dtype)
    if act == "sigmoid":
        return y * (1.0 - y)
    if act == "softrelu":
        return -torch.expm1(-y)     # sigmoid(u) = 1 - exp(-softplus(u))
    if act == "softsign":
        r = 1.0 - y.abs()           # 1 / (1 + |u|)
        return r * r
    return -torch.expm1(y)          # 1 - sigmoid(u) = 1 - exp(y)


def _blocks(t, g):
    return t.float().chunk(g, dim=-1)


def cell_fwd_ref(mode, gx, gh, h, c, act="tanh", save=True):
    """The plain version of `rnn_cell_fwd`: (h', c' or None, the saved
    activations or None) in gx's dtype. `h` is read by the GRU only, `c`
    by the LSTM only; `save` False skips the activations (inference)."""
    _check(mode, act)
    dt = gx.dtype
    if mode == "lstm":
        ai, af, ag, ao = (x + y for x, y in zip(_blocks(gx, 4),
                                                _blocks(gh, 4)))
        i, f, g, o = _sigmoid(ai), _sigmoid(af), _act(ag, act), _sigmoid(ao)
        c_new = f * c.float() + i * g
        h_new = o * _act(c_new, act)
        saved = torch.cat([i, f, g, o], -1).to(dt) if save else None
        return h_new.to(dt), c_new.to(dt), saved
    if mode == "gru":
        rx, zx, nx = _blocks(gx, 3)
        rh, zh, nh = _blocks(gh, 3)
        r, z = _sigmoid(rx + rh), _sigmoid(zx + zh)
        n = _act(nx + r * nh, act)
        h_new = (1.0 - z) * n + z * h.float()
        saved = torch.cat([r, z, n], -1).to(dt) if save else None
        return h_new.to(dt), None, saved
    h_new = _act(gx.float() + gh.float(), act)
    return h_new.to(dt), None, None


def _state_like(mode, h, c_new, h_new):
    """The (N, H) tensor the backward of `mode` is given: the LSTM's c',
    the GRU's previous h, the RNN's h'."""
    return {"lstm": c_new, "gru": h, "rnn": h_new}[mode]


def cell_bwd_ref(mode, saved, gh, h, c, h_new, c_new, dh, dc, act="tanh"):
    """The plain version of `rnn_cell_bwd`: (dgx, dgh, dstate) in the
    step's dtype. Reads the LSTM's saved activations, c and c'; the GRU's
    saved activations, gh (its n block) and h; the RNN's h' (the others
    may be None). dgh is dgx itself except for the GRU (its n block is
    dn_pre r); dstate is the elementwise part of the previous state's
    gradient: the LSTM's dc, the GRU's dh' z, None for the RNN. `dh` /
    `dc` None read as zeros."""
    _check(mode, act)
    like = _state_like(mode, h, c_new, h_new)
    dt, H = like.dtype, like.shape[-1]
    zero = torch.zeros((), device=like.device)
    dhf = dh.float() if dh is not None else zero
    if mode == "lstm":
        i, f, g, o = _blocks(saved, 4)
        tc = _act(c_new.float(), act)
        dct = (dc.float() if dc is not None else zero) + \
            (dhf * o) * _act_grad(tc, act)
        di = (dct * g) * (i * (1.0 - i))
        df = (dct * c.float()) * (f * (1.0 - f))
        dg = (dct * i) * _act_grad(g, act)
        do = (dhf * tc) * (o * (1.0 - o))
        dgx = torch.cat([di, df, dg, do], -1).to(dt)
        return dgx, dgx, (dct * f).to(dt)
    if mode == "gru":
        r, z, n = _blocks(saved, 3)
        nh = gh[..., 2 * H:].float()
        dn = (dhf * (1.0 - z)) * _act_grad(n, act)
        dz = (dhf * (h.float() - n)) * (z * (1.0 - z))
        dr = (dn * nh) * (r * (1.0 - r))
        dgx = torch.cat([dr, dz, dn], -1).to(dt)
        dgh = torch.cat([dr, dz, dn * r], -1).to(dt)
        return dgx, dgh, (dhf * z).to(dt)
    dgx = (dhf * _act_grad(h_new.float(), act)).to(dt)
    return dgx, dgx, None


def cell_composed(mode, gx, gh, h, c=None, act="tanh"):
    """The step as torch ops under autograd, in the inputs' dtype: the
    oracle the kernels' Function is held against. Returns (h', c') for
    the LSTM, h' otherwise."""
    _check(mode, act)
    if mode == "lstm":
        i, f, g, o = (gx + gh).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = _act(g, act)
        c_new = f * c + i * g
        return o * _act(c_new, act), c_new
    if mode == "gru":
        rx, zx, nx = gx.chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
        r, z = torch.sigmoid(rx + rh), torch.sigmoid(zx + zh)
        n = _act(nx + r * nh, act)
        return (1 - z) * n + z * h
    return _act(gx + gh, act)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------
def cell_fwd(mode, gx, gh, h, c, act="tanh", save=True):
    """`rnn_cell_fwd` on the card, its plain version on the CPU."""
    dev = gx.device.type
    if dev == "cuda":
        return kernels.rnn_cell_fwd_cuda(mode, gx, gh, h, c, act, save)
    if dev == "cpu":
        return cell_fwd_ref(mode, gx, gh, h, c, act, save)
    raise MXNetError(f"rnn_cell: no path for device {gx.device}")


def cell_bwd(mode, saved, gh, h, c, h_new, c_new, dh, dc, act="tanh"):
    """`rnn_cell_bwd` on the card, its plain version on the CPU."""
    like = _state_like(mode, h, c_new, h_new)
    dev = like.device.type
    if dev == "cuda":
        return kernels.rnn_cell_bwd_cuda(mode, saved, gh, h, c, h_new, c_new,
                                         dh, dc, act)
    if dev == "cpu":
        return cell_bwd_ref(mode, saved, gh, h, c, h_new, c_new, dh, dc, act)
    raise MXNetError(f"rnn_cell: no path for device {like.device}")


def _contiguous(t):
    from .fused import contiguous_counted
    return None if t is None else contiguous_counted(t)


class _Cell(torch.autograd.Function):
    """One step; outputs (h', c') for the LSTM, (h',) otherwise. Saves
    what its mode's backward reads: the LSTM's activations, c and c', the
    GRU's activations, gh and h, the RNN's h'."""

    @staticmethod
    def forward(ctx, mode, act, save, gx, gh, h, c):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.act = mode, act
        h_new, c_new, saved = cell_fwd(mode, gx, gh, h, c, act, save)
        if save:
            if mode == "lstm":
                ctx.save_for_backward(saved, c, c_new)
            elif mode == "gru":
                ctx.save_for_backward(saved, gh, h)
            else:
                ctx.save_for_backward(h_new)
        return (h_new, c_new) if mode == "lstm" else (h_new,)

    @staticmethod
    def backward(ctx, dh, dc=None):
        mode = ctx.mode
        if dh is None and dc is None:
            return (None,) * 7
        saved = gh = h = c = h_new = c_new = None
        if mode == "lstm":
            saved, c, c_new = ctx.saved_tensors
        elif mode == "gru":
            saved, gh, h = ctx.saved_tensors
        else:
            (h_new,) = ctx.saved_tensors
        dgx, dgh, dstate = cell_bwd(mode, saved, gh, h, c, h_new, c_new,
                                    _contiguous(dh), _contiguous(dc),
                                    ctx.act)
        needs = ctx.needs_input_grad
        return (None, None, None, dgx if needs[3] else None,
                dgh if needs[4] else None,
                dstate if mode == "gru" and needs[5] else None,
                dstate if mode == "lstm" and needs[6] else None)


def cell(mode, gx, gh, h, c=None, act="tanh"):
    """One recurrent step through the kernels (see the module docstring):
    (h', c') for "lstm", h' for "gru" and "rnn". gx, gh (N, G H); h, c
    (N, H); every tensor of gx's dtype and device (h and c are cast to
    it). Non-contiguous inputs are copied first (counted in
    `fused.layout_copies()`)."""
    _check(mode, act)
    dt = gx.dtype
    h = None if h is None else h.to(dt)
    c = None if c is None else c.to(dt)
    if mode == "lstm" and c is None:
        raise MXNetError("the LSTM cell needs its cell state c")
    if mode == "gru" and h is None:
        raise MXNetError("the GRU cell needs its state h")
    # a step that is taped saves its activations for the backward; an
    # inference step writes none
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (gx, gh, h, c))
    out = _Cell.apply(mode, act, save, _contiguous(gx),
                      _contiguous(gh.to(dt)),
                      _contiguous(h) if mode == "gru" else h,
                      _contiguous(c) if mode == "lstm" else c)
    return out if mode == "lstm" else out[0]
