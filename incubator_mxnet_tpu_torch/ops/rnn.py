"""The recurrent family's kernels: hand-written CUDA kernels for tensors on
the card, plain PyTorch versions for tensors on the CPU.

The JAX package has no Pallas kernel here: its cells (`ops/nn.py`
`lstm_cell`, `gru_cell`, `rnn_relu_cell`) are jnp, and `ops.nn.rnn` runs
them in `lax.scan`, one XLA program a (layer, direction). PyTorch runs
eagerly, so the port has two routes, which `ops.nn.rnn` picks by shape
(`kernels.rnn_layer_route`):

  * "persistent": `layer` runs every step of a (layer, direction) in one
    launch of `csrc/rnn_layer.cu` forward and one backward: each block
    keeps its hidden units' rows of W_hh in shared memory for the whole
    loop and the blocks exchange h (dG on the way back) through L2 once a
    step;
  * "per_step" (W_hh's share too large for a block's shared memory): the
    recurrent product `torch.matmul` and `cell`, one launch of
    `csrc/rnn_cell.cu` a step each way; the single cells of `ops.nn` and
    `gluon.rnn` always take `cell`.

A step takes the gate pre-activations, the input product `gx` = x Wx^T +
bias and the recurrent product `gh` = h Wh^T (+ bh for the GRU), both
(N, G H) with the gate blocks in the reference's order (LSTM [i, f, g,
o], GRU [r, z, n]), and the previous state:

  lstm      i, f, o = sigmoid(gx + gh), g = act(gx + gh),
            c' = f c + i g, h' = o act(c')
  gru       r = sigmoid(rx + rh), z = sigmoid(zx + zh),
            n = act(nx + r nh), h' = (1 - z) n + z h
  rnn       h' = act(gx + gh)

with `act` one of `npx.activation`'s tanh, relu, sigmoid, softrelu,
softsign and log_sigmoid (mish, whose derivative its output does not
give, is not taken). The input product stays `addmm` over all T N rows,
as the JAX package leaves it to XLA, and so do the weight gradients.
Every value is computed in float32 from the inputs' type (float32,
bfloat16 or float16) and rounded once to it; for the backward the
forward also writes the gate activations (the LSTM's i, f, g, o, the
GRU's r, z, n) in that type (the layer also each step's c, or the GRU's
n block of gh).

`cell(mode, gx, gh, h, c, act)` and `layer(mode, gx, w, h0, c0, bh, act,
reverse)` are `torch.autograd.Function`s whose forward and backward launch
the kernels (the wrappers in `kernels`) for CUDA tensors, and run the
plain versions with the same arithmetic in the same order
(`cell_fwd_ref` / `cell_bwd_ref`, `layer_fwd_ref` / `layer_bwd_ref`; the
layer's products sum in torch.matmul's order) for CPU tensors. The device
decides alone: no exception handler, environment variable or shape test
sends a CUDA tensor to a plain version. `cell_composed` and
`layer_composed` are the same as torch ops under autograd (the oracles of
the tests and the smoke run; the port never calls them on its paths).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import kernels

__all__ = ["MODES", "GATES", "ACTS", "cell", "cell_fwd", "cell_bwd",
           "cell_fwd_ref", "cell_bwd_ref", "cell_composed", "layer",
           "layer_fwd", "layer_bwd", "layer_fwd_ref", "layer_bwd_ref",
           "layer_composed"]

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
    nh = gh[..., 2 * h.shape[-1]:] if mode == "gru" else None
    return _cell_bwd(mode, saved, nh, h, c, h_new, c_new, dh, dc, act)


def _cell_bwd(mode, saved, nh, h, c, h_new, c_new, dh, dc, act):
    """`cell_bwd_ref` given the GRU's n block of gh, nh (N, H), alone."""
    like = _state_like(mode, h, c_new, h_new)
    dt = like.dtype
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
        nh = nh.float()
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


def _times(T, reverse):
    """The steps' times in the order the forward takes them."""
    return range(T - 1, -1, -1) if reverse else range(T)


def _h_prev(ys, h0, reverse):
    """The state each step starts from, (T, N, H) in time order: h0, then
    ys but the last step's (reverse: ys but the first, then h0)."""
    if reverse:
        return torch.cat([ys[1:], h0[None]], 0)
    return torch.cat([h0[None], ys[:-1]], 0)


def layer_fwd_ref(mode, gx, w, h0, c0=None, bh=None, act="tanh",
                  reverse=False, save=True):
    """The plain version of `rnn_layer_fwd`: (ys, h_T, c_T or None, the
    gate activations or None, aux or None) in gx's dtype. Each step, in
    the order of `reverse`: the recurrent product h W^T (+ bh for the
    GRU) in float32 from the stored h, then `cell_fwd_ref`; only h, c and
    the saved values are rounded to the type. With `save` the LSTM and
    the GRU keep the activations (T, N, G H) and aux (T, N, H): the LSTM's
    c or the GRU's n block of the recurrent product at each step."""
    _check(mode, act)
    T, N, H = gx.shape[0], gx.shape[1], w.shape[1]
    dt = gx.dtype
    wt = w.float().t()
    keep = save and mode != "rnn"
    ys = gx.new_empty((T, N, H))
    acts = torch.empty_like(gx) if keep else None
    aux = torch.empty_like(ys) if keep else None
    h = h0.to(dt)
    c = c0.to(dt) if mode == "lstm" else None
    for t in _times(T, reverse):
        gh = h.float() @ wt
        if mode == "gru":
            gh = gh + bh.float()
        h, c_new, saved = cell_fwd_ref(mode, gx[t], gh, h, c, act, keep)
        ys[t] = h
        if keep:
            acts[t] = saved
            aux[t] = c_new if mode == "lstm" else gh[:, 2 * H:]
        c = c_new
    return ys, h, c, acts, aux


def layer_bwd_ref(mode, w, acts, aux, ys, h0, c0, dys, dh_T, dc_T,
                  act="tanh", reverse=False):
    """The plain version of `rnn_layer_bwd`: (dgx, dgh, dh0, dc0 or None)
    in ys's dtype. Each step in reverse: dh = the next step's dgh W in
    float32 (zero at the first), then + dys, + dh_T (first step only),
    + the GRU's elementwise part carried from the step after, in that
    order; then `cell_bwd_ref`'s arithmetic. The LSTM's dc and the GRU's
    elementwise dh are carried rounded to the type; dh0 = the last step's
    dgh W (+ that GRU part). dys, dh_T, dc_T None read as zeros."""
    _check(mode, act)
    T, N, H = ys.shape
    dt, G = ys.dtype, GATES[mode]
    lstm, gru = mode == "lstm", mode == "gru"
    wf = w.float()
    dgx = ys.new_empty((T, N, G * H))
    dgh = torch.empty_like(dgx) if gru else dgx
    times = list(_times(T, reverse))
    carry, dc = None, dc_T if lstm else None
    for s in range(T - 1, -1, -1):
        t = times[s]
        d = dgh[times[s + 1]].float() @ wf if s + 1 < T \
            else torch.zeros((N, H), device=ys.device)
        if dys is not None:
            d = d + dys[t].float()
        if s + 1 == T and dh_T is not None:
            d = d + dh_T.float()
        if carry is not None:
            d = d + carry.float()
        prev = times[s - 1] if s > 0 else None
        h_prev = h0 if prev is None else ys[prev]
        c_prev = (c0 if prev is None else aux[prev]) if lstm else None
        dgx[t], g_h, state = _cell_bwd(
            mode, None if mode == "rnn" else acts[t], aux[t] if gru else None,
            h_prev, c_prev, ys[t], aux[t] if lstm else None, d, dc, act)
        if gru:
            dgh[t], carry = g_h, state
        if lstm:
            dc = state
    d = dgh[times[0]].float() @ wf
    if carry is not None:
        d = d + carry.float()
    return dgx, dgh, d.to(dt), dc


def layer_composed(mode, gx, w, h0, c0=None, bh=None, act="tanh",
                   reverse=False):
    """The layer as torch ops under autograd, step by step (the recurrent
    product, then `cell_composed`), in the inputs' dtype: the oracle the
    layer's Function is held against (the port never calls it). Returns
    (ys, h_T, c_T) for the LSTM, (ys, h_T) otherwise."""
    _check(mode, act)
    h, c = h0, c0
    ys = [None] * gx.shape[0]
    for t in _times(gx.shape[0], reverse):
        gh = torch.matmul(h, w.t())
        if mode == "gru":
            gh = gh + bh
        out = cell_composed(mode, gx[t], gh, h, c, act)
        h, c = out if mode == "lstm" else (out, None)
        ys[t] = h
    return (torch.stack(ys, 0), h, c) if mode == "lstm" else \
        (torch.stack(ys, 0), h)


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


def layer_fwd(mode, gx, w, h0, c0, bh, act="tanh", reverse=False,
              save=True):
    """`rnn_layer_fwd` on the card, its plain version on the CPU."""
    dev = gx.device.type
    if dev == "cuda":
        return kernels.rnn_layer_fwd_cuda(mode, gx, w, h0, c0, bh, act,
                                          reverse, save)
    if dev == "cpu":
        return layer_fwd_ref(mode, gx, w, h0, c0, bh, act, reverse, save)
    raise MXNetError(f"rnn_layer: no path for device {gx.device}")


def layer_bwd(mode, w, acts, aux, ys, h0, c0, dys, dh_T, dc_T, act="tanh",
              reverse=False):
    """`rnn_layer_bwd` on the card, its plain version on the CPU."""
    dev = ys.device.type
    if dev == "cuda":
        return kernels.rnn_layer_bwd_cuda(mode, w, acts, aux, ys, h0, c0,
                                          dys, dh_T, dc_T, act, reverse)
    if dev == "cpu":
        return layer_bwd_ref(mode, w, acts, aux, ys, h0, c0, dys, dh_T,
                             dc_T, act, reverse)
    raise MXNetError(f"rnn_layer: no path for device {ys.device}")


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


class _Layer(torch.autograd.Function):
    """Every step of one (layer, direction); outputs (ys, h_T, c_T) for the
    LSTM, (ys, h_T) otherwise. Saves W_hh, ys, h0, c0 and what the forward
    kept (the activations and aux). The backward's kernel gives dgx and
    dh0 (and dc0); the weight products dW_hh = dgh^T [h0; ys] and the
    GRU's dbh are plain torch calls after it, as XLA takes them in the JAX
    package."""

    @staticmethod
    def forward(ctx, mode, act, reverse, save, gx, w, h0, c0, bh):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.act, ctx.reverse = mode, act, reverse
        ys, h_T, c_T, acts, aux = layer_fwd(mode, gx, w, h0, c0, bh, act,
                                            reverse, save)
        if save:
            ctx.save_for_backward(w, acts, aux, ys, h0, c0)
        return (ys, h_T, c_T) if mode == "lstm" else (ys, h_T)

    @staticmethod
    def backward(ctx, dys, dh_T, dc_T=None):
        mode = ctx.mode
        if dys is None and dh_T is None and dc_T is None:
            return (None,) * 9
        w, acts, aux, ys, h0, c0 = ctx.saved_tensors
        dgx, dgh, dh0, dc0 = layer_bwd(mode, w, acts, aux, ys, h0, c0,
                                       _contiguous(dys), _contiguous(dh_T),
                                       _contiguous(dc_T), ctx.act,
                                       ctx.reverse)
        needs = ctx.needs_input_grad
        dw = dbh = None
        if needs[5]:
            H = w.shape[1]
            dw = dgh.reshape(-1, dgh.shape[-1]).t() @ \
                _h_prev(ys, h0, ctx.reverse).reshape(-1, H)
        if mode == "gru" and needs[8]:
            dbh = dgh.float().sum((0, 1)).to(dgh.dtype)
        return (None, None, None, None, dgx if needs[4] else None, dw,
                dh0 if needs[6] else None,
                dc0 if mode == "lstm" and needs[7] else None, dbh)


def layer(mode, gx, w, h0, c0=None, bh=None, act="tanh", reverse=False):
    """Every step of one (layer, direction) through the layer kernels (see
    the module docstring): (ys, h_T, c_T) for "lstm", (ys, h_T) for "gru"
    and "rnn". gx (T, N, G H): every step's input product and bias (bx +
    bh; bx alone for the GRU, whose bh (G H,) joins its recurrent
    product); w: W_hh (G H, H); h0, c0 (N, H); T >= 1 steps, walked
    backwards with `reverse`. Every tensor is cast to gx's dtype;
    non-contiguous ones are copied first (counted in
    `fused.layout_copies()`)."""
    _check(mode, act)
    dt = gx.dtype
    if gx.dim() != 3 or gx.shape[0] < 1:
        raise MXNetError(f"the layer takes gx (T >= 1, N, G H); got "
                         f"{tuple(gx.shape)}")
    if mode == "lstm" and c0 is None:
        raise MXNetError("the LSTM layer needs its cell state c0")
    if mode == "gru" and bh is None:
        raise MXNetError("the GRU layer needs its recurrent bias bh")
    w, h0 = w.to(dt), h0.to(dt)
    c0 = c0.to(dt) if mode == "lstm" else None
    bh = bh.to(dt) if mode == "gru" else None
    # a taped layer saves what its backward reads; an inference pass keeps
    # nothing
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (gx, w, h0, c0, bh))
    return _Layer.apply(mode, act, bool(reverse), save, _contiguous(gx),
                        _contiguous(w), _contiguous(h0), _contiguous(c0),
                        _contiguous(bh))
