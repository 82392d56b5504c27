"""Autograd of the PyTorch port: MXNet's recording scopes, `backward`,
`grad`, `mark_variables` and `Function` over PyTorch's own autograd.

Counterpart of `incubator_mxnet_tpu/autograd.py`. The JAX package keeps a
tape of `jax.vjp` closures; here PyTorch's autograd graph is the tape, and
this module adds MXNet's semantics on top of it:

  * scopes: `record(train_mode=True)` tapes (`torch.enable_grad`) and sets
    the training flag, `pause(train_mode=False)` stops taping
    (`torch.no_grad`), `train_mode()` / `predict_mode()` set the flag
    alone. `is_training()` is what BatchNorm and Dropout read; blocks
    ignore `torch.nn.Module.training`.
  * `grad_req` per variable: "write" (each backward overwrites the
    gradient), "add" (backwards add up until the gradient is consumed, by
    `gluon.Trainer.step` for instance) or "null" (no gradient). PyTorch
    always adds into `.grad`; hooks on each variable's gradient
    accumulator make the write and the first add of a round overwrite
    instead, and only in a backward that accumulates (never inside
    `torch.autograd.grad`, which `gluon.contrib.FusedTrainStep` uses).
    The gradient lands in the buffer `.grad` held before the backward (the
    one given to `mark_variables`, or returned by `Parameter.grad()`), as
    the JAX package writes `var.grad[:]`: an overwrite costs one copy into
    it (`buffer_copies()` counts them); a tensor without a buffer takes
    PyTorch's gradient tensor as its first one.
  * the taping scope: `record()` and `FusedTrainStep`'s own scope tape
    (`is_taping()`); a Gluon block called outside them runs its forward
    under `torch.no_grad()`, so inference records nothing.
  * `is_recomputing()`: inside the recompute of a rematerialized forward
    (`FusedTrainStep(remat=...)`), where BatchNorm leaves its running
    statistics alone: the first pass updated them.
  * `backward(heads)` on a non-scalar head seeds it with ones, as MXNet's
    `loss.backward()` does on a per-sample loss (PyTorch's
    `Tensor.backward()` refuses a non-scalar).

`backward`, `grad` and `mark_variables` take NDArrays (`mx.np`) as well
as tensors: `x.attach_grad()` marks an NDArray through `attach`, and
`loss.backward()` on a per-sample NDArray loss seeds ones. NDArray ops
outside `record()` record nothing, so an NDArray head computed there
raises, as in the JAX package.

Deliberate difference: PyTorch tapes every op on a raw tensor that requires
a gradient unless taping is paused, so a raw-tensor head computed outside
`record()` from such tensors is differentiable here (the JAX package
raises); a head connected to no graph at all raises as in the JAX package.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "is_taping", "is_recomputing", "set_recording",
           "set_training",
           "mark_variables", "backward", "grad", "Function",
           "buffer_copies"]

_state = threading.local()


def is_recording():
    """Whether ops are taped for backward (inside `record()`)."""
    return getattr(_state, "recording", False)


def is_training():
    """Whether ops run in train mode (Dropout drops, BatchNorm takes batch
    statistics and updates its running ones)."""
    return getattr(_state, "training", False)


def set_recording(is_record):
    """Set the recording flag and PyTorch's grad mode with it; returns the
    previous flag."""
    prev = is_recording()
    _state.recording = _state.taping = bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train_mode_):
    """Set the training flag; returns the previous one."""
    prev = is_training()
    _state.training = bool(train_mode_)
    return prev


def is_taping():
    """Whether a Gluon block's forward is taped: inside `record()` or
    `FusedTrainStep`'s scope. Outside them a block runs under
    `torch.no_grad()`."""
    return getattr(_state, "taping", False)


def is_recomputing():
    """Whether a rematerialized forward is being recomputed for its
    backward (`FusedTrainStep(remat="full" | "dots")`)."""
    return getattr(_state, "recomputing", False)


class _Scope:
    """Sets the recording and training flags for its extent (None leaves a
    flag alone); `grad_mode` True or False also sets PyTorch's grad mode;
    `taping` sets `is_taping()` (by default it follows `recording`);
    `recomputing` sets `is_recomputing()`."""

    def __init__(self, recording=None, training=None, grad_mode=None,
                 taping=None, recomputing=None):
        self._recording = recording
        self._training = training
        self._grad_mode = grad_mode
        self._taping = recording if taping is None else taping
        self._recomputing = recomputing

    def __enter__(self):
        if self._recomputing is not None:
            self._prev_recompute = is_recomputing()
            _state.recomputing = bool(self._recomputing)
        if self._recording is not None:
            self._prev_rec = getattr(_state, "recording", False)
            _state.recording = bool(self._recording)
        if self._taping is not None:
            self._prev_tape = is_taping()
            _state.taping = bool(self._taping)
        if self._training is not None:
            self._prev_train = set_training(self._training)
        if self._grad_mode is not None:
            self._prev_grad = torch.is_grad_enabled()
            torch.set_grad_enabled(self._grad_mode)
        return self

    def __exit__(self, *exc):
        if self._recomputing is not None:
            _state.recomputing = self._prev_recompute
        if self._recording is not None:
            _state.recording = self._prev_rec
        if self._taping is not None:
            _state.taping = self._prev_tape
        if self._training is not None:
            set_training(self._prev_train)
        if self._grad_mode is not None:
            torch.set_grad_enabled(self._prev_grad)


def record(train_mode=True):
    """Scope in which ops are taped for backward, in train mode unless
    `train_mode=False`."""
    return _Scope(recording=True, training=train_mode, grad_mode=True)


def pause(train_mode=False):
    """Scope in which taping stops (`torch.no_grad`)."""
    return _Scope(recording=False, training=train_mode, grad_mode=False)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


# ---------------------------------------------------------------------------
# grad_req on a variable
# ---------------------------------------------------------------------------
_REQS = ("write", "add", "null")


class _Variable:
    """A variable's gradient request, whether its `.grad` holds the
    gradients of a backward not yet consumed (`fresh`), and during a
    backward that overwrites, the buffer the gradient goes to (`kept`)."""

    __slots__ = ("grad_req", "fresh", "kept", "_handles", "__weakref__")

    def __init__(self, tensor, grad_req):
        self.grad_req = grad_req
        self.fresh = False
        self.kept = None
        self._handles = []
        if grad_req == "null":
            return
        ref = weakref.ref(tensor)
        me = weakref.ref(self)
        self._handles = [
            tensor.register_hook(lambda g: _before_accumulate(ref, me)),
            tensor.register_post_accumulate_grad_hook(
                lambda t: _after_accumulate(t, me))]

    def detach_hooks(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def _accumulates(t):
    """Whether the running backward accumulates into leaf `t`'s `.grad`:
    False inside `torch.autograd.grad` (where the query is refused or its
    answer false) and for a leaf that `inputs=` leaves out."""
    acc = torch.autograd.graph.get_gradient_edge(t).node
    try:
        return torch._C._will_engine_execute_node(acc)
    except RuntimeError:
        return False


# copies of a gradient into its kept buffer (one elementwise launch each)
# since the last reset
_buffer_copies = 0


def buffer_copies(reset=False):
    """Gradients copied into their variables' buffers (an overwrite: a
    "write", or the first "add" of a round, on a tensor that had a
    buffer) since the last reset; each is one elementwise launch."""
    global _buffer_copies
    n = _buffer_copies
    if reset:
        _buffer_copies = 0
    return n


def _before_accumulate(tensor_ref, var_ref):
    var, t = var_ref(), tensor_ref()
    if var is None or t is None or not _accumulates(t):
        return None
    if var.grad_req == "write" or not var.fresh:
        # this backward's gradient replaces the buffer's content: PyTorch
        # puts it in a tensor of its own, and the post-accumulate hook
        # copies it into the buffer
        var.kept, t.grad = t.grad, None
    return None


def _after_accumulate(t, var_ref):
    global _buffer_copies
    var = var_ref()
    if var is None:
        return
    var.fresh = True
    kept, var.kept = var.kept, None
    # a gradient with a graph of its own (create_graph) stays PyTorch's
    if kept is None or t.grad is kept or t.grad.requires_grad:
        return
    with torch.no_grad():
        kept.copy_(t.grad)
    t.grad = kept
    _buffer_copies += 1


def attach(tensor, grad_req="write", grad=None):
    """Make `tensor` a variable with `grad_req`; returns it. `grad` (a
    tensor of its shape) becomes its gradient buffer. A tensor attached
    before is re-attached (its old hooks removed)."""
    if grad_req not in _REQS:
        raise MXNetError(f"invalid grad_req {grad_req!r}")
    old = getattr(tensor, "_mx_var", None)
    if old is not None:
        old.detach_hooks()
    tensor.requires_grad_(grad_req != "null")
    tensor._mx_var = _Variable(tensor, grad_req)
    if grad is not None:
        tensor.grad = grad
    elif grad_req == "null":
        tensor.grad = None
    return tensor


def variable(tensor):
    """The `_Variable` of an attached tensor, else None."""
    return getattr(tensor, "_mx_var", None)


def _tensor_of(x):
    """The tensor of an NDArray (a tensor or None as it is)."""
    return getattr(x, "_t", x) if x is not None else None


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Attach gradient buffers to tensors or NDArrays, so that a backward
    writes (or adds, per `grad_reqs`) their gradients into them."""
    if isinstance(variables, torch.Tensor) or hasattr(variables, "_t"):
        variables, gradients = [variables], [gradients]
    if gradients is None:
        gradients = [None] * len(variables)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for t, g, req in zip(variables, gradients, grad_reqs):
        attach(_tensor_of(t), req, _tensor_of(g))


# ---------------------------------------------------------------------------
# backward / grad
# ---------------------------------------------------------------------------
def _heads(heads, head_grads):
    if isinstance(heads, torch.Tensor) or hasattr(heads, "_t"):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = [_tensor_of(h) for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = [_tensor_of(g) for g in head_grads]
    seeds = []
    for h, hg in zip(heads, head_grads):
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate: output is not connected to the tape "
                "(was it computed outside autograd.record()?)")
        seeds.append(torch.ones_like(h) if hg is None
                     else hg.to(device=h.device, dtype=h.dtype))
    return heads, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backpropagate from `heads` (one tensor or NDArray, or a list) into
    the variables' `.grad`, per their `grad_req`. A head without
    `head_grads` is seeded with ones, whatever its shape."""
    heads, seeds = _heads(heads, head_grads)
    with _Scope(training=train_mode):
        torch.autograd.backward(heads, seeds, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of `heads` with respect to `variables`, returned (one
    tensor for one variable, else a list) and written nowhere; a variable
    the heads do not reach gets zeros. `create_graph` tapes the gradient
    computation for a higher-order backward."""
    if retain_graph is None:
        retain_graph = create_graph
    single = isinstance(variables, torch.Tensor) or hasattr(variables, "_t")
    variables = [variables] if single else list(variables)
    as_nd = hasattr(variables[0], "_t")
    variables = [_tensor_of(v) for v in variables]
    for v in variables:
        if not v.requires_grad:
            raise MXNetError("grad target must be a marked variable "
                             "(requires_grad_()) or tape-connected")
    heads, seeds = _heads(heads, head_grads)
    with _Scope(training=train_mode):
        out = torch.autograd.grad(heads, variables, seeds,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [torch.zeros_like(v) if g is None else g
           for g, v in zip(out, variables)]
    if as_nd:
        from .ndarray import _wrap
        out = [_wrap(g) for g in out]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# custom differentiable function
# ---------------------------------------------------------------------------
class _Bridge(torch.autograd.Function):
    """Runs a `Function`'s forward and backward with taping paused."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        with pause(train_mode=is_training()):
            out = fn.forward(*inputs)
        ctx.fn = fn
        ctx.single = not isinstance(out, (list, tuple))
        ctx.n_in = len(inputs)
        return out if ctx.single else tuple(out)

    @staticmethod
    def backward(ctx, *output_grads):
        with pause(train_mode=is_training()):
            gs = ctx.fn.backward(*output_grads)
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        gs = list(gs) + [None] * (ctx.n_in - len(gs))
        return (None,) + tuple(gs)


class Function:
    """A differentiable op with its own backward::

        class Square(autograd.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x
            def backward(self, dy):
                x, = self._saved
                return dy * 2 * x

        y = Square()(x)

    `forward` and `backward` run with taping paused and take and return
    tensors."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        return _Bridge.apply(self, *inputs)
