"""FusedTrainStep and FusedInferStep of the PyTorch port.

`FusedTrainStep`: forward, loss, backward, optional global-norm clipping
and the optimizer update in one call.

Counterpart of `incubator_mxnet_tpu/gluon/contrib/fused.py::FusedTrainStep`:

    step = FusedTrainStep(net, fn, optimizer)   # fn(net, *inputs) -> loss
    loss = step(x, y)

`fn` receives the live net and the step inputs and returns a scalar loss
tensor, or a tuple (loss, *extras) whose extras pass through. The step
runs eagerly on the net's device. Weights and optimizer state are updated
in place, where the JAX package donates its buffers to XLA to the same
end: `donate=` is taken and recorded (`self._donate`) and changes
nothing. `remat` and `donate` resolve as the JAX package's do: explicit
argument > active `mx.tune` profile (`train.remat`, `train.donate`) >
default, behind a sentinel, since `None` is a real remat policy. The
step body is one program, `fused.train_step`, whose in-place arguments
are the trainable weights and the optimizer state: with an
`MXNET_SANITIZE` mode armed at construction it runs under
`sanitize.maybe_wrap_donated` (its aliasing and in-place checks, and the
recompile sentinel over its argument signatures). With
`steps_per_call=K` the call loops K steps over inputs with a leading K
axis and returns the K losses; the
learning rates are resolved once per call, as in the JAX package, and a
rule that takes the step count (the Adam family) sees each inner step's
own count.

The net runs in the JAX step's scope, `autograd._Scope(recording=False,
training=True)`, taped (`autograd.is_taping()`: its blocks record the
graph the gradients come from): training mode (BatchNorm takes batch
statistics and updates its running stats, as the JAX step's aux buffers
are updated),
with the gradients taken by `torch.autograd.grad` (no `.grad` is written),
and inside `fusion_scope(use_fusion)`: with fusion on (the
default; `use_fusion=False` gives the unfused step) the Gluon blocks route
through the fused ops, whose CUDA kernels run on the card. CUDA-graph capture of the
step comes later.

`remat` is the JAX step's `jax.checkpoint` policy over the whole loss
function: None saves what PyTorch's autograd saves; "full" runs `fn`
under `torch.utils.checkpoint` and saves nothing of it between the
forward and the backward (its forward runs again in the backward,
kernels and all: each forward kernel launches twice a step); "dots"
saves only the outputs of matrix products and convolutions (`aten.mm`,
`addmm`, `bmm`, `baddbmm`, `convolution`, through selective activation
checkpointing) and recomputes the rest, the fused applies and the flash
kernels included, as `dots_saveable` (`dot_general` and
`conv_general_dilated`) does. The function is one region, so the recompute holds
its activations again at the start of the backward, and the peak device
memory does not fall (the JAX package's policies trade operations for
the saved residuals' memory traffic).
The recompute runs in the scope of the first pass (the training, taping
and fusion flags, which are per thread, and PyTorch may run the backward
on another thread), draws the same dropout masks (the port's generator,
which `preserve_rng_state` does not cover, is set back to its state at
the first pass and restored after), and leaves BatchNorm's running
statistics alone (`autograd.is_recomputing()`). An unknown policy raises.

`FusedInferStep` is the JAX package's chained inference step:

    step = FusedInferStep(net)
    logits = step(x0)        # seed the chain
    logits = step()          # continue it: x <- x + perturb * mean(logits)

Each call runs `steps_per_call` forwards of the net in inference mode (no
dropout, running statistics, nothing taped) inside `fusion_scope(
use_fusion)` (default on), each feeding the next its input perturbed by
`perturb` times the mean of its logits, and returns the last logits. The
data dependence orders the calls as the JAX step's donated buffer does;
the port runs it eagerly (CUDA-graph capture comes later).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from ... import autograd
from ... import optimizer as opt_mod
from ... import random as _random
from ... import sanitize as _sanitize
from ...base import MXNetError
from ...ndarray import NDArray, _wrap
from ...ops import fused as _fused

__all__ = ["FusedTrainStep", "FusedInferStep"]

_REMAT = (None, "full", "dots")
# "the caller said nothing" (None is a real remat policy), so the profile
# tier can tell the two apart
_TUNE_UNSET = object()
_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                   _aten.convolution))


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep a matrix product's or a convolution's
    output, recompute every other op."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE
            if getattr(op, "overloadpacket", None) in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialized(fn, policy, device):
    """`fn(*inputs)` under `torch.utils.checkpoint` with `policy` ("full"
    or "dots"), its recompute replaying the first pass's scope and
    dropout generator."""
    def run(*inputs):
        gen = _random.generator(device)
        start = gen.get_state()
        scope = dict(recording=autograd.is_recording(),
                     training=autograd.is_training(),
                     taping=autograd.is_taping(), recomputing=True)
        fusion = _fused.fusion_enabled()
        passes = []

        def body(*a):
            if not passes:
                passes.append(1)
                return fn(*a)
            now = gen.get_state()
            gen.set_state(start)
            try:
                with autograd._Scope(**scope), _fused.fusion_scope(fusion):
                    return fn(*a)
            finally:
                gen.set_state(now)

        kw = {} if policy == "full" else {"context_fn": functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)}
        return _ckpt.checkpoint(body, *inputs, use_reentrant=False, **kw)
    return run


def _initialized_params(net, message):
    """The net's Parameters in name order, a Parameter shared by two
    blocks (tied weights) once; raises `message` when one is not drawn
    yet."""
    params, seen = [], set()
    for _, p in sorted(net.collect_params().items()):
        if id(p) not in seen:
            seen.add(id(p))
            params.append(p)
    if any(p._data is None for p in params):
        raise MXNetError(message)
    return params


class FusedInferStep:
    """`steps_per_call` chained inference forwards per call."""

    def __init__(self, net, perturb=1e-6, steps_per_call=1,
                 use_fusion=None):
        params = _initialized_params(
            net, "FusedInferStep needs a fully initialized net: run one "
                 "forward pass first")
        self._net = net
        self._device = params[0].data().device if params else None
        self._perturb = perturb
        self._K = int(steps_per_call)
        if self._K < 1:
            raise MXNetError("steps_per_call must be >= 1")
        self._use_fusion = True if use_fusion is None else bool(use_fusion)
        self._x = None
        self._nd = False

    def __call__(self, x=None):
        if x is not None:
            self._nd = isinstance(x, NDArray)
            x = getattr(x, "_t", x)
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            # the chain owns its input: seed it with a copy
            self._x = x.detach().to(self._device, copy=True)
        if self._x is None:
            raise MXNetError("seed the chain: step(x0) before step()")
        with autograd._Scope(recording=False, training=False,
                             grad_mode=False, taping=False), \
                _fused.fusion_scope(self._use_fusion):
            for _ in range(self._K):
                logits = self._net(self._x)
                self._x = self._x + (self._perturb * logits.mean()).to(
                    self._x.dtype)
        return _wrap(logits) if self._nd else logits


class FusedTrainStep:
    """One training step per call (K with `steps_per_call=K`)."""

    def __init__(self, net, fn, optimizer, clip_global_norm=None,
                 steps_per_call=1, remat=_TUNE_UNSET, donate=_TUNE_UNSET,
                 use_fusion=None):
        # knob precedence: explicit arg > deployment profile > default
        from ...tune.profile import resolve as _tune_resolve
        if remat is _TUNE_UNSET:
            remat = _tune_resolve("train.remat")
        if donate is _TUNE_UNSET:
            donate = _tune_resolve("train.donate", True)
        # recorded only: the step updates its buffers in place
        self._donate = bool(donate)
        if remat not in _REMAT:
            raise MXNetError(f"unknown remat policy {remat!r}")
        self._remat = remat
        self._opt = opt_mod.create(optimizer)
        self._net = net
        self._fn = fn
        self._clip = clip_global_norm
        self._K = int(steps_per_call)
        if self._K < 1:
            raise MXNetError("steps_per_call must be >= 1")
        self._use_fusion = True if use_fusion is None else bool(use_fusion)
        params = _initialized_params(
            net, "FusedTrainStep needs a fully initialized net: run one "
                 "forward pass first (deferred shapes must be resolved)")
        self._params = params
        self._device = params[0].data().device
        # per-parameter lr_mult/wd_mult resolve through param_dict, as in
        # the JAX package
        self._opt.param_dict = dict(enumerate(params))
        self._train_idx = [i for i, p in enumerate(params)
                           if p.grad_req != "null"]
        self._states = None
        # the step body as one program over its in-place arguments (the
        # trainable weights, the optimizer state)
        self._prog = _sanitize.maybe_wrap_donated(
            self._program, (0, 1), "fused.train_step")

    def _stage(self, a):
        a = getattr(a, "_t", a)             # an NDArray's tensor
        if isinstance(a, torch.Tensor):
            return a.to(self._device)
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)
        return a

    def __call__(self, *inputs):
        opt = self._opt
        params = [p.data() for p in self._params]
        if self._states is None:
            self._states = [opt.create_state_multi_precision(i, params[i])
                            for i in self._train_idx]
        for _ in range(self._K):
            for i in self._train_idx:
                opt._update_count(i)
        lrs = [opt._get_lr(i) for i in self._train_idx]
        wds = [opt._get_wd(i) for i in self._train_idx]
        # t = the count at each inner step: the first one's, plus k
        ts = ([opt._index_update_count[i] - self._K + 1
               for i in self._train_idx]
              if type(opt)._step_takes_t() else None)
        train = [params[i] for i in self._train_idx]
        staged = [self._stage(a) for a in inputs]
        losses, extras_k = self._prog(train, self._states, staged,
                                      (lrs, wds, ts))
        if self._K == 1:
            loss, extras = losses[0], extras_k[0]
        else:
            loss = torch.stack(losses)
            extras = tuple(torch.stack(es) for es in zip(*extras_k))
        if any(isinstance(a, NDArray) for a in inputs):
            loss, extras = _wrap(loss), tuple(_wrap(e) for e in extras)
        return (loss,) + extras if extras else loss

    def _program(self, train, states, staged, rates):
        """K steps of forward, loss, backward, clipping and the update of
        `train` and `states` in place; returns (losses, extras)."""
        opt = self._opt
        lrs, wds, ts = rates
        forward = functools.partial(self._fn, self._net)
        if self._remat is not None:
            forward = _rematerialized(forward, self._remat, self._device)
        losses, extras_k = [], []
        with autograd._Scope(recording=False, training=True,
                             grad_mode=True, taping=True):
            for k in range(self._K):
                in_k = [a[k] for a in staged] if self._K > 1 else staged
                with _fused.fusion_scope(self._use_fusion):
                    out = forward(*in_k)
                if isinstance(out, (tuple, list)):
                    loss, extras = out[0], tuple(out[1:])
                else:
                    loss, extras = out, ()
                grads = torch.autograd.grad(loss, train, allow_unused=True)
                grads = [torch.zeros_like(t) if g is None else g
                         for g, t in zip(grads, train)]
                if self._clip is not None:
                    total = sum(g.float().square().sum() for g in grads)
                    scale = torch.clamp(
                        self._clip / torch.clamp(total.sqrt(), min=1e-12),
                        max=1.0)
                    grads = [g * scale.to(g.dtype) for g in grads]
                for j, i in enumerate(self._train_idx):
                    t = {} if ts is None else {"t": ts[j] + k}
                    opt.step_multi_precision(i, train[j], grads[j],
                                             states[j], lrs[j], wds[j], **t)
                losses.append(loss.detach())
                extras_k.append(tuple(e.detach() for e in extras))
        return losses, extras_k
