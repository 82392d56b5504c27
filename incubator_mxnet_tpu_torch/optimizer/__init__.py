"""Optimizers of the PyTorch port: the base `Optimizer`, its 18 update
rules, `Updater` and `get_updater`.

Counterpart of `incubator_mxnet_tpu/optimizer/__init__.py`, rule for rule
(MXNet's rules, which are not `torch.optim`'s). The base keeps the JAX
package's plumbing: `learning_rate` (or an `lr_scheduler`, whose
`base_lr` the learning rate sets, read at the update count), `wd`,
`rescale_grad`, `clip_gradient`, per-parameter `lr_mult` / `wd_mult` (read
from the `gluon.Parameter`s in `param_dict`, else from the dicts
`set_lr_mult` / `set_wd_mult` fill, by name through `param_idx2name`), the
per-index update counts, and `multi_precision`: a float32 master copy of a
16-bit weight takes the update, and the weight is its rounding.

Every rule's `step_one(index, weight, grad, state, lr, wd[, t])` updates
`weight` and its state tensors in place, with the JAX package's arithmetic
in the same order (the JAX package donates the buffers to XLA to the same
end). `_preprocess` rescales and clips the gradient; the rules add
`wd * w` where the JAX package does (LAMB, LANS and LARS fold the decay
into their trust ratio instead). The rules that take the step count `t`
(the Adam family, FTML) take it as an argument, so `FusedTrainStep` can
give each inner step its own. SGLD draws its noise from the port's
per-device `torch.Generator` (`random.generator`), not `jax.random`: its
mean update is the JAX package's. The JAX package's multi-tensor
`fused_update_all` is one XLA fusion with no Pallas kernel; here every
parameter is updated on its own by plain torch ops (making it one pass is
later work).
"""
from __future__ import annotations

import inspect
import pickle

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Signum", "SGLD",
           "DCASGD", "NAG", "AdaGrad", "AdaDelta", "Adam", "AdamW", "Adamax",
           "Nadam", "FTML", "FTRL", "LARS", "LAMB", "LANS", "RMSProp",
           "AdaBelief", "Updater", "get_updater"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer from a registered name ('sgd') or an instance."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


_LOW = (torch.float16, torch.bfloat16)


def _zeros(weight):
    return torch.zeros_like(weight, requires_grad=False)


def _set(dst, value):
    """dst <- value, in place."""
    dst.copy_(value)


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=None,
                 use_fused_step=True, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.num_update = 0
        self._index_update_count = {}

    # ------------------------------------------------------------------
    # lr / wd
    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is set")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        param = self.param_dict.get(index)
        if param is not None:
            return lr * getattr(param, "lr_mult", 1.0)
        return lr * self.lr_mult.get(self.idx2name.get(index, index), 1.0)

    def _get_wd(self, index):
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            return wd * getattr(param, "wd_mult", 1.0)
        return wd * self.wd_mult.get(self.idx2name.get(index, index), 1.0)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _mp(self, weight):
        return self.multi_precision and weight.dtype in _LOW

    def create_state_multi_precision(self, index, weight):
        """(float32 master copy, the rule's state over it) for a 16-bit
        weight under `multi_precision`, else the rule's state."""
        if self._mp(weight):
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def _preprocess(self, grad, wd=0.0):
        """rescale, then clip (`wd` is the JAX package's argument, unused
        here as there)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        """One parameter's update, in place on `weight` (and `state`)."""
        self._update_count(index)
        self.step_one(index, weight, grad, state, self._get_lr(index),
                      self._get_wd(index))

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp(weight):
            self._update_count(index)
            self.step_multi_precision(index, weight, grad, state,
                                      self._get_lr(index),
                                      self._get_wd(index))
            return
        self.update(index, weight, grad, state)

    @torch.no_grad()
    def step_multi_precision(self, index, weight, grad, state, lr, wd,
                             **t):
        """`step_one`, through the float32 master copy for a 16-bit weight
        under `multi_precision` (the weight becomes its rounding)."""
        if self._mp(weight):
            master, inner = state
            self.step_one(index, master, grad.float(), inner, lr, wd, **t)
            weight.copy_(master)
            return
        self.step_one(index, weight, grad, state, lr, wd, **t)

    def update_all(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    def step_one(self, index, weight, grad, state, lr, wd):
        raise NotImplementedError

    @classmethod
    def _step_takes_t(cls):
        """Does `step_one` take the step count `t`?"""
        return "t" in inspect.signature(cls.step_one).parameters

    def _t(self, index, t):
        return self._index_update_count[index] if t is None else t


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------
@register
class SGD(Optimizer):
    """SGD with optional momentum:
    g = clip(rescale * grad) + wd * w; mom = momentum * mom - lr * g;
    w += mom (w -= lr * g without momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad, wd) + wd * weight
        if state is not None:
            _set(state, self.momentum * state - lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class Signum(Optimizer):
    """Signum (signSGD without momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        if state is not None:
            g = self._preprocess(grad, wd)
            _set(state, self.momentum * state
                 - (1 - self.momentum) * (g + wd * weight))
            _set(weight, (1 - lr * self.wd_lh) * weight
                 + lr * torch.sign(state))
        else:
            g = self._preprocess(grad, wd) + wd * weight
            _set(weight, (1 - lr * self.wd_lh) * weight - lr * torch.sign(g))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w - lr/2 * g + N(0, lr)."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad, wd) + wd * weight
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=_random.generator(weight.device))
        _set(weight, weight - lr / 2 * g + noise * lr ** 0.5)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        mom, prev = state
        g = self._preprocess(grad, wd) + wd * weight
        comp = g + self.lamda * g * g * (weight - prev)
        prev.copy_(weight)
        if mom is not None:
            _set(mom, self.momentum * mom - lr * comp)
            weight.add_(mom)
        else:
            _set(weight, weight - lr * comp)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad, wd) + wd * weight
        _set(state, self.momentum * state + g)
        _set(weight, weight - lr * (g + self.momentum * state))


# ---------------------------------------------------------------------------
# adaptive family
# ---------------------------------------------------------------------------
@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad, wd) + wd * weight
        _set(state, state + g * g)
        _set(weight, weight - lr * g / (torch.sqrt(state) + self.epsilon))


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        acc_g, acc_delta = state
        rho, eps = self.rho, self.epsilon
        g = self._preprocess(grad, wd) + wd * weight
        _set(acc_g, rho * acc_g + (1 - rho) * g * g)
        delta = torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps) * g
        _set(acc_delta, rho * acc_delta + (1 - rho) * delta * delta)
        _set(weight, weight - lr * delta)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _lr_t(self, lr, t):
        return lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)

    def _moments(self, g, state):
        """m, v <- the moments of g, in place; returns them."""
        mean, var = state
        b1, b2 = self.beta1, self.beta2
        _set(mean, b1 * mean + (1 - b1) * g)
        _set(var, b2 * var + (1 - b2) * g * g)
        return mean, var


@register
class Adam(_AdamBase):
    """Adam, MXNet's rule: weight decay joins the gradient,
    w -= lr_t * m / (sqrt(v) + eps), lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)."""

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        lr_t = self._lr_t(lr, self._t(index, t))
        m, v = self._moments(self._preprocess(grad, wd) + wd * weight, state)
        _set(weight, weight - lr_t * m / (torch.sqrt(v) + self.epsilon))


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay (lr * wd * w, at the base rate)."""

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        lr_t = self._lr_t(lr, self._t(index, t))
        m, v = self._moments(self._preprocess(grad, 0.0), state)
        _set(weight, weight - lr_t * m / (torch.sqrt(v) + self.epsilon)
             - lr * wd * weight)


@register
class Adamax(_AdamBase):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, **kwargs)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        mean, u = state
        lr_t = lr / (1.0 - self.beta1 ** self._t(index, t))
        g = self._preprocess(grad, wd) + wd * weight
        _set(mean, self.beta1 * mean + (1 - self.beta1) * g)
        _set(u, torch.maximum(self.beta2 * u, torch.abs(g)))
        _set(weight, weight - lr_t * mean / (u + self.epsilon))


@register
class Nadam(_AdamBase):
    """Nesterov Adam; `m_schedule` is host state, one product over every
    update the optimizer runs, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        mean, var = state
        t = self._t(index, t)
        b1, b2 = self.beta1, self.beta2
        mt = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mt_1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mt
        ms, msn = self.m_schedule, self.m_schedule * mt_1
        g = self._preprocess(grad, wd) + wd * weight
        g_prime = g / (1.0 - ms)
        _set(mean, b1 * mean + (1 - b1) * g)
        m_prime = mean / (1.0 - msn)
        _set(var, b2 * var + (1 - b2) * g * g)
        v_prime = var / (1.0 - b2 ** t)
        m_bar = (1.0 - mt) * g_prime + mt * m_prime
        _set(weight, weight - lr * m_bar / (torch.sqrt(v_prime)
                                            + self.epsilon))


@register
class AdaBelief(_AdamBase):
    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        mean, var = state
        lr_t = self._lr_t(lr, self._t(index, t))
        b1, b2 = self.beta1, self.beta2
        g = self._preprocess(grad, wd) + wd * weight
        _set(mean, b1 * mean + (1 - b1) * g)
        _set(var, b2 * var + (1 - b2) * (g - mean) * (g - mean)
             + self.epsilon)
        _set(weight, weight - lr_t * mean / (torch.sqrt(var) + self.epsilon))


@register
class FTML(Optimizer):
    """Follow the moving leader."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))  # d, v, z

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        d, v, z = state
        t = self._t(index, t)
        b1, b2 = self.beta1, self.beta2
        g = self._preprocess(grad, wd) + wd * weight
        _set(v, b2 * v + (1 - b2) * g * g)
        d_t = (1 - b1 ** t) / lr * (torch.sqrt(v / (1 - b2 ** t))
                                    + self.epsilon)
        sigma = d_t - b1 * d
        _set(z, b1 * z + (1 - b1) * g - sigma * weight)
        _set(d, d_t)
        _set(weight, -z / d_t)


@register
class FTRL(Optimizer):
    """Follow the regularized leader (proximal, L1 `lamda1`)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))   # z, n

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        z, n = state
        g = self._preprocess(grad, wd)
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
        _set(z, z + g - sigma * weight)
        _set(n, n + g * g)
        _set(weight, (torch.sign(z) * self.lamda1 - z)
             / ((self.beta + torch.sqrt(n)) / lr + wd)
             * (torch.abs(z) > self.lamda1))


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (Graves' variant, with momentum)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        rho, eps = self.rho, self.epsilon
        g = self._preprocess(grad, wd) + wd * weight
        if not self.centered:
            (n,) = state
            _set(n, rho * n + (1 - rho) * g * g)
            _set(weight, weight - lr * g / (torch.sqrt(n) + eps))
            return
        n, gbar, delta = state
        _set(n, rho * n + (1 - rho) * g * g)
        _set(gbar, rho * gbar + (1 - rho) * g)
        _set(delta, self.momentum * delta
             - lr * g / (torch.sqrt(n - gbar * gbar) + eps))
        w = weight + delta
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        _set(weight, w)


# ---------------------------------------------------------------------------
# layer-wise adaptive (large-batch) family
# ---------------------------------------------------------------------------
def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _ratio(w_norm, r_norm, num):
    """num where both norms are positive, else 1 (the trust-ratio guard)."""
    return torch.where((w_norm > 0) & (r_norm > 0), num,
                       torch.ones_like(num))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad, wd)
        w_norm, g_norm = _norm(weight), _norm(g)
        trust = _ratio(w_norm, g_norm, self.eta * w_norm
                       / (g_norm + wd * w_norm + self.epsilon))
        g = g + wd * weight
        mom = state if state is not None else _zeros(weight)
        _set(mom, self.momentum * mom + (lr * trust) * g)
        weight.sub_(mom)


@register
class LAMB(_AdamBase):
    """LAMB (You et al. 2019): Adam's direction plus wd * w, scaled by the
    trust ratio ||w|| / ||r|| (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        t = self._t(index, t)
        m, v = self._moments(self._preprocess(grad, wd), state)
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * weight
        w_norm, r_norm = _norm(weight), _norm(r)
        if self.lower_bound is not None:
            w_norm = torch.clamp(w_norm, min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = torch.clamp(w_norm, max=self.upper_bound)
        ratio = _ratio(w_norm, r_norm, w_norm / r_norm)
        _set(weight, weight - lr * ratio * r)


@register
class LANS(LAMB):
    """LAMB with Nesterov momentum and a normalized gradient."""

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        t = self._t(index, t)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g = self._preprocess(grad, wd)
        g_norm = _norm(g)
        g = torch.where(g_norm > 0, g / g_norm, g)
        m, v = self._moments(g, state)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        rm = mhat / (torch.sqrt(vhat) + eps) + wd * weight
        rg = g / (torch.sqrt(vhat) + eps) + wd * weight
        w_norm, rm_norm, rg_norm = _norm(weight), _norm(rm), _norm(rg)
        ratio_m = _ratio(w_norm, rm_norm, w_norm / rm_norm)
        ratio_g = _ratio(w_norm, rg_norm, w_norm / rg_norm)
        _set(weight, weight - lr * (b1 * ratio_m * rm
                                    + (1 - b1) * ratio_g * rg))


# ---------------------------------------------------------------------------
# Updater: the states of a store-side optimizer, and their serialization
# ---------------------------------------------------------------------------
def state_to_numpy(s):
    """An optimizer state (None, a tensor or nested tuples) as numpy."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(state_to_numpy(x) for x in s)
    s = s.detach().cpu()
    return (s.float() if s.dtype == torch.bfloat16 else s).numpy()


def state_from_numpy(s, device=None):
    """`state_to_numpy`'s inverse, on `device`."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(state_from_numpy(x, device) for x in s)
    return torch.from_numpy(np.array(s, copy=True)).to(device)


class Updater:
    """Applies an optimizer to (index, grad, weight) triples, keeping the
    states by index."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        state = {i: state_to_numpy(s) for i, s in self.states.items()}
        return pickle.dumps((state, self.optimizer) if dump_optimizer
                            else state)

    def set_states(self, states):
        data = pickle.loads(states)
        if isinstance(data, tuple):
            data, self.optimizer = data
        self.states = {i: state_from_numpy(s) for i, s in data.items()}


def get_updater(optimizer):
    return Updater(optimizer)
