"""Optimizers of the PyTorch port: the base `Optimizer`, `SGD`, `Adam` and
`AdamW`.

Counterpart of `incubator_mxnet_tpu/optimizer/__init__.py`. The base keeps
the JAX package's plumbing: `learning_rate`, `wd`, `rescale_grad`,
`clip_gradient`, per-parameter `lr_mult`/`wd_mult` (read from the
parameters in `param_dict`, else from the `lr_mult`/`wd_mult` dicts) and
the per-index update counts. `SGD` follows MXNet's rule, which is not
`torch.optim.SGD`'s:

    g   = clip(rescale_grad * grad) + wd * w
    mom = momentum * mom - lr * g            (with momentum)
    w   = w + mom                            (w - lr * g without)

`Adam` and `AdamW` follow MXNet's rule too (`optimizer/__init__.py:710-781`
of the JAX package), with step count t per parameter:

    lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    g    = clip(rescale_grad * grad) (+ wd * w for Adam)
    m    = beta1 * m + (1 - beta1) * g
    v    = beta2 * v + (1 - beta2) * g^2
    w    = w - lr_t * m / (sqrt(v) + epsilon) (- lr * wd * w for AdamW:
           decoupled decay at the base rate)

Updates are in place on the weight and state tensors (the JAX package
donates the buffers to the same effect).
"""
from __future__ import annotations

import inspect

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "register", "create"]

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


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.num_update = 0
        self._index_update_count = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

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
        return lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            return wd * getattr(param, "wd_mult", 1.0)
        return wd * self.wd_mult.get(index, 1.0)

    def create_state(self, index, weight):
        return None

    def _preprocess(self, grad):
        """rescale, then clip."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        """One parameter's update, in place on `weight` (and `state`)."""
        self._update_count(index)
        self.step_one(index, weight, grad, state, self._get_lr(index),
                      self._get_wd(index))

    def step_one(self, index, weight, grad, state, lr, wd):
        raise NotImplementedError

    @classmethod
    def _step_takes_t(cls):
        """Does `step_one` take the step count `t` (the Adam family)?"""
        return "t" in inspect.signature(cls.step_one).parameters


@register
class SGD(Optimizer):
    """SGD with optional momentum, MXNet's rule (see the module doc)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, requires_grad=False)

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd):
        g = self._preprocess(grad) + wd * weight
        if state is not None:
            state.copy_(self.momentum * state - lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def _moments(self, index, g, state, lr, t):
        """Update the moments in place; returns (lr_t, m, v)."""
        mean, var = state
        if t is None:
            t = self._index_update_count[index]
        lr_t = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean.mul_(self.beta1).add_((1 - self.beta1) * g)
        var.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        return lr_t, mean, var


@register
class Adam(_AdamBase):
    """Adam with MXNet's rule: weight decay is added to the gradient."""

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        g = self._preprocess(grad) + wd * weight
        lr_t, m, v = self._moments(index, g, state, lr, t)
        weight.sub_(lr_t * m / (v.sqrt() + self.epsilon))


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay (lr * wd * w, at the base rate)."""

    @torch.no_grad()
    def step_one(self, index, weight, grad, state, lr, wd, t=None):
        decay = (lr * wd) * weight
        lr_t, m, v = self._moments(index, self._preprocess(grad), state, lr,
                                   t)
        weight.sub_(lr_t * m / (v.sqrt() + self.epsilon)).sub_(decay)
