"""Weight initializers of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/initializer.py` for what the ported
Gluon layers need: `Uniform` (the default, scale 0.07), `Normal` (sigma
0.01, `PositionalEmbedding`'s), `Zero` and `One`, resolved by `create`
from an instance, a name or None. As in the JAX package, an initializer dispatches on the
parameter's name: `*gamma` and `*running_var` get ones, `*beta`, `*bias`
and `*running_mean` get zeros, everything else its own draw.

Draws come from an explicit `torch.Generator` on the CPU (the caller seeds
one per parameter), so a seed gives the same weights on every device. They
are not the JAX package's numbers: tests that compare the two packages
carry weights across with `gluon.params_from_jax`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "create"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class Initializer:
    """Base initializer: `init(name, shape, generator)` returns a float32
    CPU tensor."""

    def __call__(self, name, shape, generator):
        name = str(name)
        if name.endswith("gamma"):
            return self._one(shape)
        if name.endswith("beta") or name.endswith("bias"):
            return self._zero(shape)
        if name.endswith("running_mean") or name.endswith("moving_mean"):
            return self._zero(shape)
        if name.endswith("running_var") or name.endswith("moving_var"):
            return self._one(shape)
        return self._init_weight(shape, generator)

    def _init_weight(self, shape, generator):
        raise NotImplementedError

    @staticmethod
    def _zero(shape):
        return torch.zeros(shape, dtype=torch.float32)

    @staticmethod
    def _one(shape):
        return torch.ones(shape, dtype=torch.float32)

    def __repr__(self):
        return f"{type(self).__name__}()"


@register
class Zero(Initializer):
    def _init_weight(self, shape, generator):
        return self._zero(shape)


@register
class One(Initializer):
    def _init_weight(self, shape, generator):
        return self._one(shape)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """Uniform on [-scale, scale) (the default weight init, scale 0.07)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, generator):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (2.0 * self.scale) - self.scale


@register
class Normal(Initializer):
    """Normal with mean 0 and standard deviation `sigma`."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, shape, generator):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) * self.sigma


def create(init):
    """An initializer from an instance, a registered name or None
    (`Uniform()`)."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {init!r}; registered: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[name]()
    raise TypeError(f"cannot create an initializer from {type(init)}")
