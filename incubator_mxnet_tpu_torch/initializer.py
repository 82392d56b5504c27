"""Weight initializers of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/initializer.py`: `Zero`, `One`,
`Constant`, `Uniform` (the default, scale 0.07), `Normal`, `Orthogonal`,
`Xavier`, `MSRAPrelu`, `Bilinear`, `LSTMBias` and `Mixed`, the `register`
registry and `create`, which resolves an instance, a registered name (or
the aliases "zeros", "ones" and "msra") or None. As in the JAX package, an
initializer dispatches on the parameter's name: `*gamma` and names holding
`weight_v` get ones, `*beta`, `*bias` and `*running_mean` get zeros,
`*running_var` ones, everything else its own draw; `Mixed` routes by
regular expression before that.

Draws come from an explicit `torch.Generator` on the CPU (the caller seeds
one per parameter), so a seed gives the same weights on every device. They
are not the JAX package's numbers: tests that compare the two packages
compare moments, or carry weights across with `gluon.params_from_jax`.

Fans: `Xavier` and `MSRAPrelu` read them from the shape the port stores,
(O, I/groups, *kernel) for every convolution layout (a transposed
convolution's (I, O/groups, *kernel)), which is MXNet's layout, so they
are MXNet's fans in every layout. The JAX package reads the same formula
off its own storage, which for a channels-last convolution is kernel dims
first (HWIO): there its fans, and so its scale, differ from MXNet's (for
`Conv2D(256, 3, in_channels=256, layout="NHWC")` its std is about 1/9 of
MXNet's). The port keeps MXNet's; ROADMAP.md lists the difference.
"""
from __future__ import annotations

import math
import re

import torch

from .base import MXNetError

__all__ = ["Initializer", "register", "create", "Zero", "One", "Constant",
           "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu",
           "Bilinear", "LSTMBias", "Mixed", "InitDesc"]

_REGISTRY = {}


def register(klass):
    """Make `klass` resolvable by its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An initializer from an instance, a registered name (built with
    `kwargs`) or None (`Uniform()`)."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {init!r}; registered: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[name](**kwargs)
    raise TypeError(f"cannot create an initializer from {type(init)}")


class InitDesc(str):
    """A parameter's name as handed to an initializer, with `attrs`."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer: `init(name, shape, generator)` returns a float32
    CPU tensor."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, shape, generator):
        name = str(name)
        if name.endswith("gamma") or "weight_v" in name:
            return self._one(shape)
        if name.endswith("beta") or name.endswith("bias"):
            return self._zero(shape)
        if name.endswith("running_mean") or name.endswith("moving_mean"):
            return self._zero(shape)
        if name.endswith("running_var") or name.endswith("moving_var"):
            return self._one(shape)
        return self.init_array(name, shape, generator)

    def init_array(self, name, shape, generator):
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
        kw = ", ".join(f"{k}={v}" for k, v in self._kwargs.items())
        return f"{type(self).__name__}({kw})"


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
class Constant(Initializer):
    """Every element `value` (a number, or an array broadcast to the
    shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, shape, generator):
        v = torch.as_tensor(self.value, dtype=torch.float32)
        return v.expand(tuple(shape)).clone()


@register
class Uniform(Initializer):
    """Uniform on [-scale, scale) (the default weight init, scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, shape, generator):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (2.0 * self.scale) - self.scale


@register
class Normal(Initializer):
    """Normal with mean 0 and standard deviation `sigma`."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, shape, generator):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) * self.sigma


@register
class Orthogonal(Initializer):
    """`scale` times an orthonormal (out, prod(rest)) matrix (Saxe et al.):
    the SVD factor of a uniform (`rand_type="uniform"`) or normal draw
    whose shape is the weight's."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, shape, generator):
        nout = shape[0]
        nin = math.prod(shape[1:]) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=generator,
                             dtype=torch.float64) * 2.0 - 1.0
        else:
            tmp = torch.randn((nout, nin), generator=generator,
                              dtype=torch.float64)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * q.reshape(tuple(shape))).float()


def _fans(shape):
    """(fan_in, fan_out) of a weight stored (O, I/groups, *kernel): MXNet's
    fans."""
    if len(shape) < 2:
        n = max(math.prod(shape), 1)
        return n, n
    hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@register
class Xavier(Initializer):
    """Glorot: uniform on [-s, s) or normal of std s, with s =
    sqrt(magnitude / factor) and factor the fan in, the fan out or their
    mean (`factor_type` "in", "out", "avg")."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, shape, generator):
        fan_in, fan_out = _fans(shape)
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"invalid factor_type {self.factor_type!r}")
        scale = math.sqrt(self.magnitude / max(factor, 1e-12))
        if self.rnd_type == "uniform":
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return u * (2.0 * scale) - scale
        if self.rnd_type == "gaussian":
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32) * scale
        raise MXNetError(f"invalid rnd_type {self.rnd_type!r}")


@register
class MSRAPrelu(Xavier):
    """He init with the PReLU slope correction: Xavier, gaussian,
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


_REGISTRY["msra"] = MSRAPrelu


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two dims (for a
    transposed convolution)."""

    def _init_weight(self, shape, generator):
        n = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(n, dtype=torch.float64)
        x = torch.remainder(i, shape[3])
        y = torch.remainder(torch.div(i, shape[3], rounding_mode="floor"),
                            shape[2])
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        return w.float().reshape(tuple(shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (gate order i, f, g, o) set to
    `forget_bias`."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, shape, generator):
        b = self._zero(shape)
        num_hidden = shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        return b


@register
class Mixed(Initializer):
    """Route each parameter to the first initializer whose pattern
    (`re.search`) matches its name; a name no pattern matches raises."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, shape, generator):
        for pat, init in self.map:
            if pat.search(str(name)):
                return init(name, shape, generator)
        raise MXNetError(f"parameter {name!r} matched no pattern; add '.*'")
