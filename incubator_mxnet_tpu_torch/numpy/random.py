"""mx.np.random of the PyTorch port: every sampler of the JAX package's
`numpy/random.py`, drawn from the port's per-device `torch.Generator`
(`random.generator`), seeded by `seed` / `mx.seed`.

The draws differ from `jax.random`'s for the same seed (as the port's
dropout and sampling do); shapes, dtypes, the distributions and seed
reproducibility are the JAX package's. Array parameters (`low`, `loc`,
`scale`, ...) are dispatch inputs, so a sample is differentiable in them
under `record()` where the JAX package's is (reparameterized draws).
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from .. import random as _grandom
from ..base import to_torch_dtype
from ..device import resolve_device
from ..ndarray import NDArray, _wrap
from ..ops.registry import as_tensor, invoke

__all__ = [
    "seed", "uniform", "normal", "randn", "rand", "randint", "choice",
    "shuffle", "permutation", "multinomial", "categorical", "bernoulli",
    "gamma", "beta", "exponential", "poisson", "laplace", "gumbel",
    "logistic", "pareto", "power", "rayleigh", "weibull", "lognormal",
    "chisquare", "multivariate_normal",
]

seed = _grandom.seed


def _shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _dev(params, device):
    for p in params:
        if isinstance(p, NDArray):
            return p._t.device
    return resolve_device(device)


def _param(p, dev, dt):
    """A parameter as a dispatch input: an NDArray stays one, anything else
    becomes a tensor of `dt` on `dev`."""
    if isinstance(p, NDArray):
        return p
    return _wrap(as_tensor(_onp.asarray(p, dtype=_onp.float32), dev).to(dt))


def _draw(name, fn, params, size, dtype, device, out=None):
    """`fn(gen, shape, *params)` through the dispatch, `shape` the size, or
    the parameters' broadcast shape when size is None."""
    dt = to_torch_dtype(dtype or "float32")
    dev = _dev(params, device)
    nds = [_param(p, dev, dt) for p in params]
    shape = _shape(size) if size is not None else tuple(
        torch.broadcast_shapes(*[n._t.shape for n in nds])) if nds else ()
    gen = _grandom.generator(dev)

    def call(*raws):
        return fn(gen, shape, *raws).to(dt)

    res = invoke(call, tuple(nds), name="random." + name)
    if out is not None:
        out[:] = res
        return out
    return res


def _u(gen, shape, t, lo=0.0):
    u = torch.rand(shape, generator=gen, device=t.device, dtype=torch.float32)
    return u.clamp_min(lo) if lo else u


def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None, ctx=None,
            out=None):
    return _draw("uniform", lambda g, s, lo, hi: lo + (hi - lo) * _u(g, s, lo),
                 (low, high), size, dtype, device or ctx, out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None,
           out=None):
    return _draw("normal", lambda g, s, m, sd: m + sd * torch.randn(
        s, generator=g, device=m.device), (loc, scale), size, dtype,
        device or ctx, out)


def randn(*size, dtype=None, device=None):
    return normal(0.0, 1.0, size=size or None, dtype=dtype, device=device)


def rand(*size, dtype=None, device=None):
    return uniform(0.0, 1.0, size=size or None, dtype=dtype, device=device)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, device=None):
    return _draw("lognormal", lambda g, s, m, sd: torch.exp(
        m + sd * torch.randn(s, generator=g, device=m.device)),
        (mean, sigma), size, dtype, device)


def randint(low, high=None, size=None, dtype=None, device=None, ctx=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device(device or ctx)
    return _wrap(torch.randint(int(low), int(high), _shape(size),
                               generator=_grandom.generator(dev), device=dev,
                               dtype=to_torch_dtype(dtype or "int32")))


def _tensor(x, dev):
    if isinstance(x, NDArray):
        return x._t
    return as_tensor(x, dev)


def choice(a, size=None, replace=True, p=None, device=None, ctx=None):
    dev = a._t.device if isinstance(a, NDArray) else resolve_device(
        device or ctx)
    gen = _grandom.generator(dev)
    pool = _tensor(a, dev) if not isinstance(a, int) else None
    n = a if pool is None else pool.shape[0]
    shape = _shape(size)
    k = math.prod(shape)
    if p is not None:
        idx = torch.multinomial(_tensor(p, dev).float(), k, replace,
                                generator=gen)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        idx = torch.randperm(n, generator=gen, device=dev)[:k]
    out = idx.to(torch.int32) if pool is None else pool[idx]
    return _wrap(out.reshape(shape + (tuple(out.shape[1:]) if pool is not None
                                      else ())))


def permutation(x, device=None):
    dev = x._t.device if isinstance(x, NDArray) else resolve_device(device)
    gen = _grandom.generator(dev)
    if isinstance(x, NDArray):
        return _wrap(x._t[torch.randperm(x.shape[0], generator=gen,
                                         device=dev)])
    return _wrap(torch.randperm(int(x), generator=gen, device=dev).to(
        torch.int32))


def shuffle(x):
    """Shuffle the rows of `x` in place (≙ mx.np.random.shuffle)."""
    dev = x._t.device
    perm = torch.randperm(x.shape[0], generator=_grandom.generator(dev),
                          device=dev)
    with torch.no_grad():
        x._t.copy_(x._t[perm])


def multinomial(n, pvals, size=None):
    """Counts of `n` draws over `pvals` (float32, as jax.random's), of
    shape size + (k,)."""
    dev = pvals._t.device if isinstance(pvals, NDArray) else resolve_device()
    pv = _tensor(pvals, dev).float()
    shape = _shape(size)
    b = math.prod(shape)
    k = pv.shape[-1]
    draws = torch.multinomial(pv.expand(b, k), n, True,
                              generator=_grandom.generator(dev))
    counts = torch.zeros(b, k, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return _wrap(counts.reshape(shape + (k,)).float())


def categorical(logits, shape=None):
    """Indices drawn with probabilities softmax(logits) over the last axis
    (Gumbel-max, as jax.random.categorical)."""
    lg = _tensor(logits, logits._t.device if isinstance(logits, NDArray)
                 else resolve_device()).float()
    out_shape = _shape(shape) if shape is not None else tuple(lg.shape[:-1])
    u = torch.rand(out_shape + (lg.shape[-1],),
                   generator=_grandom.generator(lg.device), device=lg.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return _wrap(torch.argmax(lg + g, dim=-1).to(torch.int32))


def bernoulli(prob=None, logit=None, size=None, dtype=None, device=None):
    p = prob if logit is None else None
    if logit is not None:
        lg = logit if isinstance(logit, NDArray) else _wrap(as_tensor(
            _onp.asarray(logit, _onp.float32), resolve_device(device)))
        p = _wrap(torch.sigmoid(lg._t))
    return _draw("bernoulli", lambda g, s, pr: (_u(g, s, pr) < pr),
                 (p,), size, dtype, device)


def _std_gamma(g, s, a):
    return torch._standard_gamma(a.float().expand(s).contiguous(),
                                 generator=g)


def gamma(shape_param, scale=1.0, size=None, dtype=None, device=None,
          ctx=None):
    return _draw("gamma", lambda g, s, a, sc: _std_gamma(g, s, a) * sc,
                 (shape_param, scale), size, dtype, device or ctx)


def beta(a, b, size=None, dtype=None, device=None):
    def f(g, s, x, y):
        gx, gy = _std_gamma(g, s, x), _std_gamma(g, s, y)
        return gx / (gx + gy)
    return _draw("beta", f, (a, b), size, dtype, device)


def exponential(scale=1.0, size=None, dtype=None, device=None, ctx=None):
    return _draw("exponential", lambda g, s, sc: sc * torch.empty(
        s, device=sc.device).exponential_(generator=g), (scale,), size,
        dtype, device or ctx)


def poisson(lam=1.0, size=None, dtype=None, device=None):
    return _draw("poisson", lambda g, s, lm: torch.poisson(
        lm.float().expand(s).contiguous(), generator=g), (lam,), size,
        dtype or "int32", device)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
            ctx=None):
    def f(g, s, m, sc):
        u = _u(g, s, m, 1e-20) - 0.5
        return m - sc * torch.sign(u) * torch.log1p(-2 * u.abs())
    return _draw("laplace", f, (loc, scale), size, dtype, device or ctx)


def gumbel(loc=0.0, scale=1.0, size=None, dtype=None, device=None):
    return _draw("gumbel", lambda g, s, m, sc: m - sc * torch.log(
        -torch.log(_u(g, s, m, 1e-20))), (loc, scale), size, dtype, device)


def logistic(loc=0.0, scale=1.0, size=None, dtype=None, device=None):
    def f(g, s, m, sc):
        u = _u(g, s, m, 1e-20)
        return m + sc * (torch.log(u) - torch.log1p(-u))
    return _draw("logistic", f, (loc, scale), size, dtype, device)


def pareto(a, size=None, device=None):
    """numpy's Pareto II (Lomax): exp(E / a) - 1, E a standard
    exponential."""
    return _draw("pareto", lambda g, s, b: torch.exp(torch.empty(
        s, device=b.device).exponential_(generator=g) / b) - 1.0, (a,), size,
        None, device)


def power(a, size=None, device=None):
    return _draw("power", lambda g, s, b: torch.pow(_u(g, s, b), 1.0 / b),
                 (a,), size, None, device)


def rayleigh(scale=1.0, size=None, device=None):
    return _draw("rayleigh", lambda g, s, sc: sc * torch.sqrt(
        -2.0 * torch.log(_u(g, s, sc, 1e-20))), (scale,), size, None, device)


def weibull(a, size=None, device=None):
    return _draw("weibull", lambda g, s, b: torch.pow(
        -torch.log(_u(g, s, b, 1e-20)), 1.0 / b), (a,), size, None, device)


def chisquare(df, size=None, dtype=None, device=None):
    return gamma(df / 2.0, 2.0, size=size, dtype=dtype, device=device)


def multivariate_normal(mean, cov, size=None, device=None):
    dev = _dev((mean, cov), device)
    gen = _grandom.generator(dev)
    shape = _shape(size)
    mn = mean if isinstance(mean, NDArray) else _wrap(as_tensor(
        _onp.asarray(mean, _onp.float32), dev))
    cv = cov if isinstance(cov, NDArray) else _wrap(as_tensor(
        _onp.asarray(cov, _onp.float32), dev))

    def call(m, c):
        z = torch.randn(shape + (m.shape[-1],), generator=gen, device=dev)
        return m + z @ torch.linalg.cholesky(c).T

    return invoke(call, (mn, cv), name="random.multivariate_normal")
