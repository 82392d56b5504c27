"""mx.test_utils of the PyTorch port: the numeric-checking helpers.

Counterpart of `incubator_mxnet_tpu/test_utils.py`, with its names and
tolerances: `assert_almost_equal` with per-dtype tolerances, gradients
checked against central finite differences, the same function run on a
list of devices, random shapes and arrays. The port's arrays are 32-bit
(a float64 source is float32), so `check_numeric_gradient` differences a
float32 function: keep `eps` well above float32's resolution of the
inputs, as the JAX package's default 1e-3 is.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .device import current_device

__all__ = [
    "default_context", "default_device", "set_default_context",
    "assert_almost_equal", "almost_equal", "same", "rand_ndarray",
    "rand_shape_2d", "rand_shape_3d", "rand_shape_nd", "random_arrays",
    "check_numeric_gradient", "check_consistency", "numeric_grad",
    "default_rtols", "default_atols", "effective_dtype",
]

_default_ctx = [None]


def default_context():
    """The device set by `set_default_context`, else the current one."""
    return _default_ctx[0] or current_device()


default_device = default_context


def set_default_context(ctx):
    _default_ctx[0] = ctx


def _dtype_of(x):
    return _np.dtype(getattr(x, "dtype", _np.float64))


def default_rtols(dtype):
    """The relative tolerance of a dtype (name or dtype)."""
    name = str(dtype)
    return {"float16": 1e-2, "bfloat16": 1.6e-2, "float32": 1e-4,
            "float64": 1e-7}.get(name, 0.0)


def default_atols(dtype):
    name = str(dtype)
    return {"float16": 1e-3, "bfloat16": 3.2e-3, "float32": 1e-5,
            "float64": 1e-9}.get(name, 0.0)


def effective_dtype(x):
    return _dtype_of(x)


def _to_np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().float().numpy() \
            if str(x.dtype) == "torch.bfloat16" else x.detach().cpu().numpy()
    return _np.asarray(x)


def _tols(a, b, rtol, atol):
    rtol = rtol if rtol is not None else max(default_rtols(a.dtype),
                                             default_rtols(b.dtype))
    atol = atol if atol is not None else max(default_atols(a.dtype),
                                             default_atols(b.dtype))
    return rtol, atol


def same(a, b):
    return _np.array_equal(_to_np(a), _to_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    a, b = _to_np(a), _to_np(b)
    rtol, atol = _tols(a, b, rtol, atol)
    return _np.allclose(a.astype(_np.float64), b.astype(_np.float64),
                        rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Assert `a` and `b` agree within the tolerances of their dtypes (or
    the ones given)."""
    an, bn = _to_np(a), _to_np(b)
    rtol, atol = _tols(an, bn, rtol, atol)
    _np.testing.assert_allclose(
        an.astype(_np.float64), bn.astype(_np.float64), rtol=rtol, atol=atol,
        equal_nan=equal_nan,
        err_msg=f"{names[0]} vs {names[1]} mismatch (rtol={rtol}, atol={atol})")


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1),
            _np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 device=None, ctx=None):
    """A dense array of uniform values in [-1, 1) (sparse storage types are
    not ported: ROADMAP A12)."""
    if stype != "default":
        raise MXNetError(f"stype {stype!r}: sparse arrays are not ported "
                         f"(ROADMAP A12)")
    from .ndarray import array
    return array(_np.random.uniform(-1, 1, shape).astype(dtype),
                 device=device or ctx)


def random_arrays(*shapes):
    arrays = [_np.random.randn(*s).astype(_np.float64) if s else
              _np.asarray(_np.random.randn()) for s in shapes]
    return arrays if len(arrays) > 1 else arrays[0]


def numeric_grad(f, xs, eps=1e-4):
    """Central finite differences of scalar f w.r.t. list of numpy arrays."""
    grads = []
    for x in xs:
        g = _np.zeros_like(x, dtype=_np.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(f(*xs))
            flat[j] = orig - eps
            fm = float(f(*xs))
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(fn, inputs, rtol=1e-2, atol=1e-4, eps=1e-3):
    """Autograd's gradients of `fn` (NDArrays -> a scalar NDArray) at the
    numpy `inputs` against central finite differences."""
    from . import autograd
    from .ndarray import array
    nds = [array(x) for x in inputs]
    for nd in nds:
        nd.attach_grad()
    with autograd.record():
        loss = fn(*nds)
    loss.backward()
    analytic = [nd.grad.asnumpy() for nd in nds]

    def host_f(*xs):
        return fn(*[array(x) for x in xs]).asnumpy()

    numeric = numeric_grad(host_f, [x.astype(_np.float64) for x in inputs],
                           eps)
    for a, n in zip(analytic, numeric):
        _np.testing.assert_allclose(a, n, rtol=rtol, atol=atol)


def check_consistency(sym_fn, ctx_list, inputs, rtol=1e-4, atol=1e-5):
    """Run `sym_fn` over the same `inputs` on each device of `ctx_list`
    and assert the results agree; returns them."""
    from .ndarray import array
    results = []
    for ctx in ctx_list:
        nds = [array(x, device=ctx) for x in inputs]
        results.append(_to_np(sym_fn(*nds)))
    for r in results[1:]:
        _np.testing.assert_allclose(results[0], r, rtol=rtol, atol=atol)
    return results
