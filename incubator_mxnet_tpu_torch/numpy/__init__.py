"""mx.np of the PyTorch port: the NumPy-compatible array frontend.

Counterpart of `incubator_mxnet_tpu/numpy/__init__.py`. Every name of the
JAX package's `_JNP_NAMES` goes through one table, `_TABLE`, that maps a
numpy name to a function over torch tensors with numpy's signature
(`axis` to `dim`, `keepdims` to `keepdim`, `ddof` to `correction`,
`indices_or_sections` to `tensor_split`, `max`/`min` values only, ...).
Each call dispatches through `ops.registry.invoke` under the numpy name,
so AMP casts by that name as the JAX package's dispatch does.

Result dtypes are the JAX package's, which runs with 64-bit types off: a
64-bit result is narrowed to its 32-bit type (int32 reductions stay int32
where torch gives int64, `argmax` gives int32), the mean of ints is
float32, and a Python scalar does not widen an array (a bfloat16 array
times 2.0 stays bfloat16: torch's promotion with Python scalars is JAX's
weak typing).

Names torch has no function for go to host numpy, as the JAX package
sends the names jax lacks there; `fallback_names()` lists them and
`fallback_calls()` counts their calls (the card's paths show none).
"""
from __future__ import annotations

import builtins as _b
import math

import numpy as _onp
import torch
import torch.nn.functional as F

from ..base import (BFLOAT16, NARROW, from_torch_dtype, name_to_dtype,
                    to_torch_dtype)
from ..ndarray import (NDArray, _as_nd, _int_by_zero, _pow, _wrap, waitall,
                       array, zeros, ones, full, empty, arange, save, load)
from ..ops import nn as _nn
from ..ops.registry import as_tensor, invoke, register_op
from ..device import resolve_device

ndarray = NDArray

__all__ = [
    "ndarray", "array", "zeros", "ones", "full", "empty", "arange",
    "random", "linalg", "newaxis", "pi", "e", "inf", "nan",
    "float32", "float64", "float16", "bfloat16", "int8", "int16", "int32",
    "int64", "uint8", "bool_", "save", "load", "waitall",
]

newaxis = None
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
bfloat16 = "bfloat16"


# ---------------------------------------------------------------------------
# helpers over tensors
# ---------------------------------------------------------------------------
def _T(x, like=None):
    """`x` as a tensor (a Python scalar as a 0-d tensor of its kind, on
    like's device)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, (bool, int, float, complex)):
        return torch.tensor(x, device=dev)
    return as_tensor(x, dev)


def _fl(x):
    """Ints and bools as float32 (numpy's float functions of them)."""
    x = _T(x)
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _dims(a, axis):
    if axis is None:
        return tuple(range(a.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _merge(a, axis):
    """`a` with the reduced axes moved last and merged into one, and the
    shape a keepdims result takes."""
    dims = sorted(d % _b.max(a.dim(), 1) for d in _dims(a, axis))
    rest = [d for d in range(a.dim()) if d not in dims]
    b = a.permute(rest + dims).reshape([a.shape[d] for d in rest] + [-1])
    keep = [1 if d in dims else a.shape[d] for d in range(a.dim())]
    return b, keep


def _red(f, a, axis, keepdims, *args):
    """f(b, *args) over the last dim of `_merge(a, axis)`."""
    b, keep = _merge(a, axis)
    out = f(b, *args)
    return out.reshape(keep) if keepdims else out


def _sum(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None):
    a = _T(a)
    if where is not None:
        a = torch.where(_T(where, a), a, torch.zeros((), dtype=a.dtype,
                                                     device=a.device))
    r = a.sum(dim=_dims(a, axis), keepdim=keepdims, dtype=dtype)
    return r if initial is None else r + initial


def _prod(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None):
    a = _T(a)
    r = _red(lambda b: b.prod(-1, dtype=dtype), a, axis, keepdims)
    return r if initial is None else r * initial


def _mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    a = _fl(a)
    return a.mean(dim=_dims(a, axis), keepdim=keepdims, dtype=dtype)


def _var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, correction=None):
    a = _fl(a)
    c = ddof if correction is None else correction
    return torch.var(a, dim=_dims(a, axis), correction=c, keepdim=keepdims)


def _std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, correction=None):
    return _var(a, axis, dtype, out, ddof, keepdims, where,
                correction).sqrt()


def _amax(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _T(a)
    return torch.amax(a, dim=_dims(a, axis), keepdim=keepdims)


def _amin(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _T(a)
    return torch.amin(a, dim=_dims(a, axis), keepdim=keepdims)


def _nanfill(a, v):
    return torch.where(torch.isnan(a), torch.full((), v, dtype=a.dtype,
                                                  device=a.device), a)


def _nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None):
    a = _fl(a)
    d = _dims(a, axis)
    cnt = (~torch.isnan(a)).sum(dim=d, keepdim=True)
    m = torch.nansum(a, dim=d, keepdim=True) / cnt
    v = torch.nansum((a - m) ** 2, dim=d, keepdim=True) / (cnt - ddof)
    return v if keepdims else v.squeeze(d) if d else v


def _nanmin(a, axis=None, out=None, keepdims=False, initial=None,
            where=None):
    a = _T(a)
    if not a.is_floating_point():
        return _amin(a, axis, keepdims=keepdims)
    d = _dims(a, axis)
    r = torch.amin(_nanfill(a, math.inf), dim=d, keepdim=keepdims)
    return torch.where(torch.isnan(a).all(dim=d, keepdim=keepdims),
                       math.nan, r)


def _nanmax(a, axis=None, out=None, keepdims=False, initial=None,
            where=None):
    a = _T(a)
    if not a.is_floating_point():
        return _amax(a, axis, keepdims=keepdims)
    d = _dims(a, axis)
    r = torch.amax(_nanfill(a, -math.inf), dim=d, keepdim=keepdims)
    return torch.where(torch.isnan(a).all(dim=d, keepdim=keepdims),
                       math.nan, r)


def _argext(f, a, axis, keepdims):
    a = _T(a)
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    if axis is None:
        r = f(a.reshape(-1))
        return r.reshape([1] * a.dim()) if keepdims else r
    return f(a, dim=axis, keepdim=keepdims)


def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, nan=False):
    a = _fl(a)
    dt = a.dtype
    if dt in (torch.float16, torch.bfloat16):
        # torch.quantile takes float32 and float64 only; the JAX package
        # returns the 16-bit type
        a = a.float()
    qt = _T(q, a).to(a.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    b, keep = _merge(a, axis)
    r = fn(b, qt, dim=-1, interpolation=method)
    if keepdims:
        r = r.reshape(tuple(qt.shape) + tuple(keep))
    return r.to(dt)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _fl(a)
    if weights is None:
        avg = a.mean(dim=_dims(a, axis), keepdim=keepdims)
        wsum = torch.full_like(avg, a.numel() / _b.max(avg.numel(), 1))
    else:
        w = _T(weights, a).to(a.dtype)
        if w.shape != a.shape:
            shape = [1] * a.dim()
            shape[axis] = -1
            w = w.reshape(shape).expand(a.shape)
        d = _dims(a, axis)
        wsum = w.sum(dim=d, keepdim=keepdims)
        avg = (a * w).sum(dim=d, keepdim=keepdims) / wsum
    return (avg, wsum) if returned else avg


def _cum(f, a, axis, dtype):
    a = _T(a)
    if dtype is None and a.dtype in (torch.int8, torch.uint8, torch.int16):
        dtype = a.dtype      # JAX keeps a small integer type (and wraps)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return f(a, dim=axis, dtype=dtype)


def _count_nonzero(a, axis=None, keepdims=False):
    a = _T(a)
    r = torch.count_nonzero(a, dim=_dims(a, axis))
    return r.reshape([1 if d in _dims(a, axis) else a.shape[d]
                      for d in range(a.dim())]) if keepdims else r


def _histogram_edges(a, bins, rng):
    if isinstance(bins, int):
        lo, hi = (a.min().item(), a.max().item()) if rng is None else rng
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        return torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                              device=a.device).to(torch.float32)
    return _T(bins, a).float()


def _histogram(a, bins=10, range=None, weights=None, density=None):
    a = _fl(a).reshape(-1)
    edges = _histogram_edges(a, bins, range)
    n = edges.numel() - 1
    idx = torch.bucketize(a, edges, right=True) - 1
    idx = torch.where(a == edges[-1], n - 1, idx)
    ok = (idx >= 0) & (idx < n)
    w = None if weights is None else _T(weights, a).reshape(-1)[ok].float()
    counts = torch.bincount(idx[ok], weights=w, minlength=n)
    if density:
        counts = counts / (counts.sum() * torch.diff(edges))
    elif w is None:
        counts = counts.float()
    return counts, edges


def _dot(a, b, out=None, precision=None, preferred_element_type=None):
    a, b = _T(a), _T(b, a)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def _tensordot(a, b, axes=2, precision=None, preferred_element_type=None):
    if not isinstance(axes, int):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    return torch.diagonal(a, offset, axis1, axis2).sum(-1, dtype=dtype)


def _reshape(a, shape=None, order="C", newshape=None, copy=None):
    shape = newshape if shape is None else shape
    return _T(a).reshape((shape,) if isinstance(shape, int) else shape)


def _transpose(a, axes=None):
    a = _T(a)
    return a.permute(tuple(reversed(range(a.dim()))) if axes is None
                     else axes)


def _rollaxis(a, axis, start=0):
    n = a.dim()
    axis, start = axis % n, start % (n + 1)
    if start > axis:
        start -= 1
    return torch.movedim(a, axis, start)


def _expand_dims(a, axis):
    a = _T(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = a.dim() + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    a = _T(a)
    if axis is None:
        return a.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if _b.any(a.shape[d] != 1 for d in axes):
        raise ValueError(
            "cannot select an axis to squeeze out which has size not equal "
            f"to one, got shape={tuple(a.shape)} and dimensions={axes}")
    return a.squeeze(axes)


def _many(f):
    """numpy's atleast_*: one array for one argument, else a list."""
    def g(*arys):
        out = [f(_T(a)) for a in arys]
        return out[0] if len(out) == 1 else out
    return g


def _promote(ts):
    ts = [_T(t) for t in ts]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _concatenate(arrays, axis=0, dtype=None):
    ts = _promote(arrays)
    if axis is None:
        ts, axis = [t.reshape(-1) for t in ts], 0
    out = torch.cat(ts, dim=axis)
    return out if dtype is None else out.to(dtype)


def _stack(arrays, axis=0, out=None, dtype=None):
    out = torch.stack(_promote(arrays), dim=axis)
    return out if dtype is None else out.to(dtype)


def _split(ary, indices_or_sections, axis=0):
    if isinstance(indices_or_sections, int) \
            and ary.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal division")
    return list(torch.tensor_split(ary, _sections(indices_or_sections),
                                   dim=axis))


def _sections(s):
    return s if isinstance(s, int) else [int(i) for i in s]


def _repeat(a, repeats, axis=None, total_repeat_length=None):
    a = _T(a)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(torch.int64)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _flip(m, axis=None):
    m = _T(m)
    return m.flip(_dims(m, axis))


def _roll(a, shift, axis=None):
    return torch.roll(a, shift, axis)


def _resize(a, new_shape):
    a = _T(a).reshape(-1)
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = math.prod(shape)
    reps = -(-n // _b.max(a.numel(), 1))
    return a.repeat(reps)[:n].reshape(shape)


def _append(arr, values, axis=None):
    arr, values = _promote([arr, _T(values, _T(arr))])
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=axis)


def _delete(arr, obj, axis=None):
    arr = _T(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    keep = _onp.ones(n, bool)
    keep[_onp.asarray(obj.cpu() if isinstance(obj, torch.Tensor)
                      else (_onp.arange(n)[obj] if isinstance(obj, slice)
                            else obj))] = False
    idx = torch.from_numpy(_onp.nonzero(keep)[0]).to(arr.device)
    return arr.index_select(axis, idx)


def _pad_index(n, before, after, mode):
    """Source positions of a padded axis under numpy's non-constant
    modes."""
    i = _onp.arange(-before, n + after)
    if mode == "edge":
        return _onp.clip(i, 0, n - 1)
    if mode == "wrap":
        return i % n
    if mode in ("reflect", "symmetric"):
        if mode == "reflect":
            period = 2 * (n - 1) if n > 1 else 1
            j = _onp.abs(i) % period
            return _onp.where(j >= n, period - j, j)
        j = _onp.where(i < 0, -i - 1, i) % (2 * n)
        return _onp.where(j >= n, 2 * n - 1 - j, j)
    raise ValueError(f"pad mode {mode!r} is not supported")


def _pad(array, pad_width, mode="constant", **kwargs):
    a = _T(array)
    pw = _onp.broadcast_to(_onp.asarray(pad_width, dtype=_onp.int64),
                           (a.dim(), 2))
    if mode == "constant":
        flat = [int(v) for pair in pw[::-1] for v in pair]
        return F.pad(a, flat, value=float(kwargs.get("constant_values", 0)))
    for d in range(a.dim()):
        idx = _pad_index(a.shape[d], int(pw[d][0]), int(pw[d][1]), mode)
        a = a.index_select(d, torch.from_numpy(idx).to(a.device))
    return a


def _take(a, indices, axis=None, out=None, mode=None, unique_indices=False,
          indices_are_sorted=False, fill_value=None):
    a = _T(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    idx = _T(indices, a).to(torch.int64)
    bad = None
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx % n
    else:
        # jnp.take's default, "fill": negative from the end, and a position
        # still outside the axis reads `fill_value`
        idx = torch.where(idx < 0, idx + n, idx)
        bad = (idx < 0) | (idx >= n)
        idx = idx.clamp(0, _b.max(n - 1, 0))
    out = a.index_select(axis, idx.reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if bad is None:
        return out
    bad = bad.reshape((1,) * axis + idx.shape
                      + (1,) * (a.dim() - axis - 1))
    fill = _nn.fill_value(a.dtype) if fill_value is None else fill_value
    return torch.where(bad, torch.tensor(fill, dtype=a.dtype,
                                         device=a.device), out)


def _take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    arr = _T(arr)
    idx = _T(indices, arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    if mode in (None, "fill"):
        # jnp.take_along_axis' default: XLA's fill mode
        return _nn.take_fill(arr, idx, axis, fill=fill_value)
    if mode != "clip":
        raise ValueError(f"Unknown gather mode {mode!r}")
    return torch.take_along_dim(arr, _nn.clamp_index(idx, arr.shape[axis]),
                                dim=axis)


def _choose(a, choices, out=None, mode="raise"):
    cs = torch.stack(torch.broadcast_tensors(*_promote(choices)))
    idx = _T(a, cs).to(torch.int64)
    idx = idx.expand(cs.shape[1:])
    return torch.gather(cs, 0, idx.unsqueeze(0))[0]


def _compress(condition, a, axis=None, out=None, size=None,
              fill_value=0):
    a = _T(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    c = _T(condition, a).reshape(-1).bool()
    return a.index_select(axis, torch.nonzero(c[:a.shape[axis]])[:, 0])


def _searchsorted(a, v, side="left", sorter=None, method=None):
    a = _T(a)
    return torch.searchsorted(a, _T(v, a).to(a.dtype), right=side == "right")


def _sortlike(f, a, axis):
    a = _T(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return f(a, axis)


def _partition_idx(a, kth, axis):
    """The JAX package's order: the kth + 1 smallest ascending, then the
    rest largest first."""
    xm = torch.movedim(a, axis, -1)
    n = xm.shape[-1]
    bot = torch.topk(-xm if not xm.dtype == torch.bool else ~xm, kth + 1,
                     dim=-1).indices
    top = torch.topk(xm, n - kth - 1, dim=-1).indices
    return torch.movedim(torch.cat([bot, top], -1), -1, axis)


def _nonzero(a, size=None, fill_value=None):
    return tuple(torch.nonzero(_T(a), as_tuple=True))


def _where(condition, x=None, y=None, size=None, fill_value=None):
    c = _T(condition)
    if x is None and y is None:
        return _nonzero(c)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = _T(x, c)
    return torch.where(c.bool(), x, y)


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    strides = _onp.cumprod((1,) + tuple(dims[::-1]))[::-1][1:]
    out = 0
    for i, s in zip(multi_index, strides):
        out = out + _T(i).to(torch.int64) * int(s)
    return out


def _tri_indices(f):
    def g(n, k=0, m=None):
        r = f(n, n if m is None else m, k)
        return r[0], r[1]
    return g


def _indices(dimensions, dtype=None, sparse=False):
    dt = dtype or torch.int32
    grids = torch.meshgrid(*[torch.arange(d, dtype=dt) for d in dimensions],
                           indexing="ij")
    return torch.stack(grids) if grids else torch.zeros((0,), dtype=dt)


def _ix(*args):
    n = len(args)
    return tuple(_T(a).reshape([-1 if i == j else 1 for j in range(n)])
                 for i, a in enumerate(args))


def _select(condlist, choicelist, default=0):
    ch = _promote(choicelist)
    out = torch.full_like(ch[0], default) if not isinstance(
        default, torch.Tensor) else default.to(ch[0].dtype).expand(
        ch[0].shape)
    for c, v in zip(reversed(condlist), reversed(ch)):
        out = torch.where(_T(c, v).bool(), v, out)
    return out


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, equal_nan=True, size=None,
            fill_value=None, sorted=True):
    a = _T(ar)
    if axis is None:
        a = a.reshape(-1)
    u, inv, cnt = torch.unique(a, sorted=True, return_inverse=True,
                               return_counts=True, dim=axis)
    out = [u]
    if return_index:
        pos = torch.arange(inv.numel(), device=a.device)
        first = torch.full((u.shape[0 if axis is None else axis],),
                           inv.numel(), device=a.device,
                           dtype=torch.int64)
        out.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


def _uniq1(a):
    return torch.unique(_T(a).reshape(-1), sorted=True)


def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    u = _uniq1(ar1)
    return u[torch.isin(u, _T(ar2, u))]


def _setdiff1d(ar1, ar2, assume_unique=False, size=None, fill_value=None):
    u = _uniq1(ar1)
    return u[~torch.isin(u, _T(ar2, u))]


def _setxor1d(ar1, ar2, assume_unique=False, size=None, fill_value=None):
    a, b = _uniq1(ar1), _uniq1(ar2)
    return torch.unique(torch.cat([a[~torch.isin(a, b)],
                                   b[~torch.isin(b, a)]]), sorted=True)


def _eye(N, M=None, k=0, dtype=None, device=None):
    M = N if M is None else M
    r = torch.arange(N).unsqueeze(1) + k == torch.arange(M).unsqueeze(0)
    return r.to(dtype or torch.float32)


def _linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
              axis=0, device=None):
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else math.nan
    i = torch.arange(num, dtype=torch.float64)
    out = start + i * step if div > 0 else torch.full(
        (num,), float(start), dtype=torch.float64)
    if endpoint and num > 1:
        out[-1] = stop
    out = out.to(dtype or torch.float32)
    return (out, step) if retstep else out


def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              axis=0):
    return torch.pow(float(base), _linspace(start, stop, num, endpoint,
                                            dtype=torch.float64)).to(
        dtype or torch.float32)


def _geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0):
    out = torch.exp(_linspace(math.log(start), math.log(stop), num,
                              endpoint, dtype=torch.float64))
    out[0] = start
    if endpoint and num > 1:
        out[-1] = stop
    return out.to(dtype or torch.float32)


def _tri(N, M=None, k=0, dtype=None):
    return torch.ones(N, N if M is None else M).tril(k).to(
        dtype or torch.float32)


def _ediff1d(ary, to_end=None, to_begin=None):
    a = _T(ary).reshape(-1)
    if a.dtype == torch.bool:
        raise TypeError("ediff1d subtracts neighbours, which a bool array "
                        "has no operator for")
    parts = [torch.diff(a)]
    if to_begin is not None:
        parts.insert(0, _T(to_begin, a).reshape(-1).to(a.dtype))
    if to_end is not None:
        parts.append(_T(to_end, a).reshape(-1).to(a.dtype))
    return torch.cat(parts)


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _fl(f)
    dims = _dims(f, axis)
    sp = [float(v) if not isinstance(v, torch.Tensor) else v
          for v in varargs] or 1.0
    out = torch.gradient(f, spacing=sp, dim=list(dims),
                         edge_order=edge_order)
    return out[0] if len(out) == 1 else list(out)


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _fl(y)
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, _T(x, y).to(y.dtype), dim=axis)


def _correlate_full(a, v):
    a, v = _promote([_fl(a), _fl(v)])
    n = v.numel()
    return F.conv1d(a.reshape(1, 1, -1), v.reshape(1, 1, -1),
                    padding=n - 1).reshape(-1)


def _mode_cut(full_, m, n, mode):
    if mode == "full":
        return full_
    if mode == "same":
        start = (_b.min(m, n) - 1) // 2
        return full_[start:start + _b.max(m, n)]
    return full_[_b.min(m, n) - 1:_b.max(m, n)]


def _correlate(a, v, mode="valid", precision=None,
               preferred_element_type=None):
    return _mode_cut(_correlate_full(a, v), a.numel(), v.numel(), mode)


def _convolve(a, v, mode="full", precision=None,
              preferred_element_type=None):
    if v.numel() > a.numel():
        a, v = v, a
    return _mode_cut(_correlate_full(a, v.flip(0)), a.numel(), v.numel(),
                     mode)


def _window(f):
    def g(M, *args):
        if M <= 1:
            return torch.ones(_b.max(M, 0))
        return f(M, *args)
    return g


def _interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _fl(x), _fl(xp), _fl(fp)
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    out = y0 + (x - x0) * (y1 - y0) / (x1 - x0)
    out = torch.where(x < xp[0], fp[0] if left is None else left, out)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, out)


def _spacing(x):
    x = _fl(x)
    return torch.nextafter(x, torch.where(x < 0, -math.inf, math.inf)
                           .to(x.dtype)) - x


class _Abs(torch.autograd.Function):
    """|x| with jax.grad's derivative at 0: sign(x) there would give 0, the
    JAX package's abs gives 1 (so sqrt(abs(x)) reads inf, not nan)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    x = _T(x)
    if x.requires_grad and torch.is_grad_enabled() \
            and x.is_floating_point():
        return _Abs.apply(x)
    return torch.abs(x)


def _fabs(x):
    return _abs(_fl(x))


def _cbrt(x):
    x = _fl(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _polyval(p, x):
    p, x = _T(p), _T(x, _T(p))
    out = torch.zeros_like(x * p[0]) if p.numel() else torch.zeros_like(x)
    for i in range(p.numel()):
        out = out * x + p[i]
    return out


def _polyadd(a1, a2):
    a1, a2 = _promote([a1, a2])
    n = _b.max(a1.numel(), a2.numel())
    return F.pad(a1, (n - a1.numel(), 0)) + F.pad(a2, (n - a2.numel(), 0))


def _polysub(a1, a2):
    return _polyadd(a1, -_T(a2))


def _polymul(a1, a2):
    return _convolve(_T(a1), _T(a2))


def _polyder(p, m=1):
    p = _T(p)
    for _ in range(m):
        n = p.numel() - 1
        p = p[:-1] * torch.arange(n, 0, -1, device=p.device).to(p.dtype)
    return p


def _polyint(p, m=1, k=None):
    p = _fl(p)
    ks = [0.0] * m if k is None else (list(k) if isinstance(
        k, (list, tuple)) else [k] * m)
    for j in range(m):
        n = p.numel()
        p = torch.cat([p / torch.arange(n, 0, -1, device=p.device).to(
            p.dtype), torch.tensor([ks[j]], dtype=p.dtype, device=p.device)])
    return p


def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    x, y = _fl(x).double(), _fl(y).double()
    A = torch.vander(x, deg + 1)
    return torch.linalg.lstsq(A, y.reshape(-1, 1)).solution.reshape(-1)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _promote([a, _T(b, _T(a))])
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _array_equal(a1, a2, equal_nan=False):
    a1, a2 = _T(a1), _T(a2, _T(a1))
    if a1.shape != a2.shape:
        return torch.tensor(False)
    eq = a1 == a2
    if equal_nan:
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return eq.all()


def _array_equiv(a1, a2):
    a1, a2 = _T(a1), _T(a2, _T(a1))
    try:
        torch.broadcast_shapes(a1.shape, a2.shape)
    except RuntimeError:
        return torch.tensor(False)
    return (a1 == a2).all()


def _like(f):
    def g(a, *args, dtype=None, shape=None, device=None):
        a = _T(a)
        if shape is not None:
            a = torch.empty(shape, dtype=a.dtype, device=a.device)
        out = f(a, *args)
        return out if dtype is None else out.to(dtype)
    return g


def _asarray(a, dtype=None, order=None, copy=None):
    a = _T(a)
    return a if dtype is None else a.to(dtype)


def _size(a, axis=None):
    a = _T(a)
    return a.numel() if axis is None else a.shape[axis]


def _int0(v, like):
    """A 0-d int32 array (the JAX package's metadata answers are arrays)."""
    return torch.tensor(v, dtype=torch.int32, device=getattr(
        like, "device", None))


def _bool0(v, like):
    return torch.tensor(bool(v), device=getattr(like, "device", None))


def _histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    """Counts over a bins_x x bins_y grid (int32, as the JAX package's),
    with the edges of each axis."""
    x, y = _fl(x).reshape(-1), _fl(y).reshape(-1)
    bx, by = (bins, bins) if isinstance(bins, int) else bins
    rx, ry = (None, None) if range is None else range
    ex, ey = _histogram_edges(x, bx, rx), _histogram_edges(y, by, ry)
    nx, ny = ex.numel() - 1, ey.numel() - 1
    ix = torch.where(x == ex[-1], nx - 1,
                     torch.bucketize(x, ex, right=True) - 1)
    iy = torch.where(y == ey[-1], ny - 1,
                     torch.bucketize(y, ey, right=True) - 1)
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    w = None if weights is None else _T(weights, x).reshape(-1)[ok].float()
    h = torch.bincount(ix[ok] * ny + iy[ok], weights=w,
                       minlength=nx * ny).reshape(nx, ny)
    if density:
        area = torch.diff(ex).unsqueeze(1) * torch.diff(ey).unsqueeze(0)
        h = h / (h.sum() * area)
    return h, ex, ey


def _heaviside(x1, x2):
    x1, x2 = _promote([_fl(x1), _T(x2, _T(x1))])
    return torch.heaviside(x1, x2)


def _ceil_like(f):
    def g(x):
        x = _T(x)
        return f(x) if x.is_floating_point() else x
    return g


def _round(a, decimals=0, out=None):
    a = _T(a)
    return torch.round(a, decimals=decimals) if a.is_floating_point() else a


class _Clip(torch.autograd.Function):
    """clamp(x, lo, hi) with jax.grad's derivative: jnp.clip is
    minimum(maximum(x, lo), hi), whose ties split the gradient, so an
    element at a bound takes half (a quarter where lo == hi == x)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        scale = torch.ones_like(x)
        if lo is not None:
            scale = torch.where(x > lo, scale, torch.where(x == lo, 0.5, 0.0))
            x = torch.clamp(x, lo, None)
        if hi is not None:
            scale = scale * torch.where(x < hi, 1.0,
                                        torch.where(x == hi, 0.5, 0.0))
        return g * scale.to(g.dtype), None, None


def _clip(arr=None, min=None, max=None, a_min=None, a_max=None):
    lo = a_min if min is None else min
    hi = a_max if max is None else max
    if not (arr.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(arr, lo, hi)
    if _b.any(isinstance(b, torch.Tensor) and b.requires_grad
              for b in (lo, hi)):
        # bounds that take a gradient: torch's maximum/minimum split ties
        # as jax.grad does
        out = arr if lo is None else torch.maximum(arr, _T(lo, arr))
        return out if hi is None else torch.minimum(out, _T(hi, arr))
    return _Clip.apply(arr, lo, hi)


def _ufunc2(f):
    """A binary numpy function over `f`, which wants tensors: Python scalars
    become 0-d tensors (which, as JAX's weak types, do not widen an array
    of their kind)."""
    def g(x1, x2, *args, **kwargs):
        if not isinstance(x1, torch.Tensor):
            x1 = _T(x1, x2)
        if not isinstance(x2, torch.Tensor):
            x2 = _T(x2, x1)
        return f(x1, x2, *args, **kwargs)
    return g


def _power(x1, x2):
    if isinstance(x1, torch.Tensor) and isinstance(x2, (int, float)):
        return _pow(x1, x2)
    return _ufunc2(torch.pow)(x1, x2)


def _ufunc2_float(f):
    return _ufunc2(lambda a, b: f(*_promote([_fl(a), _fl(b)])))


def _float1(f):
    return lambda x: f(_fl(x))


def _reciprocal(x):
    x = _T(x)
    return torch.reciprocal(x) if x.is_floating_point() else \
        torch.where(x == 0, 0, (1 // torch.where(x == 0, 1, x))).to(x.dtype)


def _imag(x):
    x = _T(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _frexp(x):
    return tuple(torch.frexp(_fl(x)))


def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(_T(x), nan=nan, posinf=posinf, neginf=neginf)


def _flatnonzero(a):
    return torch.nonzero(_T(a).reshape(-1))[:, 0]


def _bincount(x, weights=None, minlength=0, length=None):
    w = None if weights is None else _T(weights, x).float()
    out = torch.bincount(_T(x).to(torch.int64).reshape(-1), weights=w,
                         minlength=minlength if length is None else length)
    return out if length is None else out[:length]


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None):
    m = _fl(m)
    if m.dim() == 1:
        m = m.unsqueeze(0)
    if not rowvar:
        m = m.T
    if y is not None:
        yy = _fl(y)
        yy = yy.unsqueeze(0) if yy.dim() == 1 else yy
        m = torch.cat([m, yy if rowvar else yy.T])
    c = (0 if bias else 1) if ddof is None else ddof
    return torch.cov(m, correction=c, fweights=fweights, aweights=aweights)


def _corrcoef(x, y=None, rowvar=True):
    c = _cov(x, y, rowvar)
    d = torch.sqrt(torch.diagonal(c))
    return (c / d.unsqueeze(1) / d.unsqueeze(0)).clamp(-1, 1) \
        if c.dim() else c / c


def _digitize(x, bins, right=False, method=None):
    x = _T(x)
    return torch.bucketize(x, _T(bins, x).to(x.dtype), right=not right)


def _put_along_axis_fn(arr, indices, values, axis, inplace=False, mode=None):
    axis %= arr.dim()
    idx = _T(indices, arr).to(torch.int64)
    n = arr.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    # an update whose index is still outside the axis is dropped, as XLA's
    # scatters drop it: it lands in a spare row past the end
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    vals = _T(values, arr).to(arr.dtype).expand(idx.shape)
    spare = list(arr.shape)
    spare[axis] = 1
    ext = torch.cat([arr, arr.new_zeros(spare)], dim=axis)
    return ext.scatter(axis, idx, vals).narrow(axis, 0, n)


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _T(a)
    pre = None if prepend is None else _T(prepend, a).to(a.dtype)
    app = None if append is None else _T(append, a).to(a.dtype)
    if pre is not None and pre.dim() == 0:
        shape = list(a.shape)
        shape[axis] = 1
        pre = pre.expand(shape)
    if app is not None and app.dim() == 0:
        shape = list(a.shape)
        shape[axis] = 1
        app = app.expand(shape)
    return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _promote([a, b])
    return torch.linalg.cross(a, b, dim=-1 if axis is None else axis)


def _result_type(*args):
    dt = None
    for a in args:
        if isinstance(a, torch.Tensor):
            d = a.dtype
        elif isinstance(a, (bool, int, float, complex)):
            if dt is None:
                d = torch.tensor(a).dtype
            else:
                d = torch.result_type(torch.zeros((), dtype=dt), a)
        else:
            d = to_torch_dtype(a)
        dt = d if dt is None else torch.promote_types(dt, d)
    return from_torch_dtype(NARROW.get(dt, dt))


def _promote_types(type1, type2):
    return from_torch_dtype(torch.promote_types(to_torch_dtype(type1),
                                                to_torch_dtype(type2)))


def _can_cast(from_, to, casting="safe"):
    f = from_torch_dtype(from_.dtype) if isinstance(from_, torch.Tensor) \
        else name_to_dtype(from_)
    t = name_to_dtype(to)
    if BFLOAT16 in (f, t):
        return f == t or (f != BFLOAT16 and casting == "unsafe")
    return bool(_onp.can_cast(f, t, casting))


# ---------------------------------------------------------------------------
# the table: numpy name -> function over tensors with numpy's signature
# ---------------------------------------------------------------------------
def _u(f):
    return lambda x: f(_T(x))


_TABLE = {
    # elementwise arithmetic
    "add": _ufunc2(torch.add), "subtract": _ufunc2(torch.subtract),
    "multiply": _ufunc2(torch.multiply), "divide": _ufunc2(torch.true_divide),
    "true_divide": _ufunc2(torch.true_divide),
    "floor_divide": _ufunc2(lambda a, b: _int_by_zero(torch.floor_divide,
                                                      a, b)),
    "mod": _ufunc2(lambda a, b: _int_by_zero(torch.remainder, a, b)),
    "remainder": _ufunc2(lambda a, b: _int_by_zero(torch.remainder, a, b)),
    "fmod": _ufunc2(lambda a, b: _int_by_zero(torch.fmod, a, b)),
    "power": _power,
    "float_power": _ufunc2(lambda a, b: torch.float_power(a, b)),
    "negative": _u(torch.neg), "positive": _u(torch.positive),
    "absolute": _abs, "abs": _abs, "fabs": _fabs,
    "sign": _u(torch.sign), "rint": _u(torch.round),
    "reciprocal": _reciprocal, "square": _u(torch.square),
    "sqrt": _float1(torch.sqrt), "cbrt": _cbrt, "exp": _float1(torch.exp),
    "exp2": _float1(torch.exp2), "expm1": _float1(torch.expm1),
    "log": _float1(torch.log), "log2": _float1(torch.log2),
    "log10": _float1(torch.log10), "log1p": _float1(torch.log1p),
    "logaddexp": _ufunc2_float(torch.logaddexp),
    "logaddexp2": _ufunc2_float(torch.logaddexp2),
    "sin": _float1(torch.sin), "cos": _float1(torch.cos),
    "tan": _float1(torch.tan), "arcsin": _float1(torch.asin),
    "arccos": _float1(torch.acos), "arctan": _float1(torch.atan),
    "arctan2": _ufunc2_float(torch.atan2), "sinh": _float1(torch.sinh),
    "cosh": _float1(torch.cosh), "tanh": _float1(torch.tanh),
    "arcsinh": _float1(torch.asinh), "arccosh": _float1(torch.acosh),
    "arctanh": _float1(torch.atanh), "hypot": _ufunc2_float(torch.hypot),
    "deg2rad": _float1(torch.deg2rad), "rad2deg": _float1(torch.rad2deg),
    "degrees": _float1(torch.rad2deg), "radians": _float1(torch.deg2rad),
    "ceil": _ceil_like(torch.ceil), "floor": _ceil_like(torch.floor),
    "trunc": _ceil_like(torch.trunc), "round": _round, "around": _round,
    "clip": _clip, "maximum": _ufunc2(torch.maximum),
    "minimum": _ufunc2(torch.minimum), "fmax": _ufunc2(torch.fmax),
    "fmin": _ufunc2(torch.fmin), "heaviside": _heaviside,
    "nan_to_num": _nan_to_num, "real": _u(torch.real), "imag": _imag,
    "conj": _u(torch.conj), "conjugate": _u(torch.conj),
    "angle": _float1(torch.angle),
    "ldexp": _ufunc2(lambda a, b: torch.ldexp(_fl(a), b)),
    "frexp": _frexp, "copysign": _ufunc2_float(torch.copysign),
    "nextafter": _ufunc2_float(torch.nextafter), "spacing": _spacing,
    "gcd": _ufunc2(torch.gcd), "lcm": _ufunc2(torch.lcm),
    "bitwise_and": _ufunc2(torch.bitwise_and),
    "bitwise_or": _ufunc2(torch.bitwise_or),
    "bitwise_xor": _ufunc2(torch.bitwise_xor),
    "bitwise_not": _u(torch.bitwise_not), "invert": _u(torch.bitwise_not),
    "left_shift": _ufunc2(torch.bitwise_left_shift),
    "right_shift": _ufunc2(torch.bitwise_right_shift),
    "sinc": _float1(torch.sinc), "i0": _float1(torch.i0), "interp": _interp,
    # logic and comparison
    "equal": _ufunc2(torch.eq), "not_equal": _ufunc2(torch.ne),
    "less": _ufunc2(torch.lt), "less_equal": _ufunc2(torch.le),
    "greater": _ufunc2(torch.gt), "greater_equal": _ufunc2(torch.ge),
    "logical_and": _ufunc2(torch.logical_and),
    "logical_or": _ufunc2(torch.logical_or),
    "logical_xor": _ufunc2(torch.logical_xor),
    "logical_not": _u(torch.logical_not), "isfinite": _u(torch.isfinite),
    "isinf": _u(torch.isinf), "isnan": _u(torch.isnan),
    "isneginf": _u(torch.isneginf), "isposinf": _u(torch.isposinf),
    "isclose": _isclose,
    "allclose": lambda a, b, rtol=1e-05, atol=1e-08, equal_nan=False:
        _isclose(a, b, rtol, atol, equal_nan).all(),
    "array_equal": _array_equal, "array_equiv": _array_equiv,
    "signbit": _u(torch.signbit),
    # reductions and statistics
    "sum": _sum, "prod": _prod, "mean": _mean, "std": _std, "var": _var,
    "min": _amin, "max": _amax, "amin": _amin, "amax": _amax,
    "ptp": lambda a, axis=None, out=None, keepdims=False:
        _amax(a, axis, keepdims=keepdims) - _amin(a, axis, keepdims=keepdims),
    "nansum": lambda a, axis=None, dtype=None, out=None, keepdims=False:
        torch.nansum(_fl(a) if not _T(a).is_floating_point() else a,
                     dim=_dims(_T(a), axis), keepdim=keepdims, dtype=dtype)
        if _T(a).is_floating_point() else _sum(a, axis, dtype,
                                               keepdims=keepdims),
    "nanprod": lambda a, axis=None, dtype=None, out=None, keepdims=False:
        _prod(_nanfill(a, 1.0) if a.is_floating_point() else a, axis, dtype,
              keepdims=keepdims),
    "nanmean": lambda a, axis=None, dtype=None, out=None, keepdims=False:
        torch.nanmean(_fl(a), dim=_dims(a, axis), keepdim=keepdims),
    "nanstd": lambda a, axis=None, dtype=None, out=None, ddof=0,
        keepdims=False: _nanvar(a, axis, ddof=ddof, keepdims=keepdims).sqrt(),
    "nanvar": _nanvar, "nanmin": _nanmin, "nanmax": _nanmax,
    "argmin": lambda a, axis=None, out=None, keepdims=False:
        _argext(torch.argmin, a, axis, keepdims),
    "argmax": lambda a, axis=None, out=None, keepdims=False:
        _argext(torch.argmax, a, axis, keepdims),
    "nanargmin": lambda a, axis=None, out=None, keepdims=False:
        _argext(torch.argmin, _nanfill(_fl(a), math.inf), axis, keepdims),
    "nanargmax": lambda a, axis=None, out=None, keepdims=False:
        _argext(torch.argmax, _nanfill(_fl(a), -math.inf), axis, keepdims),
    "median": lambda a, axis=None, out=None, overwrite_input=False,
        keepdims=False: _quantile(a, 0.5, axis, keepdims=keepdims),
    "nanmedian": lambda a, axis=None, out=None, overwrite_input=False,
        keepdims=False: _quantile(a, 0.5, axis, keepdims=keepdims, nan=True),
    "percentile": lambda a, q, axis=None, out=None, overwrite_input=False,
        method="linear", keepdims=False: _quantile(
            a, _T(q, a) / 100.0 if isinstance(q, torch.Tensor) else q / 100.0,
            axis, method=method, keepdims=keepdims),
    "nanpercentile": lambda a, q, axis=None, out=None, overwrite_input=False,
        method="linear", keepdims=False: _quantile(
            a, _T(q, a) / 100.0 if isinstance(q, torch.Tensor) else q / 100.0,
            axis, method=method, keepdims=keepdims, nan=True),
    "quantile": _quantile,
    "nanquantile": lambda a, q, axis=None, out=None, overwrite_input=False,
        method="linear", keepdims=False: _quantile(
            a, q, axis, method=method, keepdims=keepdims, nan=True),
    "average": _average,
    "cumsum": lambda a, axis=None, dtype=None, out=None:
        _cum(torch.cumsum, a, axis, dtype),
    "cumprod": lambda a, axis=None, dtype=None, out=None:
        _cum(torch.cumprod, a, axis, dtype),
    "nancumsum": lambda a, axis=None, dtype=None, out=None:
        _cum(torch.cumsum, _nanfill(a, 0.0) if a.is_floating_point() else a,
             axis, dtype),
    "nancumprod": lambda a, axis=None, dtype=None, out=None:
        _cum(torch.cumprod, _nanfill(a, 1.0) if a.is_floating_point() else a,
             axis, dtype),
    "all": lambda a, axis=None, out=None, keepdims=False, where=None:
        torch.all(_T(a).bool(), dim=_dims(_T(a), axis), keepdim=keepdims),
    "any": lambda a, axis=None, out=None, keepdims=False, where=None:
        torch.any(_T(a).bool(), dim=_dims(_T(a), axis), keepdim=keepdims),
    "count_nonzero": _count_nonzero, "bincount": _bincount,
    "histogram": _histogram, "histogram2d": _histogram2d, "corrcoef": _corrcoef, "cov": _cov,
    "digitize": _digitize,
    # linear algebra (flat namespace)
    "dot": _dot,
    "vdot": _ufunc2(lambda a, b: torch.matmul(*_promote(
        [a.reshape(-1), b.reshape(-1)]))),
    "inner": _ufunc2(lambda a, b: torch.inner(*_promote([a, b]))),
    "outer": _ufunc2(lambda a, b: torch.outer(*_promote(
        [a.reshape(-1), b.reshape(-1)]))),
    "matmul": lambda a, b, precision=None, preferred_element_type=None:
        torch.matmul(*_promote([a, b])),
    "tensordot": _tensordot,
    "einsum": lambda subscripts, *operands, out=None, optimize="auto",
        precision=None, preferred_element_type=None:
        torch.einsum(subscripts, *_promote(operands)),
    "kron": _ufunc2(lambda a, b: torch.kron(*_promote([a, b]))),
    "cross": _cross, "trace": _trace,
    "diagonal": lambda a, offset=0, axis1=0, axis2=1:
        torch.diagonal(a, offset, axis1, axis2),
    # shape manipulation
    "reshape": _reshape,
    "ravel": lambda a, order="C": _T(a).reshape(-1),
    "transpose": _transpose,
    "swapaxes": lambda a, axis1, axis2: torch.swapaxes(a, axis1, axis2),
    "moveaxis": lambda a, source, destination:
        torch.movedim(a, source, destination),
    "rollaxis": _rollaxis, "expand_dims": _expand_dims, "squeeze": _squeeze,
    "broadcast_to": lambda array, shape:
        _T(array).expand((shape,) if isinstance(shape, int)
                         else tuple(shape)).clone(),
    "broadcast_arrays": lambda *args:
        [t.clone() for t in torch.broadcast_tensors(*[_T(a) for a in args])],
    "atleast_1d": _many(torch.atleast_1d),
    "atleast_2d": _many(torch.atleast_2d),
    "atleast_3d": _many(torch.atleast_3d),
    "concatenate": _concatenate, "stack": _stack,
    "vstack": lambda tup, dtype=None: torch.vstack(_promote(tup)),
    "hstack": lambda tup, dtype=None: torch.hstack(_promote(tup)),
    "dstack": lambda tup, dtype=None: torch.dstack(_promote(tup)),
    "column_stack": lambda tup: torch.column_stack(_promote(tup)),
    "row_stack": lambda tup, dtype=None: torch.vstack(_promote(tup)),
    "split": _split,
    "array_split": lambda ary, indices_or_sections, axis=0: list(
        torch.tensor_split(ary, _sections(indices_or_sections), dim=axis)),
    "hsplit": lambda ary, indices_or_sections: list(
        torch.hsplit(ary, _sections(indices_or_sections))),
    "vsplit": lambda ary, indices_or_sections: list(
        torch.vsplit(ary, _sections(indices_or_sections))),
    "dsplit": lambda ary, indices_or_sections: list(
        torch.dsplit(ary, _sections(indices_or_sections))),
    "tile": lambda A, reps: torch.tile(
        _T(A), (reps,) if isinstance(reps, int) else tuple(reps)),
    "repeat": _repeat, "flip": _flip,
    "fliplr": lambda m: torch.fliplr(m), "flipud": lambda m: torch.flipud(m),
    "roll": _roll,
    "rot90": lambda m, k=1, axes=(0, 1): torch.rot90(m, k, list(axes)),
    "resize": _resize, "append": _append, "delete": _delete, "pad": _pad,
    "flatnonzero": _flatnonzero,
    # indexing, searching, sorting
    "take": _take, "take_along_axis": _take_along_axis, "choose": _choose,
    "compress": _compress,
    "extract": lambda condition, arr, size=None, fill_value=0:
        _T(arr).reshape(-1)[_T(condition, _T(arr)).reshape(-1).bool()],
    "searchsorted": _searchsorted,
    "argsort": lambda a, axis=-1, kind=None, order=None, stable=True,
        descending=False: _sortlike(lambda t, d: torch.argsort(
            t, dim=d, stable=True, descending=descending), a, axis),
    "sort": lambda a, axis=-1, kind=None, order=None, stable=True,
        descending=False: _sortlike(lambda t, d: torch.sort(
            t, dim=d, stable=True, descending=descending).values, a, axis),
    "partition": lambda a, kth, axis=-1: torch.take_along_dim(
        a, _partition_idx(a, kth, axis), dim=axis),
    "argpartition": lambda a, kth, axis=-1: _partition_idx(a, kth, axis),
    "nonzero": _nonzero,
    "argwhere": lambda a, size=None, fill_value=None: torch.argwhere(_T(a)),
    "where": _where,
    "unravel_index": lambda indices, shape: torch.unravel_index(
        _T(indices).to(torch.int64), tuple(shape)),
    "ravel_multi_index": _ravel_multi_index,
    "diag": lambda v, k=0: torch.diag(v, k),
    "diagflat": lambda v, k=0: torch.diagflat(v, k),
    "tril": lambda m, k=0: torch.tril(m, k),
    "triu": lambda m, k=0: torch.triu(m, k),
    "tril_indices": _tri_indices(torch.tril_indices),
    "triu_indices": _tri_indices(torch.triu_indices),
    "indices": _indices, "ix_": _ix, "select": _select,
    # sets
    "unique": _unique,
    "union1d": lambda ar1, ar2, size=None, fill_value=None:
        torch.unique(torch.cat(_promote([_T(ar1).reshape(-1),
                                         _T(ar2).reshape(-1)])), sorted=True),
    "intersect1d": _intersect1d, "setdiff1d": _setdiff1d,
    "setxor1d": _setxor1d,
    "in1d": lambda ar1, ar2, assume_unique=False, invert=False:
        torch.isin(_T(ar1).reshape(-1), _T(ar2, _T(ar1)), invert=invert),
    "isin": lambda element, test_elements, assume_unique=False,
        invert=False: torch.isin(_T(element), _T(test_elements, _T(element)),
                                 invert=invert),
    # creation
    "eye": _eye,
    "identity": lambda n, dtype=None: _eye(n, dtype=dtype),
    "linspace": _linspace, "logspace": _logspace, "geomspace": _geomspace,
    "meshgrid": lambda *xi, copy=True, sparse=False, indexing="xy": list(
        t.clone() for t in torch.meshgrid(*[_T(x) for x in xi],
                                          indexing=indexing)),
    "tri": _tri,
    "vander": lambda x, N=None, increasing=False:
        torch.vander(x, N, increasing),
    "diff": _diff, "ediff1d": _ediff1d, "gradient": _gradient,
    "trapezoid": _trapezoid, "convolve": _convolve,
    "correlate": _correlate,
    # windows
    "hanning": _window(lambda M: torch.hann_window(M, periodic=False)),
    "hamming": _window(lambda M: torch.hamming_window(M, periodic=False)),
    "blackman": _window(lambda M: torch.blackman_window(M, periodic=False)),
    "bartlett": _window(lambda M: torch.bartlett_window(M, periodic=False)),
    "kaiser": _window(lambda M, beta: torch.kaiser_window(
        M, periodic=False, beta=float(beta))),
    # misc
    "zeros_like": _like(torch.zeros_like), "ones_like": _like(torch.ones_like),
    "full_like": lambda a, fill_value, dtype=None, shape=None: torch.full(
        tuple(a.shape) if shape is None else shape, fill_value,
        dtype=dtype or a.dtype, device=a.device),
    "empty_like": _like(torch.zeros_like),
    "copy": lambda a, order=None: _T(a).clone(), "asarray": _asarray,
    "ascontiguousarray": lambda a, dtype=None: _asarray(a, dtype).contiguous(),
    "shape": lambda a: tuple(_int0(s, a) for s in _T(a).shape),
    "size": lambda a, axis=None: _int0(_size(a, axis), a),
    "ndim": lambda a: _int0(_T(a).dim(), a),
    "iscomplexobj": lambda x: _bool0(_T(x).is_complex(), x),
    "isrealobj": lambda x: _bool0(not _T(x).is_complex(), x),
    "isscalar": lambda element: _bool0(
        isinstance(element, (int, float, complex, bool, _onp.generic))
        or (isinstance(element, torch.Tensor) and element.dim() == 0),
        element),
    "polyval": _polyval, "polyadd": _polyadd, "polysub": _polysub,
    "polymul": _polymul, "polyder": _polyder, "polyint": _polyint,
    "polyfit": _polyfit,
}

# dtype queries answer with dtypes and bools: they take no dispatch
_META = {"result_type": _result_type, "promote_types": _promote_types,
         "can_cast": _can_cast}

# the JAX package's names torch has no function for: host numpy
_FALLBACK = ("insert", "piecewise", "fromfunction",
             "apply_along_axis", "apply_over_axes")
_FALLBACK_CALLS = {}


def fallback_names():
    """The names that run on host numpy (torch has no function for
    them)."""
    return sorted(_FALLBACK)


def fallback_calls(reset=False):
    """{name: calls} of the host-numpy names since the last reset."""
    snap = dict(_FALLBACK_CALLS)
    if reset:
        _FALLBACK_CALLS.clear()
    return snap


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def _split_leaves(obj, leaves):
    """`obj` with each NDArray (in nested lists, tuples and dicts) replaced
    by its position in `leaves`."""
    if type(obj) is NDArray:
        leaves.append(obj)
        return _Leaf(len(leaves) - 1)
    if type(obj) in (list, tuple):
        return type(obj)(_split_leaves(v, leaves) for v in obj)
    if type(obj) is dict:
        return {k: _split_leaves(v, leaves) for k, v in obj.items()}
    return obj


class _Leaf(int):
    pass


def _fill(obj, raws, dev):
    if type(obj) is _Leaf:
        return raws[obj]
    if type(obj) in (list, tuple):
        return type(obj)(_fill(v, raws, dev) for v in obj)
    if type(obj) is dict:
        return {k: _fill(v, raws, dev) for k, v in obj.items()}
    if isinstance(obj, _onp.ndarray):
        return as_tensor(obj, dev)
    return obj


def _narrow_out(out):
    if isinstance(out, torch.Tensor):
        d = NARROW.get(out.dtype)
        return out if d is None else out.to(d)
    if type(out) in (list, tuple):
        return type(out)(_narrow_out(o) for o in out)
    return out


def _place(out, dev):
    if isinstance(out, torch.Tensor):
        return out.to(dev)
    if type(out) in (list, tuple):
        return type(out)(_place(o, dev) for o in out)
    return out


def _make_wrapper(name, impl):
    """The mx.np function `name`: NDArrays anywhere in the arguments become
    the dispatch's inputs (cast by `name` under AMP, taped under
    `record()`), numpy arrays become tensors on their device, `dtype`
    names become torch dtypes, and a result with no array input lands on
    `device` (default: the current device)."""
    def fn(*args, **kwargs):
        device = kwargs.pop("device", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("out", None)
        dt = kwargs.get("dtype")
        if dt is not None:
            kwargs["dtype"] = to_torch_dtype(dt)
        leaves = []
        skel = _split_leaves((args, kwargs), leaves)
        dev = leaves[0]._t.device if leaves else None

        def call(*raws):
            a, kw = _fill(skel, raws, dev if dev is not None else "cpu")
            return _narrow_out(impl(*a, **kw))

        if not leaves:
            out = invoke(call, (), name=name, wrap=False)
            return _wrap_all(_place(out, resolve_device(device or ctx)))
        out = invoke(call, leaves, name=name)
        if (device or ctx) is not None:
            out = _to_device(out, device or ctx)
        return out

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"mx.np.{name} on torch tensors (numpy's signature)."
    return fn


def _wrap_all(out):
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if type(out) in (list, tuple):
        return type(out)(_wrap_all(o) for o in out)
    return out


def _to_device(out, device):
    if isinstance(out, NDArray):
        return out.as_in_context(device)
    if type(out) in (list, tuple):
        return type(out)(_to_device(o, device) for o in out)
    return out


def _host_fallback(name):
    def fn(*args, **kwargs):
        _FALLBACK_CALLS[name] = _FALLBACK_CALLS.get(name, 0) + 1
        dev = next((a._t.device for a in args if isinstance(a, NDArray)),
                   None)
        def host(a):
            if isinstance(a, NDArray):
                return a.asnumpy()
            if type(a) in (list, tuple):
                return type(a)(host(v) for v in a)
            return a
        out = getattr(_onp, name)(*host(args), **kwargs)

        def back(o):
            if isinstance(o, _onp.ndarray):
                return array(o, device=dev)
            if isinstance(o, (list, tuple)):
                return type(o)(back(v) for v in o)
            return o
        return back(out)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"mx.np.{name} on host numpy (torch has no {name})."
    return fn


def _meta(name, impl):
    def fn(*args, **kwargs):
        return impl(*[a._t if isinstance(a, NDArray) else a for a in args],
                    **kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"mx.np.{name} (a dtype query)."
    return fn


for _name, _impl in _TABLE.items():
    globals()[_name] = _make_wrapper(_name, _impl)
    register_op("np." + _name, globals()[_name])
    __all__.append(_name)
for _name, _impl in _META.items():
    globals()[_name] = _meta(_name, _impl)
    register_op("np." + _name, globals()[_name])
    __all__.append(_name)
for _name in _FALLBACK:
    globals()[_name] = _host_fallback(_name)
    __all__.append(_name)
del _name, _impl


def put_along_axis(arr, indices, values, axis, inplace=True, mode=None):
    """np.put_along_axis, which also returns the updated array (numpy's
    returns None): an NDArray `arr` is written in place; another input is
    left as it is (use the returned array)."""
    out = _put_along(arr, indices, values, axis)
    if isinstance(arr, NDArray):
        arr[:] = out
    return out


_put_along = _make_wrapper("put_along_axis", _put_along_axis_fn)
register_op("np.put_along_axis", put_along_axis)
__all__.append("put_along_axis")


def fix(x):
    """Round toward zero (mx.np.fix: trunc)."""
    return globals()["trunc"](x)


__all__.append("fix")


def astype(a, dtype):
    return _as_nd(a).astype(dtype)


def may_share_memory(a, b, max_work=None):
    """Whether the storages of `a` and `b` overlap (a view shares its
    base's)."""
    if a is b:
        return True
    if not (isinstance(a, NDArray) and isinstance(b, NDArray)):
        return False
    sa, sb = a._t.untyped_storage(), b._t.untyped_storage()
    return sa.data_ptr() == sb.data_ptr() and sa.data_ptr() != 0


shares_memory = may_share_memory


def dtype(d):
    return name_to_dtype(d)


def get_include():
    return _onp.get_include()


from . import random  # noqa: E402
from . import linalg  # noqa: E402
