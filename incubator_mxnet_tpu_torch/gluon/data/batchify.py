"""Batchify functions of the PyTorch port (≙ python/mxnet/gluon/data/
batchify.py: Stack, Pad, Group — composable sample→batch assemblers used by
DataLoader). Counterpart of `incubator_mxnet_tpu/gluon/data/batchify.py`.

Outputs are NDArrays on the current device; Pad right-pads each sample to
the batch-max length per axis so the batch is rectangular.
"""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError

__all__ = ["Stack", "Pad", "Group"]


def _as_host(x):
    from ...ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


class Stack:
    """Stack samples along a new batch axis (≙ batchify.Stack)."""

    def __call__(self, data):
        from ... import np as mxnp
        return mxnp.array(_np.stack([_as_host(d) for d in data]))


class Pad:
    """Pad ragged samples to the batch max length per axis, then stack
    (≙ batchify.Pad). `val` fills; `dtype` optionally overrides."""

    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = int(axis)
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        from ... import np as mxnp
        arrs = [_as_host(d) for d in data]
        ndim = arrs[0].ndim
        if any(a.ndim != ndim for a in arrs):
            raise MXNetError("Pad needs samples of equal rank")
        max_shape = [max(a.shape[i] for a in arrs) for i in range(ndim)]
        dtype = _np.dtype(self._dtype) if self._dtype else arrs[0].dtype
        out = _np.full([len(arrs)] + max_shape, self._val, dtype)
        for i, a in enumerate(arrs):
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        return mxnp.array(out)


class Group:
    """Apply one batchify function per sample component
    (≙ batchify.Group: e.g. Group(Stack(), Pad(val=0)) for (img, caption))."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        if not fns:
            raise MXNetError("Group needs at least one batchify function")
        self._fns = fns

    def __call__(self, data):
        parts = list(zip(*data))
        if len(parts) != len(self._fns):
            raise MXNetError(
                f"Group has {len(self._fns)} functions but samples have "
                f"{len(parts)} components")
        return tuple(f(p) for f, p in zip(self._fns, parts))
