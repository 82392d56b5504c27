"""mx.nd.sparse of the PyTorch port — CSR and row-sparse storage.

Counterpart of `incubator_mxnet_tpu/ndarray/sparse.py`, with the same
names, checks and results. The aux arrays (indices, indptr) and the stored
values stay on the host as numpy, as the reference keeps them in aux
storage: constructors, `check_format`, row slicing, `retain`,
`cast_storage` and the storage-preserving arithmetic are host work (numpy
and scipy). An array's `device` is where its dense results land (the
current device when it was made, unless `ctx` names one).

The one op with FLOPs, `dot(csr, dense[, transpose_a])`, runs on the
dense operand's device as a gather and a segment sum in torch ops
(`index_select` of the dense rows, then `index_add` over the row or
column ids), through the op dispatcher, so it is differentiable with
respect to the dense operand on the port's tape. An array copies its
values and ids to a device once, at its first dot there, and keeps them.
On CUDA, `index_add` adds with atomics: float32 sums are not bit-stable
from run to run (the order of the adds varies), only within rounding.

Reference: python/mxnet/ndarray/sparse.py:120 (BaseSparseNDArray), :301
(CSRNDArray), :575 (RowSparseNDArray); src/operator/tensor/
cast_storage-inl.h; src/operator/tensor/dot-inl.h (the CSR dot kernels,
transpose included); src/operator/tensor/sparse_retain-inl.h.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..device import as_device, current_device
from ..ops.registry import invoke
from . import NDArray, _as_nd, _mxnp, array as _dense_array

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "dot",
           "retain", "zeros", "array", "empty"]


def _norm_dtype(dtype):
    return _np.dtype(dtype or "float32")


def _host(x):
    """`x` (an NDArray, a tensor, a list or an array) as numpy."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _device_of(ctx):
    """The `Device` an array made with `ctx` lives on."""
    return current_device() if ctx is None else as_device(ctx)


def _to_device(a, dev):
    """A host numpy array as a tensor on `dev` (one copy)."""
    a = _np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


class BaseSparseNDArray:
    """Common sparse container behavior (≙ sparse.py:120)."""

    stype = None

    def __init__(self, shape, dtype, ctx=None):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = _np.dtype(dtype)
        self._device = _device_of(ctx)

    # -- NDArray-protocol surface -------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return int(_np.prod(self._shape)) if self._shape else 1

    @property
    def device(self):
        return self._device

    context = ctx = device

    def __len__(self):
        return self._shape[0]

    def __repr__(self):
        return (f"<{type(self).__name__} {self._shape} "
                f"{self._dtype.name} @{self._device}>")

    def wait_to_read(self):
        return self

    def asnumpy(self):
        raise NotImplementedError

    def tostype(self, stype):
        raise NotImplementedError

    def astype(self, dtype, copy=True):
        raise NotImplementedError

    def _dense(self, a):
        return _dense_array(a, device=self._device)

    def todense(self):
        """Dense NDArray of the same values, on the array's device."""
        return self._dense(self.asnumpy())

    def as_nd_ndarray(self):
        return self.todense()

    def copyto(self, other):
        if isinstance(other, NDArray):
            other[:] = self.todense()
            return other
        if isinstance(other, BaseSparseNDArray):
            if other.shape != self.shape:
                raise MXNetError(
                    f"copyto shape mismatch: {self.shape} -> {other.shape}")
            # in place, like the dense branch (≙ reference copyto)
            src = cast_storage(self, other.stype)
            other._data_np = src._data_np
            other._indices_np = src._indices_np
            if hasattr(src, "_indptr_np"):
                other._indptr_np = src._indptr_np
            other._parts = {}
            return other
        raise MXNetError(f"cannot copyto {type(other).__name__}")

    def copy(self):
        return self.tostype(self.stype)

    # elementwise arithmetic on the host through scipy (storage-preserving
    # for csr + csr, ≙ elemwise_add(csr, csr) -> csr)
    def _binary(self, other, op):
        import scipy.sparse as sp
        if isinstance(other, BaseSparseNDArray) \
                and other.stype == self.stype == "csr":
            out = op(self.asscipy(), other.asscipy())
            if sp.issparse(out):
                return csr_matrix(out.tocsr(), ctx=self._device,
                                  dtype=self._dtype)
            return self._dense(_np.asarray(out, self._dtype))
        rhs = other.asnumpy() if hasattr(other, "asnumpy") else other
        return self._dense(op(self.asnumpy(), rhs).astype(self._dtype))

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        if _np.isscalar(other):
            out = self.copy()
            out._data_np = (out._data_np * other).astype(self._dtype)
            return out
        return self._binary(other, lambda a, b: a.multiply(b)
                            if hasattr(a, "multiply") else a * b)

    __radd__ = __add__
    __rmul__ = __mul__


class CSRNDArray(BaseSparseNDArray):
    """Compressed-sparse-row 2-D array (≙ sparse.py:301)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        data = _np.asarray(data)
        dtype = _norm_dtype(dtype or data.dtype)
        super().__init__(shape, dtype, ctx)
        if len(self._shape) != 2:
            raise MXNetError("csr storage is 2-D only")
        self._data_np = data.astype(dtype, copy=False).ravel()
        self._indices_np = _np.asarray(indices, _np.int64).ravel()
        self._indptr_np = _np.asarray(indptr, _np.int64).ravel()
        # {torch.device: (values, row ids, column ids)}: the dot's copies
        self._parts = {}

    # aux accessors return dense NDArrays like the reference's aux reads
    @property
    def data(self):
        return self._dense(self._data_np)

    @property
    def indices(self):
        return self._dense(self._indices_np)

    @property
    def indptr(self):
        return self._dense(self._indptr_np)

    @property
    def nnz(self):
        return int(self._data_np.size)

    def check_format(self, full_check=True):
        """≙ sparse.py:266 / CheckFormatCSRImpl."""
        m, n = self._shape
        if self._indptr_np.size != m + 1 or self._indptr_np[0] != 0:
            raise MXNetError("indptr must have length rows+1 and start at 0")
        if self._indptr_np[-1] != self._data_np.size:
            raise MXNetError("indptr[-1] must equal nnz")
        if (_np.diff(self._indptr_np) < 0).any():
            raise MXNetError("indptr must be non-decreasing")
        if full_check and self._indices_np.size:
            if self._indices_np.min() < 0 or self._indices_np.max() >= n:
                raise MXNetError("column index out of bounds")
            for r in range(m):
                lo, hi = self._indptr_np[r], self._indptr_np[r + 1]
                seg = self._indices_np[lo:hi]
                if (_np.diff(seg) <= 0).any():
                    raise MXNetError(
                        f"indices in row {r} must be strictly increasing")

    def asscipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (self._data_np, self._indices_np, self._indptr_np), self._shape)

    def asnumpy(self):
        return self.asscipy().toarray()

    def astype(self, dtype, copy=True):
        if not copy and _np.dtype(dtype) == self._dtype:
            return self
        return CSRNDArray(self._data_np.astype(dtype), self._indices_np,
                          self._indptr_np, self._shape, dtype, self._device)

    def __getitem__(self, key):
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not isinstance(key, slice):
            raise MXNetError("csr supports int/slice row indexing only")
        sub = self.asscipy()[key]
        return CSRNDArray(sub.data, sub.indices, sub.indptr, sub.shape,
                          self._dtype, self._device)

    def tostype(self, stype):
        if stype == "csr":
            return CSRNDArray(self._data_np.copy(), self._indices_np.copy(),
                              self._indptr_np.copy(), self._shape,
                              self._dtype, self._device)
        if stype == "default":
            return self.todense()
        if stype == "row_sparse":
            dense = self.asnumpy()
            rows = _np.nonzero(_np.diff(self._indptr_np) > 0)[0]
            return RowSparseNDArray(dense[rows], rows, self._shape,
                                    self._dtype, self._device)
        raise MXNetError(f"unknown stype {stype!r}")

    def _row_ids(self):
        """indptr expanded to one row id per stored value (host-side)."""
        return _np.repeat(_np.arange(self._shape[0], dtype=_np.int64),
                          _np.diff(self._indptr_np))

    def _device_parts(self, dev):
        """(values, row ids, column ids) on `dev`: three host-to-device
        copies at the first call for `dev`, none after. The row ids are
        expanded from indptr there."""
        parts = self._parts.get(dev)
        if parts is None:
            counts = _to_device(_np.diff(self._indptr_np), dev)
            rows = torch.repeat_interleave(
                torch.arange(self._shape[0], device=dev), counts,
                output_size=self.nnz)
            parts = (_to_device(self._data_np, dev), rows,
                     _to_device(self._indices_np, dev))
            self._parts[dev] = parts
        return parts


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array: a subset of rows stored densely
    (≙ sparse.py:575)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        data = _np.asarray(data)
        dtype = _norm_dtype(dtype or data.dtype)
        super().__init__(shape, dtype, ctx)
        self._data_np = data.astype(dtype, copy=False)
        self._indices_np = _np.asarray(indices, _np.int64).ravel()
        if self._data_np.shape[:1] != self._indices_np.shape:
            raise MXNetError("data must have one slice per index")
        if self._data_np.ndim >= 2 \
                and self._data_np.shape[1:] != self._shape[1:]:
            raise MXNetError("row slices must match the trailing shape")

    @property
    def data(self):
        return self._dense(self._data_np)

    @property
    def indices(self):
        return self._dense(self._indices_np)

    def check_format(self, full_check=True):
        """≙ CheckFormatRSPImpl: indices strictly increasing, in range,
        one data slice per index."""
        if self._data_np.shape[0] != self._indices_np.size:
            raise MXNetError("data must have one slice per index")
        if full_check and self._indices_np.size:
            if self._indices_np.min() < 0 \
                    or self._indices_np.max() >= self._shape[0]:
                raise MXNetError("row index out of bounds")
            if (_np.diff(self._indices_np) <= 0).any():
                raise MXNetError("indices must be strictly increasing")

    def asnumpy(self):
        out = _np.zeros(self._shape, self._dtype)
        if self._indices_np.size:
            out[self._indices_np] = self._data_np
        return out

    def astype(self, dtype, copy=True):
        if not copy and _np.dtype(dtype) == self._dtype:
            return self
        return RowSparseNDArray(self._data_np.astype(dtype),
                                self._indices_np, self._shape, dtype,
                                self._device)

    def __getitem__(self, key):
        if key == slice(None):
            return self.todense()
        raise MXNetError("row_sparse supports [:] read only (≙ reference)")

    def retain(self, indices):
        """≙ sparse_retain: keep only the requested rows, their ids sorted
        and deduplicated (the strictly increasing invariant of
        `check_format`), whatever order they were asked in."""
        want = _host(indices).astype(_np.int64).ravel()
        pos = {r: i for i, r in enumerate(self._indices_np)}
        keep = sorted({int(r) for r in want if r in pos})
        data = (self._data_np[[pos[r] for r in keep]] if keep
                else _np.zeros((0,) + self._shape[1:], self._dtype))
        return RowSparseNDArray(data, _np.asarray(keep, _np.int64),
                                self._shape, self._dtype, self._device)

    def tostype(self, stype):
        if stype == "row_sparse":
            return RowSparseNDArray(self._data_np.copy(),
                                    self._indices_np.copy(), self._shape,
                                    self._dtype, self._device)
        if stype == "default":
            return self.todense()
        if stype == "csr":
            return cast_storage(self.todense(), "csr")
        raise MXNetError(f"unknown stype {stype!r}")


# ---------------------------------------------------------------------------
# constructors (≙ sparse.py csr_matrix / row_sparse_array)
# ---------------------------------------------------------------------------
def _ctx_of(arg, ctx):
    """`ctx`, else the device of an NDArray source."""
    if ctx is None and isinstance(arg, NDArray):
        return arg.device
    return ctx


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr), a dense array, a
    scipy.sparse matrix, or (data, (row, col)) COO triples."""
    import scipy.sparse as sp
    if isinstance(arg1, CSRNDArray):
        out = arg1.tostype("csr")
        return out.astype(dtype, copy=False) if dtype else out
    if sp.issparse(arg1):
        m = arg1.tocsr()
        if shape is not None and tuple(shape) != m.shape:
            raise MXNetError(
                f"shape {tuple(shape)} does not match the source's "
                f"{m.shape}")
        return CSRNDArray(m.data, m.indices, m.indptr, m.shape,
                          dtype or m.dtype, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("shape is required with (data,indices,indptr)")
        return CSRNDArray(_host(data), _host(indices), _host(indptr), shape,
                          dtype, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and isinstance(arg1[1], tuple):
        data, (row, col) = arg1
        m = sp.coo_matrix((_host(data), (_host(row), _host(col))),
                          shape=shape).tocsr()
        return CSRNDArray(m.data, m.indices, m.indptr, m.shape, dtype, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:   # a plain shape tuple
        return zeros("csr", arg1, ctx=ctx, dtype=dtype)
    dense = _host(arg1)
    if shape is not None and tuple(shape) != dense.shape:
        raise MXNetError(
            f"shape {tuple(shape)} does not match the source's "
            f"{dense.shape}")
    m = sp.csr_matrix(dense)
    return CSRNDArray(m.data, m.indices, m.indptr, dense.shape,
                      dtype or dense.dtype, _ctx_of(arg1, ctx))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices), a dense array, or another
    RowSparseNDArray."""
    if isinstance(arg1, RowSparseNDArray):
        out = arg1.tostype("row_sparse")
        return out.astype(dtype, copy=False) if dtype else out
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not isinstance(arg1[1], tuple) and _np.ndim(arg1[0]) >= 1 \
            and not isinstance(arg1[0], int):
        data, indices = arg1
        if shape is None:
            raise MXNetError("shape is required with (data, indices)")
        return RowSparseNDArray(_host(data), _host(indices), shape, dtype,
                                ctx)
    if isinstance(arg1, tuple):                       # a plain shape tuple
        return zeros("row_sparse", arg1, ctx=ctx, dtype=dtype)
    dense = _host(arg1)
    rows = _np.nonzero(_np.any(dense.reshape(dense.shape[0], -1) != 0, 1))[0]
    return RowSparseNDArray(dense[rows], rows, shape or dense.shape,
                            dtype or dense.dtype, _ctx_of(arg1, ctx))


def zeros(stype, shape, ctx=None, dtype=None):
    dtype = _norm_dtype(dtype)
    if stype == "csr":
        return CSRNDArray(_np.zeros(0, dtype), _np.zeros(0, _np.int64),
                          _np.zeros(shape[0] + 1, _np.int64), shape, dtype,
                          ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(_np.zeros((0,) + tuple(shape[1:]), dtype),
                                _np.zeros(0, _np.int64), shape, dtype, ctx)
    if stype == "default":
        from . import zeros as dzeros
        return dzeros(shape, device=ctx, dtype=dtype)
    raise MXNetError(f"unknown stype {stype!r}")


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """≙ sparse.array — sparse in, sparse out."""
    import scipy.sparse as sp
    if isinstance(source_array, BaseSparseNDArray):
        return source_array.copy() if dtype is None \
            else source_array.astype(dtype)
    if sp.issparse(source_array):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise MXNetError("sparse.array expects a sparse input; use mx.nd.array")


def cast_storage(arr, stype):
    """≙ src/operator/tensor/cast_storage-inl.h — convert between
    'default', 'csr' and 'row_sparse' storage."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    nd = _as_nd(arr)
    if stype == "default":
        return nd
    if stype == "csr":
        return csr_matrix(nd)
    if stype == "row_sparse":
        return row_sparse_array(nd)
    raise MXNetError(f"unknown stype {stype!r}")


def retain(rsp, indices):
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    return rsp.retain(indices)


# ---------------------------------------------------------------------------
# the CSR dot — the op with FLOPs, on the dense operand's device
# (≙ dot-inl.h's CSR kernels)
# ---------------------------------------------------------------------------
def _csr_dot(vals, gather, seg, dense, num_seg):
    """out[s] = sum over k with seg[k] == s of vals[k] * dense[gather[k]]:
    one `index_select` of the dense rows, one `index_add` of the scaled
    rows into `num_seg` zero rows (atomic adds on CUDA)."""
    rows = dense.index_select(0, gather)
    contrib = rows * (vals if dense.dim() == 1 else vals[:, None])
    out = contrib.new_zeros((num_seg,) + tuple(dense.shape[1:]))
    return out.index_add(0, seg, contrib)


def dot(lhs, rhs, transpose_a=False):
    """dot(csr, dense[, transpose_a]) -> dense, computed on the dense
    operand's device as a gather and a segment sum. Differentiable with
    respect to the dense operand on the tape (what sparse linear models
    train). Dense x dense falls through to the dense dot; a row-sparse
    operand is densified first."""
    if isinstance(lhs, RowSparseNDArray) or isinstance(rhs,
                                                       BaseSparseNDArray):
        lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    if not isinstance(lhs, CSRNDArray):
        lhs = _as_nd(lhs)
        return _mxnp().dot(lhs.T if transpose_a else lhs, _as_nd(rhs))

    rhs = _as_nd(rhs)
    m, n = lhs.shape
    if rhs.shape[0] != (m if transpose_a else n):
        op = "csr.T" if transpose_a else "csr"
        raise MXNetError(
            f"dot({op}, dense): {lhs.shape} x {rhs.shape} mismatch")
    vals, rows, cols = lhs._device_parts(rhs._t.device)
    gather, seg, num_seg = (rows, cols, n) if transpose_a \
        else (cols, rows, m)
    return invoke(_csr_dot, (vals, gather, seg, rhs), name="sparse_dot",
                  kwargs=dict(num_seg=num_seg))
