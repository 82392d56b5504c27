"""mx.np.linalg of the PyTorch port over `torch.linalg`.

Counterpart of `incubator_mxnet_tpu/numpy/linalg.py`: numpy's linalg names
with numpy's signatures, and MXNet's LAPACK-style ops (`syrk`, `trmm`,
`trsm`, `potrf`, `potri`, `gelqf`, `syevd`, `gemm2`) with the calling
conventions of `mx.nd.linalg`. Each call dispatches through
`ops.registry.invoke` as "linalg.<name>".
"""
from __future__ import annotations

import torch

from ..ops.registry import invoke
from . import _make_wrapper

_la = torch.linalg


def _norm(x, ord=None, axis=None, keepdims=False):
    if not x.is_floating_point() and not x.is_complex():
        x = x.float()
    if isinstance(axis, int):
        axis = (axis,)
    if axis is None and ord is None:
        return _la.vector_norm(x.reshape(-1), keepdim=False).reshape(
            [1] * x.dim() if keepdims else [])
    if axis is not None and len(axis) == 1:
        return _la.vector_norm(x, 2 if ord is None else ord, dim=axis,
                               keepdim=keepdims)
    return _la.norm(x, ord, dim=axis, keepdim=keepdims)


def _lstsq(a, b, rcond=None, numpy_resid=False):
    sol = _la.lstsq(a, b, driver="gelsd" if a.device.type == "cpu" else None)
    resid = sol.residuals
    rank = _la.matrix_rank(a).to(torch.int32)
    sv = _la.svdvals(a)
    return sol.solution, resid, rank, sv


def _qr(a, mode="reduced"):
    q, r = _la.qr(a, mode=mode)
    return r if mode == "r" else (q, r)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    if not compute_uv:
        return _la.svdvals(a)
    return tuple(_la.svd(a, full_matrices=full_matrices))


def _eig(a):
    return tuple(_la.eig(a))


def _eigh(a, UPLO=None, symmetrize_input=True):
    return tuple(_la.eigh(a, UPLO="L" if UPLO is None else UPLO))


def _slogdet(a, method=None):
    return tuple(_la.slogdet(a))


def _pinv(a, rtol=None, hermitian=False, rcond=None):
    return _la.pinv(a, rtol=rtol if rcond is None else rcond,
                    hermitian=hermitian)


def _matrix_rank(M, rtol=None, tol=None):
    return _la.matrix_rank(M, rtol=rtol, atol=tol)


def _tensorinv(a, ind=2):
    return _la.tensorinv(a, ind=ind)


def _tensorsolve(a, b, axes=None):
    return _la.tensorsolve(a, b, dims=axes)


def _cond(x, p=None):
    return _la.cond(x, p)


def _cross(x1, x2, axis=-1):
    return _la.cross(x1, x2, dim=axis)


def _tensordot(x1, x2, axes=2):
    return torch.tensordot(x1, x2, dims=axes)


def _vector_norm(x, axis=None, keepdims=False, ord=2):
    return _la.vector_norm(x, ord, dim=axis, keepdim=keepdims)


def _matrix_norm(x, keepdims=False, ord="fro"):
    return _la.matrix_norm(x, ord, keepdim=keepdims)


_NAMES = {
    "norm": _norm, "det": _la.det, "slogdet": _slogdet, "inv": _la.inv,
    "pinv": _pinv, "solve": _la.solve, "lstsq": _lstsq,
    "matrix_rank": _matrix_rank, "matrix_power": _la.matrix_power,
    "cholesky": _la.cholesky, "qr": _qr, "svd": _svd, "svdvals": _la.svdvals,
    "eig": _eig, "eigh": _eigh, "eigvals": _la.eigvals,
    "eigvalsh": lambda a, UPLO="L": _la.eigvalsh(a, UPLO=UPLO),
    "multi_dot": lambda arrays, precision=None: _la.multi_dot(list(arrays)),
    "tensorinv": _tensorinv, "tensorsolve": _tensorsolve, "cond": _cond,
    "cross": _cross, "outer": lambda x1, x2: torch.outer(x1, x2),
    "matmul": lambda x1, x2: torch.matmul(x1, x2),
    "tensordot": _tensordot, "vector_norm": _vector_norm,
    "matrix_norm": _matrix_norm,
}


for _n, _f in _NAMES.items():
    globals()[_n] = _make_wrapper("linalg." + _n, _f)
    globals()[_n].__name__ = _n


# ---------------------------------------------------------------------------
# MXNet's la_op family (src/operator/tensor/la_op.cc): the BLAS3 / LAPACK
# ops the numpy surface does not name
# ---------------------------------------------------------------------------
def _t(x):
    return x.transpose(-1, -2)


def _op(name, f, args):
    return invoke(f, args, name="linalg." + name)


def syrk(A, transpose=False, alpha=1.0):
    """alpha * A A^T (A^T A when `transpose`) ≙ linalg_syrk."""
    return _op("syrk", lambda a: alpha * (torch.matmul(_t(a), a) if transpose
                                          else torch.matmul(a, _t(a))), (A,))


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """Triangular multiply ≙ linalg_trmm: alpha * op(tri(A)) B (or B op(tri(A))
    when `rightside`)."""
    def f(a, b):
        t = torch.tril(a) if lower else torch.triu(a)
        if transpose:
            t = _t(t)
        return alpha * (torch.matmul(b, t) if rightside
                        else torch.matmul(t, b))
    return _op("trmm", f, (A, B))


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """Triangular solve ≙ linalg_trsm: X with op(tri(A)) X = alpha B (X
    op(tri(A)) = alpha B when `rightside`)."""
    def f(a, b):
        t = torch.tril(a) if lower else torch.triu(a)
        up = not lower
        if transpose:
            t, up = _t(t), lower
        return _la.solve_triangular(t, alpha * b, upper=up, left=not rightside)
    return _op("trsm", f, (A, B))


def potrf(A, lower=True):
    """Cholesky factor ≙ linalg_potrf."""
    return _op("potrf", lambda a: _la.cholesky(a, upper=not lower), (A,))


def potri(A, lower=True):
    """(L L^T)^-1 from the Cholesky factor L (U when not `lower`) ≙
    linalg_potri."""
    def f(a):
        L = a if lower else _t(a)
        eye = torch.eye(a.shape[-1], dtype=a.dtype,
                        device=a.device).expand(a.shape)
        Linv = _la.solve_triangular(L, eye, upper=False)
        return torch.matmul(_t(Linv), Linv)
    return _op("potri", f, (A,))


def gelqf(A):
    """LQ factorization ≙ linalg_gelqf: A = L Q, Q with orthonormal rows
    (through QR of A^T)."""
    def f(a):
        q, r = _la.qr(_t(a))
        return _t(r), _t(q)
    return _op("gelqf", f, (A,))


def syevd(A):
    """Symmetric eigendecomposition ≙ linalg_syevd: (U, lam) with A = U^T
    diag(lam) U."""
    def f(a):
        lam, v = _la.eigh(a)
        return _t(v), lam
    return _op("syevd", f, (A,))


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    """alpha * op(A) op(B) ≙ linalg_gemm2."""
    def f(a, b):
        return alpha * torch.matmul(_t(a) if transpose_a else a,
                                    _t(b) if transpose_b else b)
    return _op("gemm2", f, (A, B))


_LA_OPS = ["syrk", "trmm", "trsm", "potrf", "potri", "gelqf", "syevd",
           "gemm2"]
__all__ = list(_NAMES) + _LA_OPS
