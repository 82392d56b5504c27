"""mx.nd.sparse and io.LibSVMIter of the port against the JAX package's,
from the same seeded numpy inputs on the CPU (the counterpart of
tests/test_sparse_ndarray.py, less the kvstore's row-sparse pull, which
is ROADMAP A10's).

Tolerances: storage round trips, `check_format`, row slicing, `retain`,
`cast_storage` and the iterator's batches are exact (host numpy and scipy
in both packages); `dot` forward and its gradient to the dense operand
are float32 sums in another order than the JAX package's segment sum and
scipy's, held at rtol 1e-5 (atol 1e-6); the example's losses over its
first 10 steps at rtol 1e-4 (ten SGD steps compound the dot's rounding).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import scipy.sparse as sps

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ndarray import sparse as jsparse
from incubator_mxnet_tpu_torch.ndarray import sparse

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand_dense(m, n, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(m, n).astype(np.float32)
    a[rng.rand(m, n) > density] = 0
    return a


def _same_csr(t, j):
    """The port's CSR holds the JAX package's arrays, bit for bit."""
    assert t.stype == j.stype == "csr" and t.shape == j.shape
    np.testing.assert_array_equal(t._data_np, j._data_np)
    np.testing.assert_array_equal(t._indices_np, j._indices_np)
    np.testing.assert_array_equal(t._indptr_np, j._indptr_np)
    assert t.dtype == j.dtype


def _same_rsp(t, j):
    assert t.stype == j.stype == "row_sparse" and t.shape == j.shape
    np.testing.assert_array_equal(t._data_np, j._data_np)
    np.testing.assert_array_equal(t._indices_np, j._indices_np)


def test_sparse_resolves_like_the_jax_package():
    assert tmx.nd.sparse is sparse
    assert jmx.nd.sparse is jsparse
    assert sparse.__all__ == jsparse.__all__
    x = tmx.np.array(np.ones((2, 2), np.float32))
    assert x.stype == "default" and x.tostype("default") is x


def test_csr_roundtrips():
    a = _rand_dense(6, 9)
    c, jc = sparse.csr_matrix(a), jsparse.csr_matrix(a)
    _same_csr(c, jc)
    c.check_format()
    np.testing.assert_array_equal(c.asnumpy(), a)
    s = c.asscipy()
    assert sps.issparse(s)
    _same_csr(sparse.csr_matrix(s), jsparse.csr_matrix(jc.asscipy()))
    _same_csr(sparse.csr_matrix((c.data, c.indices, c.indptr), shape=(6, 9)),
              jsparse.csr_matrix((jc.data, jc.indices, jc.indptr),
                                 shape=(6, 9)))
    row, col = np.nonzero(a)
    _same_csr(sparse.csr_matrix((a[row, col], (row, col)), shape=(6, 9)),
              jsparse.csr_matrix((a[row, col], (row, col)), shape=(6, 9)))
    _same_csr(sparse.csr_matrix(tmx.np.array(a)),
              jsparse.csr_matrix(jmx.np.array(a)))


def test_ndarray_tostype_round_trips():
    """NDArray.tostype("csr" / "row_sparse") gives the arrays of the JAX
    package's cast_storage, and back to dense bit for bit."""
    a = _rand_dense(5, 7, seed=3)
    x = tmx.np.array(a)
    c = x.tostype("csr")
    _same_csr(c, jsparse.cast_storage(jmx.np.array(a), "csr"))
    r = x.tostype("row_sparse")
    _same_rsp(r, jsparse.cast_storage(jmx.np.array(a), "row_sparse"))
    for s in (c, r):
        back = s.tostype("default")
        assert isinstance(back, tmx.nd.NDArray)
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), a)
    with pytest.raises(tmx.MXNetError):
        x.tostype("coo")


def test_csr_check_format_rejects_bad():
    c = sparse.csr_matrix(_rand_dense(4, 5))
    jc = jsparse.csr_matrix(_rand_dense(4, 5))
    for mod, cc in ((sparse, c), (jsparse, jc)):
        bad = mod.CSRNDArray(cc._data_np, cc._indices_np + 5, cc._indptr_np,
                             (4, 5))
        with pytest.raises(Exception) as e:
            bad.check_format()
        assert "out of bounds" in str(e.value)
        with pytest.raises(Exception) as e:
            mod.CSRNDArray(cc._data_np, cc._indices_np, cc._indptr_np[:-1],
                           (4, 5)).check_format()
        assert "indptr" in str(e.value)
    with pytest.raises(tmx.MXNetError):
        sparse.CSRNDArray(c._data_np, c._indices_np + 5, c._indptr_np,
                          (4, 5)).check_format()


def test_csr_row_slicing():
    a = _rand_dense(8, 5)
    c, jc = sparse.csr_matrix(a), jsparse.csr_matrix(a)
    _same_csr(c[2], jc[2])
    _same_csr(c[1:5], jc[1:5])
    np.testing.assert_array_equal(c[1:5].asnumpy(), a[1:5])


def test_row_sparse_roundtrips():
    a = _rand_dense(7, 4, density=0.5)
    a[2] = 0
    a[5] = 0
    _same_rsp(sparse.row_sparse_array(a), jsparse.row_sparse_array(a))
    rows = np.array([1, 3])
    data = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    r2 = sparse.row_sparse_array((data, rows), shape=(7, 4))
    _same_rsp(r2, jsparse.row_sparse_array((data, rows), shape=(7, 4)))
    np.testing.assert_array_equal(
        r2.asnumpy(),
        jsparse.row_sparse_array((data, rows), shape=(7, 4)).asnumpy())


def test_retain():
    rows = np.array([1, 3, 6])
    data = np.random.RandomState(2).rand(3, 2).astype(np.float32)
    want = np.array([6, 3, 7, 3])
    kept = sparse.retain(sparse.row_sparse_array((data, rows), shape=(8, 2)),
                         tmx.np.array(want))
    jkept = jsparse.retain(
        jsparse.row_sparse_array((data, rows), shape=(8, 2)),
        jmx.np.array(want))
    _same_rsp(kept, jkept)
    np.testing.assert_array_equal(kept._indices_np, [3, 6])
    kept.check_format()


@pytest.mark.parametrize("src", ["default", "csr", "row_sparse"])
@pytest.mark.parametrize("dst", ["default", "csr", "row_sparse"])
def test_cast_storage_all_pairs(src, dst):
    a = _rand_dense(5, 6)
    t = sparse.cast_storage(tmx.np.array(a), src)
    j = jsparse.cast_storage(jmx.np.array(a), src)
    tout, jout = sparse.cast_storage(t, dst), jsparse.cast_storage(j, dst)
    assert getattr(tout, "stype", "default") == dst
    np.testing.assert_array_equal(tout.asnumpy(), np.asarray(jout.asnumpy()))
    np.testing.assert_array_equal(tout.asnumpy(), a)
    if dst == "csr":
        _same_csr(tout, jout)
    elif dst == "row_sparse":
        _same_rsp(tout, jout)


def test_csr_arithmetic_preserves_stype():
    a, b = _rand_dense(4, 6, seed=1), _rand_dense(4, 6, seed=2)
    ca, cb = sparse.csr_matrix(a), sparse.csr_matrix(b)
    ja, jb = jsparse.csr_matrix(a), jsparse.csr_matrix(b)
    _same_csr(ca + cb, ja + jb)
    _same_csr(ca * 2.0, ja * 2.0)
    np.testing.assert_array_equal((ca - cb).asnumpy(), (ja - jb).asnumpy())


def _dot_pair(a, w, transpose_a=False):
    t = sparse.dot(sparse.csr_matrix(a), tmx.np.array(w),
                   transpose_a=transpose_a)
    j = jsparse.dot(jsparse.csr_matrix(a), jmx.np.array(w),
                    transpose_a=transpose_a)
    return t.asnumpy(), np.asarray(j.asnumpy())


def test_dot_forward_matches_jax_and_scipy():
    a = _rand_dense(9, 13)
    w = np.random.RandomState(3).rand(13, 4).astype(np.float32)
    t, j = _dot_pair(a, w)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, sps.csr_matrix(a) @ w, rtol=RTOL,
                               atol=ATOL)
    u = np.random.RandomState(4).rand(9, 4).astype(np.float32)
    t, j = _dot_pair(a, u, transpose_a=True)
    assert t.shape == (13, 4)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, sps.csr_matrix(a).T @ u, rtol=RTOL,
                               atol=ATOL)
    z = sparse.zeros("csr", (3, 13))
    np.testing.assert_array_equal(
        sparse.dot(z, tmx.np.array(w)).asnumpy(), np.zeros((3, 4)))


def test_dot_matvec_and_copyto_and_shape_guard():
    a = _rand_dense(5, 7)
    v = np.random.RandomState(8).rand(7).astype(np.float32)
    t, j = _dot_pair(a, v)
    assert t.shape == j.shape == (5,)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    c = sparse.csr_matrix(a)
    dst = sparse.zeros("csr", (5, 7))
    c.copyto(dst)
    _same_csr(dst, jsparse.csr_matrix(a))
    # the dot after copyto reads the new values, not a stale device copy
    dst2 = sparse.zeros("csr", (5, 7))
    sparse.dot(dst2, tmx.np.array(v))
    c.copyto(dst2)
    np.testing.assert_allclose(sparse.dot(dst2, tmx.np.array(v)).asnumpy(),
                               j, rtol=RTOL, atol=ATOL)
    for mod in (sparse, jsparse):
        with pytest.raises(Exception, match="does not match"):
            mod.csr_matrix(a, shape=(9, 7))
    with pytest.raises(tmx.MXNetError, match="mismatch"):
        sparse.dot(c, tmx.np.array(np.ones((6, 2), np.float32)))
    with pytest.raises(tmx.MXNetError, match="mismatch"):
        sparse.dot(c, tmx.np.array(np.ones((7, 2), np.float32)),
                   transpose_a=True)


def test_dot_copies_ids_to_the_device_once():
    c = sparse.csr_matrix(_rand_dense(6, 8))
    w = tmx.np.array(np.ones((8, 2), np.float32))
    sparse.dot(c, w)
    parts = c._parts[w._t.device]
    sparse.dot(c, w)
    sparse.dot(c, tmx.np.array(np.ones((6, 2), np.float32)),
               transpose_a=True)
    assert len(c._parts) == 1 and c._parts[w._t.device] is parts


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_backward_through_tape(transpose_a):
    a = _rand_dense(6, 8)
    rng = np.random.RandomState(5)
    w0 = rng.rand(6 if transpose_a else 8, 3).astype(np.float32)
    cot = rng.rand(8 if transpose_a else 6, 3).astype(np.float32)
    grads = []
    for mx_, sp_ in ((tmx, sparse), (jmx, jsparse)):
        w = mx_.np.array(w0)
        w.attach_grad()
        with mx_.autograd.record():
            y = sp_.dot(sp_.csr_matrix(a), w, transpose_a=transpose_a)
            L = (y * mx_.np.array(cot)).sum()
        L.backward()
        grads.append(np.asarray(w.grad.asnumpy()))
    np.testing.assert_allclose(grads[0], grads[1], rtol=RTOL, atol=ATOL)
    want = a @ cot if transpose_a else a.T @ cot
    np.testing.assert_allclose(grads[0], want, rtol=RTOL, atol=ATOL)


def _libsvm_batches(mod, path, **kw):
    out = []
    for b in mod.io.LibSVMIter(str(path), (4,), batch_size=2, **kw):
        x = b.data[0]
        out.append((x, np.asarray(b.label[0].asnumpy()), b.pad))
    return out


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter_matches_jax(tmp_path, round_batch):
    f = tmp_path / "t.libsvm"
    f.write_text("1 0:1.5 3:2.0\n0 1:0.5\n\n1 2:3.0 3:1.0\n")
    t = _libsvm_batches(tmx, f, round_batch=round_batch)
    j = _libsvm_batches(jmx, f, round_batch=round_batch)
    assert len(t) == len(j) == (2 if round_batch else 1)
    for (tx, tl, tp), (jx, jl, jp) in zip(t, j):
        _same_csr(tx, jx)
        np.testing.assert_array_equal(tl, jl)
        assert tl.dtype == jl.dtype
        assert tp == jp
    assert t[-1][2] == (1 if round_batch else 0)
    it = tmx.io.LibSVMIter(str(f), (4,), batch_size=2)
    jit = jmx.io.LibSVMIter(str(f), (4,), batch_size=2)
    assert it.provide_data[0].shape == jit.provide_data[0].shape == (2, 4)
    assert it.provide_label[0].shape == jit.provide_label[0].shape
    # reset serves the same batches again
    first = [b.data[0].asnumpy() for b in it]
    it.reset()
    np.testing.assert_array_equal(
        np.stack(first), np.stack([b.data[0].asnumpy() for b in it]))
    # dense opt-out
    x = next(iter(tmx.io.LibSVMIter(str(f), (4,), batch_size=2,
                                    data_stype="default"))).data[0]
    jx = next(iter(jmx.io.LibSVMIter(str(f), (4,), batch_size=2,
                                     data_stype="default"))).data[0]
    assert isinstance(x, tmx.nd.NDArray)
    np.testing.assert_array_equal(x.asnumpy(), np.asarray(jx.asnumpy()))


def test_libsvm_iter_refuses_out_of_range_and_empty(tmp_path):
    f = tmp_path / "one_based.libsvm"
    f.write_text("1 4:1.0\n")
    with pytest.raises(tmx.MXNetError, match="zero-based"):
        tmx.io.LibSVMIter(str(f), (4,))
    e = tmp_path / "empty.libsvm"
    e.write_text("\n")
    with pytest.raises(tmx.MXNetError, match="no examples"):
        tmx.io.LibSVMIter(str(e), (4,))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", name + ".py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_sparse_linear_example_matches_jax_over_ten_steps():
    """One batch an epoch, so each epoch's loss is one step's: the port's
    example and the JAX package's from the same file, 10 steps."""
    kw = dict(n=64, d=32, epochs=10, batch_size=64, lr=0.3)
    tl, tw = _load("torch_sparse_linear").run(device="cpu", **kw)
    jl, jw = _load("sparse_linear").run(**kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_sparse_linear_example_converges():
    losses, _ = _load("torch_sparse_linear").run(
        n=128, d=32, epochs=12, batch_size=32, lr=0.3, device="cpu")
    assert losses[-1] < losses[0] * 0.2, losses
