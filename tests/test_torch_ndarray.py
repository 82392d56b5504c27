"""PyTorch port: `NDArray` against the JAX package's on the CPU.

Creation dtypes, properties, views both ways (in and out of `record()`),
`setitem` with scalars, arrays and advanced keys, the in-place dunders,
scalar binops' dtypes, `save` / `load` crossing both ways with the JAX
package's files, `mx.nd.reshape`'s magic, and the device rules without a
card. Values exact unless a tolerance is stated.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from torch_port_utils import assert_parity

torch.set_num_threads(1)

CPU = tmx.cpu()
R = np.random.RandomState(0)
A = R.randn(4, 5).astype(np.float32)
B = R.randn(4, 5).astype(np.float32)


def both(v, **kw):
    return jmx.np.array(v, **kw), tmx.np.array(v, device=CPU, **kw)


@pytest.mark.parametrize("src", [
    np.arange(6, dtype=np.float64), np.arange(6, dtype=np.int64),
    np.arange(6, dtype=np.int32), np.arange(6) > 2,
    np.arange(6, dtype=np.float16), [1, 2, 3], [1.0, 2.5], 3.0, 7,
    np.arange(6, dtype=np.uint8), np.arange(6, dtype=np.int8)])
def test_creation_dtypes_match_jax(src):
    j, t = both(src)
    assert_parity(t, j)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "int32", "int64", "float64", "bool",
                                   "uint8"])
def test_creation_with_dtype_matches_jax(dtype):
    j, t = both(A, dtype=dtype)
    assert_parity(t, j)
    for fn in ("zeros", "ones"):
        assert_parity(getattr(tmx.np, fn)((2, 3), dtype=dtype, device=CPU),
                      getattr(jmx.np, fn)((2, 3), dtype=dtype))
    assert_parity(tmx.np.full((2, 3), 3, dtype=dtype, device=CPU),
                  jmx.np.full((2, 3), 3, dtype=dtype))


def test_defaults_and_arange_match_jax():
    assert_parity(tmx.np.zeros((2, 3), device=CPU), jmx.np.zeros((2, 3)))
    assert_parity(tmx.np.empty(4, device=CPU), jmx.np.empty(4))
    for args in ((5,), (1, 7, 2), (0, 1, 0.25), (2, 9)):
        assert_parity(tmx.np.arange(*args, device=CPU), jmx.np.arange(*args))
    assert_parity(tmx.np.arange(0, 6, 1, dtype="int32", device=CPU),
                  jmx.np.arange(0, 6, 1, dtype="int32"))
    assert_parity(tmx.nd.arange(0, 3, repeat=2, device=CPU),
                  jmx.nd.arange(0, 3, repeat=2))


def test_properties_match_jax():
    j, t = both(A)
    assert t.shape == j.shape and t.size == j.size and t.ndim == j.ndim
    assert t.itemsize == j.itemsize and t.stype == j.stype == "default"
    assert str(t.dtype) == str(j.dtype) == "float32"
    assert_parity(t.T, j.T)
    assert t.device == CPU and t.ctx == CPU and t.context == tmx.cpu(0)
    assert len(t) == len(j) == 4
    assert [r.shape for r in t] == [r.shape for r in j]
    jb, tb = both(A, dtype="bfloat16")
    assert tb.dtype == tmx.np.bfloat16 == "bfloat16" == str(jb.dtype)
    assert str(tb.dtype) == "bfloat16" and tb.dtype.itemsize == 2
    # bfloat16 comes to the host widened to float32 (no ml_dtypes)
    assert tb.asnumpy().dtype == np.float32
    np.testing.assert_array_equal(tb.asnumpy(),
                                  np.asarray(jb.asnumpy(), np.float32))
    s = tmx.np.array(2.5, device=CPU)
    assert float(s) == 2.5 and s.item() == 2.5 and int(s) == 2
    assert bool(tmx.np.array([1], device=CPU))
    assert [1, 2][tmx.np.array(1, dtype="int32", device=CPU)] == 2
    assert t.tolist() == j.tolist()
    assert t.asscalar if t.size > 1 else True


def test_asnumpy_is_a_copy():
    t = tmx.np.array(A, device=CPU)
    h = t.asnumpy()
    t[:] = 0
    np.testing.assert_array_equal(h, A)


def test_views_write_through_both_ways_as_jax():
    j, t = both(A)
    jv, tv = j[1:3], t[1:3]
    jv[:] = 5.0
    tv[:] = 5.0
    assert_parity(t, j)
    j[2] = -1.0
    t[2] = -1.0
    assert_parity(tv, jv)
    jv2, tv2 = j[:, 1], t[:, 1]
    jv2[0] = 9.0
    tv2[0] = 9.0
    assert_parity(t, j)


def test_views_in_record_write_through_and_differentiate():
    for pkg in (jmx, tmx):
        pass
    jx, tx = both(A)
    jx.attach_grad()
    tx.attach_grad()
    with jmx.autograd.record():
        jy = (jx[1:3] * 2).sum()
    with tmx.autograd.record():
        ty = (tx[1:3] * 2).sum()
    jy.backward()
    ty.backward()
    assert_parity(tx.grad, jx.grad)
    # outside record a view of a variable writes through to it
    j, t = both(A)
    t.attach_grad()
    j.attach_grad()
    t[0:1][:] = 3.0
    j[0:1][:] = 3.0
    assert_parity(t, j)


def test_x_slice_all_assignment_copies():
    j, t = both(A)
    jy, ty = both(B)
    j[:] = jy
    t[:] = ty
    ty[0, 0] = 100.0          # a later write to y must not reach x
    jy[0, 0] = 100.0
    assert_parity(t, j)
    assert t[0, 0].item() == float(B[0, 0])


@pytest.mark.parametrize("key,value", [
    ((1, 2), 7.0), ((slice(None), 0), 3), (1, np.arange(5.0)),
    (np.array([0, 2]), -1.0), ([1, 3], 2.5), (A > 0, 0.0),
    ((slice(None), [0, 4]), 8.0), (slice(None, None, -2), 4.0),
    ((slice(None), slice(4, 0, -2)), np.array([1.0, 2.0])),
    (Ellipsis, 1.5), ((None, 1), 6.0)])
def test_setitem_matches_jax(key, value):
    j, t = both(A)
    jval = jmx.np.array(value) if isinstance(value, np.ndarray) else value
    tval = tmx.np.array(value, device=CPU) if isinstance(
        value, np.ndarray) else value
    j[key] = jval
    t[key] = tval
    assert_parity(t, j)


@pytest.mark.parametrize("key", [
    1, (1, 2), slice(1, 3), (slice(None), 2), (Ellipsis, 1), (None, 0),
    slice(None, None, -1), (slice(3, 0, -2), slice(None, None, -3)),
    np.array([0, 3, 1]), A[:, 0] > 0, ([0, 1], [2, 3]), (slice(1, 3), [4])])
def test_getitem_matches_jax(key):
    j, t = both(A)
    assert_parity(t[key], j[key])


def test_inplace_dunders_match_jax():
    j, t = both(A)
    for op in ("+=", "-=", "*=", "/="):
        jo, to = both(B)
        exec(f"j {op} jo", {"j": j, "jo": jo})
        loc = {"t": t, "to": to}
        exec(f"t {op} to", loc)
        j2 = j if op != "+=" else j
        assert_parity(loc["t"], j2)
        t = loc["t"]
    # an int array that takes a float result takes the result's dtype
    ji, ti = both(np.arange(4, dtype=np.int32))
    ji += 1.5
    ti += 1.5
    assert_parity(ti, ji)
    ji, ti = both(np.arange(4, dtype=np.int32))
    ji *= 3
    ti *= 3
    assert_parity(ti, ji)


def test_inplace_writes_through_a_view_outside_record():
    t = tmx.np.array(A, device=CPU)
    v = t[1]
    before = id(v._t)
    v += 1.0
    assert id(v._t) == before
    np.testing.assert_array_equal(t.asnumpy()[1], A[1] + 1.0)


def test_inplace_on_a_variable_outside_record_keeps_it_a_variable():
    j, t = both(A)
    j.attach_grad()
    t.attach_grad()
    for pkg, x in ((jmx, j), (tmx, t)):
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
        x -= 0.1 * x.grad          # manual SGD
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
    assert_parity(t, j)
    assert_parity(t.grad, j.grad)


def test_inplace_in_record_takes_the_tape_entry():
    j, t = both(A)
    j.attach_grad()
    t.attach_grad()
    for pkg, x in ((jmx, j), (tmx, t)):
        with pkg.autograd.record():
            y = x * 2
            y += x * x
            z = y.sum()
        z.backward()
    assert_parity(t.grad, j.grad)


@pytest.mark.parametrize("dtype,scalar", [
    ("int32", 2.5), ("int32", 3), ("bool", 1), ("bfloat16", 2.0),
    ("float16", 3), ("int8", 1), ("uint8", 2), ("float32", 2)])
def test_scalar_binops_dtypes_match_jax(dtype, scalar):
    j, t = both(np.abs(A) + 1, dtype=dtype)
    for f in (lambda x: x + scalar, lambda x: scalar * x, lambda x: x - scalar,
              lambda x: x / scalar, lambda x: x > scalar,
              lambda x: scalar - x):
        assert_parity(f(t), f(j))


def test_array_binops_and_numpy_operands_match_jax():
    j, t = both(A)
    jb, tb = both(B)
    for f in (lambda x, y: x + y, lambda x, y: x @ y.T, lambda x, y: x ** 2,
              lambda x, y: x // 0.7, lambda x, y: x % 0.7, lambda x, y: -x,
              lambda x, y: abs(x), lambda x, y: x == y, lambda x, y: x != y,
              lambda x, y: x <= y, lambda x, y: x + B, lambda x, y: A * x):
        assert_parity(f(t, tb), f(j, jb))


def test_methods_match_jax():
    j, t = both(A)
    calls = [
        lambda x: x.reshape(2, 10), lambda x: x.reshape((-1,)),
        lambda x: x.transpose(), lambda x: x.swapaxes(0, 1),
        lambda x: x.flatten(), lambda x: x.reshape(4, 5, 1).squeeze(),
        lambda x: x.expand_dims(0), lambda x: x[0:1].broadcast_to((3, 5)),
        lambda x: x.repeat(2, axis=0), lambda x: x.tile((1, 2)),
        lambda x: x.split(5, axis=1), lambda x: x.sum(axis=1),
        lambda x: x.mean(), lambda x: x.max(axis=0), lambda x: x.min(),
        lambda x: x.prod(axis=1), lambda x: x.std(axis=0),
        lambda x: x.var(ddof=1), lambda x: x.argmax(axis=1),
        lambda x: x.argmin(), lambda x: x.cumsum(axis=0),
        lambda x: x.clip(-0.5, 0.5), lambda x: x.abs(), lambda x: x.exp(),
        lambda x: x.abs().log(), lambda x: x.abs().sqrt(), lambda x: x.sign(),
        lambda x: (x * 3).round(), lambda x: x.dot(x.T), lambda x: x.norm(),
        lambda x: x.take(np.array([0, 2]), axis=1), lambda x: x.astype("int32"),
        lambda x: x.astype("bfloat16"), lambda x: x.copy(),
        lambda x: x.reshape_like(x.T), lambda x: x.broadcast_like(x),
    ]
    for i, f in enumerate(calls):
        if i == 30:
            got = t.take(tmx.np.array(np.array([0, 2], np.int32), device=CPU),
                         axis=1)
            want = j.take(jmx.np.array(np.array([0, 2], np.int32)), axis=1)
        else:
            got, want = f(t), f(j)
        assert_parity(got, want, rtol=1e-5, atol=1e-5, where=f"call {i}")


def test_conversion_and_movement():
    t = tmx.np.array(A, device=CPU)
    assert t.as_in_context(CPU) is t
    assert t.astype("float32", copy=False) is t
    other = tmx.np.zeros((4, 5), dtype="float16", device=CPU)
    t.copyto(other)
    assert other.dtype == np.float16
    np.testing.assert_allclose(other.asnumpy(), A, rtol=1e-3, atol=1e-3)
    c = t.copyto(CPU)
    c[0, 0] = 42.0
    assert t[0, 0].item() != 42.0
    d = t.detach()
    assert not d._t.requires_grad
    # torch functions take NDArrays (and answer with tensors)
    out = torch.add(t, 1)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), A + 1)
    # wrapping a tensor copies nothing
    base = torch.ones(3)
    w = tmx.np.array(base)
    w[0] = 5.0
    assert base[0].item() == 5.0
    t.wait_to_read()
    tmx.waitall()
    assert t.as_np_ndarray() is t and t.as_nd_ndarray() is t


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["list", "dict", "single"])
def test_save_load_cross_both_ways(tmp_path, writer, layout):
    vals = [A, np.arange(6, dtype=np.int32).reshape(2, 3),
            (A > 0).astype(np.bool_)]
    path = str(tmp_path / "arrays.npz")
    pkg = jmx if writer == "jax" else tmx
    arrs = [pkg.np.array(v) if pkg is jmx else pkg.np.array(v, device=CPU)
            for v in vals]
    data = {"list": arrs, "dict": dict(zip("abc", arrs)),
            "single": arrs[0]}[layout]
    pkg.nd.save(path, data)
    jl = jmx.nd.load(path)
    tl = tmx.nd.load(path, device=CPU)
    assert type(jl) is type(tl)
    if isinstance(jl, dict):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            assert_parity(tl[k], jl[k])
    else:
        assert len(jl) == len(tl)
        for g, w in zip(tl, jl):
            assert_parity(g, w)


def test_load_reads_the_jax_packages_bfloat16_file(tmp_path):
    path = str(tmp_path / "bf16.npz")
    jmx.nd.save(path, {"w": jmx.np.array(A, dtype="bfloat16")})
    t = tmx.nd.load(path, device=CPU)["w"]
    assert t.dtype == "bfloat16"
    np.testing.assert_array_equal(
        t.asnumpy(), np.asarray(jmx.np.array(A, dtype="bfloat16").asnumpy(),
                                np.float32))


@pytest.mark.parametrize("shape,reverse", [
    ((0, -1), False), ((-1, 0), False), ((2, 0, -1), False),
    ((0, 5), True), ((-1, 0), True), ((20,), False)])
def test_legacy_nd_reshape_magic_matches_jax(shape, reverse):
    x = R.randn(4, 5, 2).astype(np.float32) if len(shape) == 3 else A
    j, t = jmx.np.array(x), tmx.np.array(x, device=CPU)
    assert_parity(tmx.nd.reshape(t, shape, reverse=reverse),
                  jmx.nd.reshape(j, shape, reverse=reverse))


def test_np_reshape_refuses_a_literal_zero():
    t = tmx.np.array(A, device=CPU)
    with pytest.raises(tmx.MXNetError):
        t.reshape(0, -1)


def test_without_a_card_the_default_device_raises_and_cpu_works():
    assert not torch.cuda.is_available()
    with pytest.raises(tmx.MXNetError):
        tmx.np.array(A)
    with pytest.raises(tmx.MXNetError):
        tmx.np.zeros((2, 2))
    with pytest.raises(tmx.MXNetError):
        tmx.np.random.uniform(size=(2,))
    assert tmx.np.array(A, device=tmx.cpu()).device == tmx.cpu()
    assert tmx.np.array(A, ctx=tmx.cpu()).device == tmx.cpu()
    with tmx.cpu():
        assert tmx.current_device() == tmx.cpu()
        x = tmx.np.ones((2, 2))
        assert x.device == tmx.cpu()
        assert tmx.np.random.uniform(size=(3,)).device == tmx.cpu()
        assert tmx.np.eye(2).device == tmx.cpu()
    assert tmx.current_device() == tmx.gpu(0)
    assert tmx.tpu(0) == tmx.gpu(0) and repr(tmx.tpu(1)) == "gpu(1)"
    assert tmx.num_gpus() == 0
    assert tmx.device_memory_info() == (0, 0, False)
    assert tmx.context.Context is tmx.Device
    with pytest.raises(tmx.MXNetError):
        x.as_in_context(tmx.gpu(0))


def test_engine_surface():
    from incubator_mxnet_tpu_torch import engine
    tmx.engine.stats(reset=True)
    with tmx.cpu():
        x = tmx.np.ones(3)
        (x + 1) * 2
    st = engine.stats()
    assert st["dispatch"] == 2 and st["eager_fallback"] == 2
    with engine.bulk(8):
        assert engine.current_bulk_size() == 8
    prev = engine.set_bulk_size(16)
    assert engine.set_bulk_size(prev) == 16
    engine.waitall()
