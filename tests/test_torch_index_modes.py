"""PyTorch port: out-of-range indices in gathers that fill (ROADMAP C14)
and in scatters that drop (C15), held against the JAX package on the CPU
from the same numpy inputs.

C14: the JAX package's `take_along_axis` runs in XLA's fill mode: an index
with -n <= i < 0 counts from the end, and any other index outside [0, n)
reads NaN for a float type or the lowest value of a signed integer type,
with a zero gradient. The port's sites (`np.take_along_axis`,
`npx.sequence_reverse`, the flagship LM's `loss_fn`, `CTCLoss`) take the
one helper `ops.nn.take_fill`. C15: `.at[key].set` and `put_along_axis`
drop an update whose index is out of range after the wrap; the port's
`NDArray.__setitem__` (also `+=`) and `np.put_along_axis` mask those
positions out. Gathers and scatters are exact (equal arrays, NaN where
NaN); the LM and CTC losses are float32 arithmetic in another order
(relative 1e-5); bfloat16 values are the same bfloat16 numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.models import transformer as J
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.models import transformer as T
from incubator_mxnet_tpu_torch.ops import nn as tnn

from torch_port_utils import (expire_port_trace_memo, process_state_kept)

torch.set_num_threads(1)

CPU = tmx.cpu()
DTYPES = ("float32", "bfloat16", "int32")


@pytest.fixture(autouse=True)
def _fresh_port_trace_env_memo():
    expire_port_trace_memo()
    yield
    expire_port_trace_memo()


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    with process_state_kept():
        yield


def _pair(a, dtype):
    return (jmx.np.array(a, dtype=dtype),
            tmx.np.array(a, dtype=dtype, device=CPU))


def _host(x):
    """numpy view of either package's array (bfloat16 as float32)."""
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same(got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# C14: gathers in fill mode
# ---------------------------------------------------------------------------
A = np.arange(6, dtype=np.float32).reshape(2, 3)
TAKE = {
    "past-end": ([[0], [5]], 1),
    "negative": ([[-1], [-5]], 1),
    "axis-none": ([1, 9], None),
    "both-ends-2d": ([[2, -4], [3, -3]], 1),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(TAKE))
def test_take_along_axis_fills_as_jax(case, dtype):
    idx, axis = TAKE[case]
    ja, ta = _pair(A, dtype)
    want = jmx.np.take_along_axis(ja, jmx.np.array(idx, dtype="int32"),
                                  axis=axis)
    got = tmx.np.take_along_axis(ta, tmx.np.array(idx, dtype="int32",
                                                  device=CPU), axis=axis)
    assert str(got.dtype) == str(want.dtype)
    _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_take_along_an_empty_axis_reads_zeros_as_jax(dtype):
    a = np.zeros((2, 0), np.float32)
    idx = np.array([[1], [0]], np.int32)
    want = jmx.np.take_along_axis(jmx.np.array(a, dtype=dtype),
                                  jmx.np.array(idx), axis=1)
    got = tmx.np.take_along_axis(tmx.np.array(a, dtype=dtype, device=CPU),
                                 tmx.np.array(idx, device=CPU), axis=1)
    _same(got, want)


def test_roadmap_values_of_take_along_axis():
    t = tmx.np.array(A, device=CPU)
    i = tmx.np.array([[0], [5]], dtype="int32", device=CPU)
    got = tmx.np.take_along_axis(t, i, axis=1).asnumpy()
    assert got[0, 0] == 0 and np.isnan(got[1, 0])
    ti = tmx.np.take_along_axis(t.astype("int32"), i, axis=1).asnumpy()
    assert ti[1, 0] == np.iinfo(np.int32).min


@pytest.mark.parametrize("mode", ["clip", "fill"])
def test_take_along_axis_named_modes_as_jax(mode):
    idx = np.array([[0, 5], [-4, 2]], np.int32)
    want = jnp.take_along_axis(jnp.asarray(A), jnp.asarray(idx), axis=1,
                               mode=mode)
    got = tmx.np.take_along_axis(tmx.np.array(A, device=CPU),
                                 tmx.np.array(idx, device=CPU), axis=1,
                                 mode=mode)
    _same(got, np.asarray(want))


@pytest.mark.parametrize("idx", [[[0], [5]], [[2, -4], [7, -1]]])
def test_filled_positions_have_zero_gradient_as_jax_grad(idx):
    idx = np.asarray(idx, np.int32)
    want = jax.grad(lambda a: jnp.nansum(
        jnp.take_along_axis(a, jnp.asarray(idx), axis=1) ** 2))(
            jnp.asarray(A))
    x = torch.tensor(A, requires_grad=True)
    torch.nansum(tnn.take_fill(x, torch.from_numpy(idx), 1) ** 2).backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


X3 = np.arange(12, dtype=np.float32).reshape(3, 2, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", [[5, 1], [3, 2], [0, 4]])
def test_sequence_reverse_fills_as_jax(lengths, dtype):
    jx, tx = _pair(X3, dtype)
    lens = np.asarray(lengths, np.int32)
    want = jmx.npx.sequence_reverse(jx, jmx.np.array(lens),
                                    use_sequence_length=True)
    got = tmx.npx.sequence_reverse(tx, tmx.np.array(lens, device=CPU),
                                   use_sequence_length=True)
    _same(got, want)


def test_roadmap_values_of_sequence_reverse():
    got = tmx.npx.sequence_reverse(
        tmx.np.array(X3, device=CPU),
        tmx.np.array([5, 1], dtype="int32", device=CPU),
        use_sequence_length=True).asnumpy()
    assert np.isnan(got[:2, 0]).all() and np.isfinite(got[2, 0]).all()


LM = dict(vocab_size=50, num_layers=1, d_model=16, num_heads=2, d_ff=32,
          max_seq_len=16)


def _lm_pair():
    cfgj = J.TransformerConfig(**LM, dtype="float32")
    cfgt = T.TransformerConfig(**LM, dtype="float32")
    pj = J.init_params(jax.random.PRNGKey(0), cfgj)
    pt = T.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfgj, cfgt, pj, pt


@pytest.mark.parametrize("last", [4, 60, -3, -51])
def test_lm_loss_fills_an_id_outside_the_vocabulary_as_jax(last):
    cfgj, cfgt, pj, pt = _lm_pair()
    toks = np.array([[1, 2, 3, 4, last]], np.int32)
    want = float(J.loss_fn(pj, {"tokens": jnp.asarray(toks)}, cfgj))
    got = float(T.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, cfgt))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, rel=1e-5)
    if last == -3:
        assert got == pytest.approx(3.9445, abs=5e-4)


CTC_LOGITS = np.random.RandomState(0).randn(2, 5, 4).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("labels", [[[1, 2], [3, 7]], [[1, 2], [3, -3]],
                                    [[1, 2], [3, 1]]])
def test_ctc_fills_a_label_outside_the_classes_as_jax(labels, dtype):
    labels = np.asarray(labels, np.int32)
    jl = jmx.np.array(CTC_LOGITS, dtype=dtype)
    jl.attach_grad()
    with jmx.autograd.record():
        jout = jgluon.loss.CTCLoss()(jl, jmx.np.array(labels))
    jout.backward()
    tl = torch.tensor(CTC_LOGITS).to(getattr(torch, dtype)) \
        .requires_grad_()
    with tautograd.record():
        tout = tgluon.loss.CTCLoss()(tl, torch.from_numpy(labels))
    tout.backward(torch.ones_like(tout))
    want, got = _host(jout), _host(tout.detach())
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # a row whose loss is NaN passes NaN back, in both packages
    np.testing.assert_allclose(_host(tl.grad), _host(jl.grad), rtol=tol,
                               atol=tol)
    if dtype == "float32" and labels[1, 1] == 7:
        assert got[0] == pytest.approx(3.8970, abs=5e-4)
        assert np.isnan(got[1])
    if dtype == "float32" and labels[1, 1] == -3:
        assert got[1] == pytest.approx(4.6014, abs=5e-4)


# ---------------------------------------------------------------------------
# C15: scatters drop an out-of-range update
# ---------------------------------------------------------------------------
def _setitem_cases():
    return {
        "past-end": (np.arange(6), lambda m: m.np.array([1, 8]), 9, "set"),
        "before-start": (np.arange(6), lambda m: m.np.array([1, -8]), 9,
                         "set"),
        "wraps": (np.arange(6), lambda m: m.np.array([-1, 2]), 9, "set"),
        "iadd-duplicates": (np.arange(6), lambda m: m.np.array([1, 1, 8]),
                            1, "iadd"),
        "row-and-int": (np.arange(6).reshape(2, 3),
                        lambda m: (m.np.array([0, 4]), 1), 7, "set"),
        "row-slice": (np.arange(6).reshape(2, 3),
                      lambda m: (m.np.array([5, -1]), slice(None)), 4,
                      "set"),
        "columns-array-value": (np.arange(6).reshape(2, 3),
                                lambda m: (slice(None), m.np.array([0, 4])),
                                np.array([[1, 2], [3, 4]]), "set"),
        "apart-arrays": (np.arange(24).reshape(2, 3, 4),
                         lambda m: (m.np.array([0, 4]), slice(None),
                                    m.np.array([1, -1])),
                         np.arange(6).reshape(2, 3), "set"),
        "in-range": (np.arange(6).reshape(2, 3),
                     lambda m: (m.np.array([1, 0]), m.np.array([2, -3])),
                     5, "set"),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_setitem_cases()))
def test_setitem_drops_out_of_range_writes_as_jax(case, dtype):
    base, key, value, op = _setitem_cases()[case]
    j, t = _pair(base, dtype)
    jv = jmx.np.array(value, dtype=dtype) \
        if isinstance(value, np.ndarray) else value
    tv = tmx.np.array(value, dtype=dtype, device=CPU) \
        if isinstance(value, np.ndarray) else value
    jk = key(jmx)
    with tmx.cpu():
        tk = key(tmx)
    if op == "iadd":
        j[jk] += jv
        t[tk] += tv
    else:
        j[jk] = jv
        t[tk] = tv
    _same(t, j)


def test_roadmap_values_of_setitem():
    a = tmx.np.arange(6, dtype="float32", device=CPU)
    a[tmx.np.array([1, 8], device=CPU)] = 9
    np.testing.assert_array_equal(a.asnumpy(), [0, 9, 2, 3, 4, 5])
    a = tmx.np.arange(6, dtype="float32", device=CPU)
    a[tmx.np.array([1, 1, 8], device=CPU)] += 1
    np.testing.assert_array_equal(a.asnumpy(), [0, 2, 2, 3, 4, 5])


PUT = {
    "past-end": ([[0], [5]], 1),
    "negative": ([[-1], [-5]], 1),
    "rows": ([[0, 2, 1]], 0),
    "rows-out": ([[0, 3, -3]], 0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(PUT))
def test_put_along_axis_drops_as_jax(case, dtype):
    idx, axis = PUT[case]
    idx = np.asarray(idx, np.int32)
    want = jnp.put_along_axis(jnp.asarray(A, dtype=dtype), jnp.asarray(idx),
                              9, axis=axis, inplace=False)
    t = tmx.np.array(A, dtype=dtype, device=CPU)
    got = tmx.np.put_along_axis(t, tmx.np.array(idx, device=CPU), 9,
                                axis=axis)
    _same(got, np.asarray(want))
    _same(t, np.asarray(want))
