"""PyTorch port: out-of-range gathers (ROADMAP C7) and gradients at kinks
(C9) follow the JAX package, on the CPU from the same numpy inputs.

C7: XLA's gathers clamp an index into the axis (a negative one counts from
the end first), and `jnp.take`'s default mode fills an out-of-range
position (NaN for floats, the lowest signed / highest unsigned integer,
True for bool). The port clamps in `NDArray.__getitem__`, `npx.embedding` /
`gluon.nn.Embedding` and the decoder's embedding gathers, and fills in
`np.take`, where PyTorch's index kernels would raise (on the card through
a device-side assert that leaves the context unusable). C9: `jax.grad`
gives 0.5 at a bound of `clip` and 1 at 0 of `abs`. Values are exact
(gathers) or within 1e-6 (float32 arithmetic); the engine is token-exact.
The C8 dtype cases are in `test_torch_np_ops.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import serve

from torch_port_utils import CFG, assert_parity, decoders

torch.set_num_threads(1)

CPU = tmx.cpu()
A = np.arange(6, dtype=np.float32).reshape(2, 3)


def _pair(a):
    return jmx.np.array(a), tmx.np.array(a, device=CPU)


# ---------------------------------------------------------------------------
# C7: gathers
# ---------------------------------------------------------------------------
KEYS = {
    "array-past-end": lambda m: m.np.array(np.array([5], np.int32)),
    "array-negative": lambda m: m.np.array(np.array([-5, -1], np.int32)),
    "list": lambda m: [5],
    "numpy": lambda m: np.array([7, -9]),
    "int": lambda m: 5,
    "negative-int": lambda m: -5,
    "second-axis": lambda m: (slice(None), m.np.array(np.array([7, -9],
                                                               np.int32))),
    "ellipsis": lambda m: (Ellipsis, 7),
    "newaxis": lambda m: (None, 1, -9),
    "2-d-index": lambda m: m.np.array(np.array([[0, 9], [-1, 1]], np.int32)),
    "in-range": lambda m: m.np.array(np.array([1, 0], np.int32)),
}


@pytest.mark.parametrize("key", sorted(KEYS))
def test_getitem_clamps_out_of_range_indices_as_jax(key):
    j, t = _pair(A)
    with tmx.cpu():
        got = t[KEYS[key](tmx)]
    assert_parity(got, j[KEYS[key](jmx)])


# An Ellipsis before an integer array: the array indexes one axis whatever
# its rank, so the Ellipsis spans the rest and each index is clamped against
# its own axis (in-range indices come back unchanged).
ELLIPSIS_KEYS = {
    "2-d-array": ((3, 10), lambda m: (
        Ellipsis, m.np.array(np.array([[7, 9]], np.int32)))),
    "2-d-numpy": ((3, 10), lambda m: (Ellipsis, np.array([[7, 9], [-1, 12]]))),
    "0-d-array-then-slice": ((3, 10, 4), lambda m: (
        Ellipsis, m.np.array(np.array(7, np.int32)), slice(None))),
    "2-d-array-then-slice": ((3, 10, 4), lambda m: (
        Ellipsis, m.np.array(np.array([[7, 12], [-1, -13]], np.int32)),
        slice(None))),
}


@pytest.mark.parametrize("key", sorted(ELLIPSIS_KEYS))
def test_getitem_ellipsis_before_array_index_as_jax(key):
    shape, make = ELLIPSIS_KEYS[key]
    j, t = _pair(np.arange(np.prod(shape), dtype=np.float32).reshape(shape))
    with tmx.cpu():
        got = t[make(tmx)]
    assert_parity(got, j[make(jmx)])


# C10: an int and an array index apart from each other (a slice, an
# Ellipsis or None between them): numpy counts the int among the advanced
# indices, which, being apart, put their broadcast axes first; adjacent ones
# keep their place. Keys and their mirror images, on a (3, 10, 4) array.
APART_KEYS = {
    "int-ellipsis-array": lambda m: (
        0, Ellipsis, m.np.array(np.array([[1, 2]], np.int32))),
    "int-slice-array": lambda m: (
        0, slice(None), m.np.array(np.array([[1, 2]], np.int32))),
    "int-none-array": lambda m: (
        0, None, m.np.array(np.array([1, 3], np.int32))),
    "int-slice-numpy-past-end": lambda m: (
        1, slice(None), np.array([3, -1, 9])),
    "array-ellipsis-int": lambda m: (
        m.np.array(np.array([[1, 2]], np.int32)), Ellipsis, 0),
    "array-slice-int": lambda m: (
        m.np.array(np.array([[1, 2]], np.int32)), slice(None), 0),
    "array-none-int": lambda m: (
        m.np.array(np.array([2, 0], np.int32)), None, slice(None), 3),
    "slice-int-array": lambda m: (
        slice(None), 0, m.np.array(np.array([[1, 2]], np.int32))),
    "array-int-slice": lambda m: (
        m.np.array(np.array([[1, 2]], np.int32)), 0, slice(None)),
}
A3 = np.arange(120, dtype=np.float32).reshape(3, 10, 4)


@pytest.mark.parametrize("key", sorted(APART_KEYS))
def test_getitem_int_apart_from_array_index_as_jax(key):
    j, t = _pair(A3)
    with tmx.cpu():
        got = t[APART_KEYS[key](tmx)]
    assert_parity(got, j[APART_KEYS[key](jmx)])


@pytest.mark.parametrize("key", sorted(k for k in APART_KEYS
                                       if "past-end" not in k))
def test_setitem_int_apart_from_array_index_as_jax(key):
    # the same keys already write the same elements; this pins them
    j, t = _pair(A3)
    with tmx.cpu():
        t[APART_KEYS[key](tmx)] = -1.0
    j[APART_KEYS[key](jmx)] = -1.0
    assert_parity(t, j)


TAKE = {
    "float": (A, [0, 7, -1, -7], {}),
    "int32": (A.astype(np.int32), [0, 7, -2], {}),
    "int8": (A.astype(np.int8), [9, 1], {}),
    "uint8": (A.astype(np.uint8), [0, 7], {}),
    "bool": (A > 2, [0, 7], {}),
    "axis1": (A, [0, 7, -4], {"axis": 1}),
    "clip": (A, [0, 7, -9], {"mode": "clip"}),
    "wrap": (A, [0, 7, -9], {"mode": "wrap"}),
    "2-d-indices": (A, [[0, 9], [-1, 3]], {"axis": 1}),
}


@pytest.mark.parametrize("case", sorted(TAKE))
def test_take_fills_out_of_range_positions_as_jax(case):
    a, idx, kw = TAKE[case]
    idx = np.asarray(idx, np.int32)
    want = jmx.np.take(jmx.np.array(a), jmx.np.array(idx), **kw)
    got = tmx.np.take(tmx.np.array(a, device=CPU),
                      tmx.np.array(idx, device=CPU), **kw)
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_embedding_clamps_ids_as_jax():
    w = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    ids = np.array([[0, 7], [-1, 2]], np.int32)
    jemb = jmx.gluon.nn.Embedding(4, 3)
    jemb.initialize()
    jemb.weight.set_data(jmx.np.array(w))
    temb = tmx.gluon.nn.Embedding(4, 3).initialize(device="cpu")
    tmx.gluon.params_from_jax(temb, {"weight": w})
    want = jemb(jmx.np.array(ids))
    assert_parity(temb(tmx.np.array(ids, device=CPU)), want)
    assert_parity(tmx.npx.embedding(tmx.np.array(ids, device=CPU),
                                    tmx.np.array(w, device=CPU)), want)


def test_sparse_embedding_update_takes_the_clamped_rows():
    """An id past the vocabulary reads (and so updates) the last row; the
    Trainer's touched-row update must not index past the table."""
    emb = tmx.gluon.nn.Embedding(5, 2, sparse_grad=True).initialize(
        device="cpu")
    (param,) = emb.collect_params().values()
    before = param.data().clone()
    tr = tmx.gluon.Trainer(emb.collect_params(), "sgd",
                           {"learning_rate": 1.0})
    ids = torch.tensor([[0, 9]])
    with tmx.autograd.record():
        loss = emb(ids).sum()
    loss.backward()
    tr.step(1)
    after = param.data()
    moved = [i for i in range(5) if not torch.equal(after[i], before[i])]
    assert moved == [0, 4]


def test_decoder_serves_a_prompt_token_past_the_vocabulary_as_jax():
    """A prompt token >= vocab reads the last embedding row in both
    packages: `reference_generate` is token-exact against the JAX
    package's, the engine answers it, and the next request is served."""
    jm, tm = decoders()
    bad = [3, CFG["vocab"] + 5, 7, 11]
    good = [5, 9, 2]
    want = jm.reference_generate(bad, 6, window=16)
    np.testing.assert_array_equal(tm.reference_generate(bad, 6, window=16),
                                  want)
    with serve.ContinuousEngine(tm, max_slots=2, decode_steps=2,
                                prefill_window=16) as eng:
        got = eng.submit(bad, 6).result(timeout=120)
        nxt = eng.submit(good, 5).result(timeout=120)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nxt, jm.reference_generate(good, 5,
                                                             window=16))


# ---------------------------------------------------------------------------
# C9: gradients at kinks
# ---------------------------------------------------------------------------
X = np.array([[1.5, -2, 3], [4, 0, -6.5]], np.float32)

KINKS = {
    "clip": (lambda m, v: m.np.clip(v, -2, 3),
             lambda v: jnp.clip(v, -2, 3)),
    "clip-method": (lambda m, v: v.clip(-2, 3),
                    lambda v: jnp.clip(v, -2, 3)),
    "clip-lower-only": (lambda m, v: m.np.clip(v, 0, None),
                        lambda v: jnp.clip(v, 0, None)),
    "clip-point": (lambda m, v: m.np.clip(v, 0, 0),
                   lambda v: jnp.clip(v, 0, 0)),
    "abs": (lambda m, v: m.np.abs(v), jnp.abs),
    "absolute": (lambda m, v: m.np.absolute(v), jnp.abs),
    "abs-operator": (lambda m, v: abs(v), jnp.abs),
    "sqrt-abs": (lambda m, v: m.np.sqrt(m.np.abs(v)),
                 lambda v: jnp.sqrt(jnp.abs(v))),
}


@pytest.mark.parametrize("name", sorted(KINKS))
def test_gradient_at_kinks_follows_jax_grad(name):
    port_fn, jax_fn = KINKS[name]
    want = np.asarray(jax.grad(lambda v: jax_fn(v).sum())(X))
    with tmx.cpu():
        x = tmx.np.array(X)
        x.attach_grad()
        with tmx.autograd.record():
            y = port_fn(tmx, x).sum()
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-6, atol=0)
    # and the JAX package's own ops agree with jax.grad
    jx = jmx.np.array(X)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = port_fn(jmx, jx).sum()
    jy.backward()
    np.testing.assert_allclose(jx.grad.asnumpy(), want, rtol=1e-6, atol=0)


def test_clip_with_bounds_that_take_a_gradient_splits_ties_as_jax():
    lo = np.array([-2.0, 0.5, 3.0], np.float32)
    want = jax.grad(lambda v, b: jnp.clip(v, b, 3.0).sum(),
                    argnums=(0, 1))(X, lo)
    with tmx.cpu():
        x, b = tmx.np.array(X), tmx.np.array(lo)
        x.attach_grad()
        b.attach_grad()
        with tmx.autograd.record():
            y = tmx.np.clip(x, b, 3.0).sum()
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(want[0]))
    np.testing.assert_allclose(b.grad.asnumpy(), np.asarray(want[1]))
