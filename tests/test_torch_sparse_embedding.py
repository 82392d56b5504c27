"""PyTorch port: `nn.Embedding(sparse_grad=True)` and the Trainer's
touched-rows update against the JAX package.

The same table (numpy, from a seed) and the same token batches go through
both packages' imperative loop (`record`, backward, `Trainer.step`) for 3
steps that touch different rows, with SGD + momentum + weight decay and
with Adam: only the rows touched since the last update move (untouched
rows get no decay and no momentum aging), as MXNet's lazy update. Then the
touched set itself: accumulated across recorded forwards, untouched by
inference forwards, cleared by an update, by a skipped (stale) gradient
and by a step the loss scaler drops (the port's twin of
tests/test_advice_r4_fixes.py's sparse tests).

Tolerance: float32 on both sides, the same elementwise rules on the same
rows: 1e-6 relative + 1e-6 absolute; untouched rows bit-equal.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon import nn as jnn

from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(1)

V, D = 16, 4
RTOL = ATOL = 1e-6
TOKENS = [np.array([[1, 5], [5, 7]], np.int32),
          np.array([[2, 5, 9]], np.int32),
          np.array([[1, 11]], np.int32)]
OPTIMIZERS = {"sgd": dict(learning_rate=0.3, momentum=0.9, wd=0.1),
              "adam": dict(learning_rate=0.05, wd=0.01)}


def _table(seed=0):
    return np.random.RandomState(seed).randn(V, D).astype(np.float32)


def _coef(tokens, seed=1):
    return np.random.RandomState(seed).randn(*tokens.shape, D).astype(
        np.float32)


def _jax_run(opt, steps):
    emb = jnn.Embedding(V, D, sparse_grad=True)
    emb.initialize()
    emb.weight.set_data(mx.np.array(_table()))
    tr = jgluon.Trainer(emb.collect_params(), opt, dict(OPTIMIZERS[opt]))
    out = []
    for tokens in steps:
        with mx.autograd.record():
            h = emb(mx.np.array(tokens))
            L = (h * mx.np.array(_coef(tokens)) + h ** 2).sum()
        L.backward()
        tr.step(tokens.shape[0])
        out.append(np.array(emb.weight.data().asnumpy()))
    return out


def _param(emb):
    return emb.collect_params()["weight"]


def _port(opt=None):
    emb = tnn.Embedding(V, D, sparse_grad=True).initialize(device="cpu")
    _param(emb).set_data(torch.from_numpy(_table()))
    tr = tgluon.Trainer(emb.collect_params(), opt or "sgd",
                        dict(OPTIMIZERS[opt or "sgd"]))
    return emb, tr


def _port_step(emb, tr, tokens):
    with tautograd.record():
        h = emb(torch.from_numpy(tokens))
        L = (h * torch.from_numpy(_coef(tokens)) + h ** 2).sum()
    tautograd.backward(L)
    tr.step(tokens.shape[0])


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_touched_rows_update_matches_jax(opt):
    want = _jax_run(opt, TOKENS)
    emb, tr = _port(opt)
    w_prev = _table()
    for k, tokens in enumerate(TOKENS):
        _port_step(emb, tr, tokens)
        got = emb.weight.detach().numpy().copy()
        np.testing.assert_allclose(got, want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{opt} step {k}")
        untouched = np.setdiff1d(np.arange(V), tokens)
        np.testing.assert_array_equal(got[untouched], w_prev[untouched])
        assert _param(emb)._last_tokens is None
        w_prev = got


def test_touched_set_accumulates_and_ignores_inference():
    """Two recorded forwards touch the union of their rows; an inference
    forward between backward and step adds nothing."""
    emb, tr = _port()
    a, b = torch.tensor([[1, 2]]), torch.tensor([[6]])
    with tautograd.record():
        L = emb(a).sum() + (emb(b) ** 2).sum()
    assert len(_param(emb)._last_tokens) == 2
    tautograd.backward(L)
    emb(torch.tensor([[9, 10]]))                     # inference forward
    assert len(_param(emb)._last_tokens) == 2
    w0 = emb.weight.detach().clone()
    tr.step(1)
    moved = (emb.weight.detach() != w0).any(dim=1).nonzero().flatten()
    assert moved.tolist() == [1, 2, 6]
    assert _param(emb)._last_tokens is None


def test_touched_set_cleared_when_stale_grad_ignored():
    """An Embedding forwarded under record but not in the loss keeps a
    stale gradient: the step skips it and drops its rows, so the next
    step updates only its own."""
    emb, _ = _port()
    dense = tnn.Dense(3).initialize(device="cpu")
    x = torch.rand(2, 4)
    dense(x)
    params = list(emb.collect_params().values()) + \
        list(dense.collect_params().values())
    tr = tgluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    with tautograd.record():
        emb(torch.tensor([[1, 5]]))
        L = (dense(x) ** 2).sum()
    tautograd.backward(L)
    tr.step(1, ignore_stale_grad=True)
    assert _param(emb)._last_tokens is None
    w1 = emb.weight.detach().clone()
    with tautograd.record():
        L = (emb(torch.tensor([[9, 12]])) ** 2).sum()
    tautograd.backward(L)
    tr.step(1, ignore_stale_grad=True)
    w2 = emb.weight.detach()
    assert torch.equal(w2[[1, 5]], w1[[1, 5]])
    assert not torch.equal(w2[[9, 12]], w1[[9, 12]])


def test_touched_set_cleared_when_a_step_is_dropped():
    """The loss scaler's skipped step (`_mark_consumed`) drops the rows
    with the gradient."""
    emb, tr = _port()
    with tautograd.record():
        L = emb(torch.tensor([[3]])).sum()
    tautograd.backward(L)
    tr._mark_consumed()
    assert _param(emb)._last_tokens is None


def test_embedding_options():
    """dtype and weight_initializer as the JAX package's; the gradient of
    a sparse Embedding stays dense; without sparse_grad nothing is
    recorded."""
    emb = tnn.Embedding(V, D, dtype="bfloat16",
                        weight_initializer=tinit.Constant(0.5),
                        sparse_grad=True).initialize(device="cpu")
    assert emb.weight.dtype == torch.bfloat16
    assert torch.all(emb.weight == 0.5)
    jemb = jnn.Embedding(V, D, sparse_grad=True)
    assert list(emb.collect_params()) == list(jemb.collect_params())
    with tautograd.record():
        L = emb(torch.tensor([[2, 3]])).float().sum()
    tautograd.backward(L)
    g = _param(emb).grad()
    assert g.shape == (V, D) and g.layout == torch.strided
    plain = tnn.Embedding(V, D).initialize(device="cpu")
    with tautograd.record():
        plain(torch.tensor([[2]]))
    assert _param(plain)._last_tokens is None
