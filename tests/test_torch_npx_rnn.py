"""PyTorch port: `npx.rnn`, the fused RNN over the reference's flat
parameter vector, against the JAX package's `npx.rnn`.

The cases of `tests/test_npx_rnn.py`: the flat vector packed from a
`torch.nn.LSTM` / `GRU` / `RNN` (all W_i2h / W_h2h gate blocks layer-major,
direction inner, then all b_i2h / b_h2h pairs), the same data and states
through both packages; the output and the returned states (and the
gradients of the flat vector, the data and the states) must agree, float32,
1e-5 relative + 2e-6 absolute (products summed in other orders). Plus the
size check's error, the LSTM's required cell state, and dropout between
layers in training only (the port's generator: scaling and rule, not the
JAX package's masks).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from torch_port_utils import parity

torch.set_num_threads(1)

CPU = tmx.cpu()
T, N, C, H = 5, 3, 6, 4
RTOL, ATOL = 1e-5, 2e-6


def _flat_params(tmod, num_layers, bidirectional):
    D = 2 if bidirectional else 1
    ws, bs = [], []
    for layer in range(num_layers):
        for d in range(D):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            ws.append(getattr(tmod, f"weight_ih{sfx}").detach().numpy()
                      .ravel())
            ws.append(getattr(tmod, f"weight_hh{sfx}").detach().numpy()
                      .ravel())
    for layer in range(num_layers):
        for d in range(D):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            bs.append(getattr(tmod, f"bias_ih{sfx}").detach().numpy())
            bs.append(getattr(tmod, f"bias_hh{sfx}").detach().numpy())
    return np.concatenate(ws + bs).astype(np.float32)


def _torch_module(mode, L, bi):
    torch.manual_seed(3)
    kind = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU,
            "rnn_tanh": lambda *a, **k: torch.nn.RNN(
                *a, nonlinearity="tanh", **k),
            "rnn_relu": lambda *a, **k: torch.nn.RNN(
                *a, nonlinearity="relu", **k)}[mode]
    return kind(C, H, num_layers=L, bidirectional=bi)


def _inputs(mode, L, bi):
    D = 2 if bi else 1
    x = np.random.RandomState(0).randn(T, N, C).astype(np.float32)
    h0 = np.random.RandomState(1).randn(L * D, N, H).astype(np.float32)
    c0 = np.random.RandomState(2).randn(L * D, N, H).astype(np.float32)
    flat = _flat_params(_torch_module(mode, L, bi), L, bi)
    return x, flat, h0, c0


CASES = [("lstm", 1, False), ("lstm", 2, False), ("lstm", 2, True),
         ("gru", 2, True), ("rnn_tanh", 1, False), ("rnn_relu", 2, False),
         ("gru", 1, False), ("rnn_tanh", 2, True)]


@pytest.mark.parametrize("mode,L,bi", CASES)
def test_npx_rnn_as_jax(mode, L, bi):
    x, flat, h0, c0 = _inputs(mode, L, bi)

    def call(m, x, flat, h0, c0):
        return m.npx.rnn(x, flat, h0,
                         state_cell=c0 if mode == "lstm" else None,
                         mode=mode, state_size=H, num_layers=L,
                         bidirectional=bi, state_outputs=True)

    got = parity(lambda *a: call(jmx, *a), lambda *a: call(tmx, *a),
                 x, flat, h0, c0, rtol=RTOL, atol=ATOL, grad=True)
    assert got[0].shape == (T, N, H * (2 if bi else 1))
    assert len(got) == (3 if mode == "lstm" else 2)


@pytest.mark.parametrize("mode,L,bi", CASES[:6])
def test_npx_rnn_matches_torch(mode, L, bi):
    """The port's npx.rnn equals torch.nn's module on the same weights
    (the reference's gate orders and flat layout)."""
    x, flat, h0, c0 = _inputs(mode, L, bi)
    tmod = _torch_module(mode, L, bi)
    with torch.no_grad():
        if mode == "lstm":
            want, (hn, cn) = tmod(torch.tensor(x),
                                  (torch.tensor(h0), torch.tensor(c0)))
        else:
            want, hn = tmod(torch.tensor(x), torch.tensor(h0))
    nd = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    out = tmx.npx.rnn(nd(x), nd(flat), nd(h0),
                      state_cell=nd(c0) if mode == "lstm" else None,
                      mode=mode, state_size=H, num_layers=L,
                      bidirectional=bi, state_outputs=True)
    np.testing.assert_allclose(out[0].asnumpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[1].asnumpy(), hn.numpy(), rtol=1e-4,
                               atol=1e-5)
    if mode == "lstm":
        np.testing.assert_allclose(out[2].asnumpy(), cn.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_npx_rnn_differentiable():
    x, flat, h0, c0 = _inputs("lstm", 1, False)
    nd = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    f = nd(flat)
    f.attach_grad()
    with tmx.autograd.record():
        out = tmx.npx.rnn(nd(x), f, nd(np.zeros_like(h0)),
                          state_cell=nd(np.zeros_like(c0)), mode="lstm",
                          state_size=H, num_layers=1)
        L = (out ** 2).sum()
    L.backward()
    g = f.grad.asnumpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def _size_error(m, nd, flat):
    x, _, h0, _ = _inputs("gru", 2, True)
    with pytest.raises(Exception) as err:
        m.npx.rnn(nd(x), nd(flat), nd(h0), mode="gru", state_size=H,
                  num_layers=2, bidirectional=True)
    return err.value


def test_npx_rnn_size_check_as_jax():
    """A flat vector longer than the layout raises `MXNetError` with the
    JAX package's message; a shorter one too in the port (the JAX package
    raises its reshape's TypeError there)."""
    flat = _inputs("gru", 2, True)[1]
    port = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    long_ = np.concatenate([flat, np.zeros(4, np.float32)])
    want = _size_error(jmx, jmx.np.array, long_)
    got = _size_error(tmx, port, long_)
    assert isinstance(want, jmx.MXNetError)
    assert isinstance(got, tmx.MXNetError)
    assert str(got).split("parameters has")[-1] == \
        str(want).split("parameters has")[-1]
    assert f"has {flat.size + 4} elements" in str(got)
    short = flat[:-3]
    assert isinstance(_size_error(jmx, jmx.np.array, short), TypeError)
    got = _size_error(tmx, port, short)
    assert isinstance(got, tmx.MXNetError)
    assert f"has {flat.size - 3} elements" in str(got) \
        and f"layout needs {flat.size}" in str(got)


def test_npx_rnn_argument_errors():
    x, flat, h0, _ = _inputs("lstm", 1, False)
    nd = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    with pytest.raises(tmx.MXNetError, match="state_cell"):
        tmx.npx.rnn(nd(x), nd(flat), nd(h0), mode="lstm", state_size=H)
    with pytest.raises(tmx.MXNetError, match="state_size"):
        tmx.npx.rnn(nd(x), nd(flat), nd(h0), mode="gru")
    with pytest.raises(tmx.MXNetError, match="mode"):
        tmx.npx.rnn(nd(x), nd(flat), nd(h0), mode="lstmp", state_size=H)


def test_npx_rnn_dropout_in_training_only():
    x, flat, h0, _ = _inputs("gru", 2, False)
    nd = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    tmx.random.seed(2)

    def run(p):
        return tmx.npx.rnn(nd(x), nd(flat), nd(h0), mode="gru",
                           state_size=H, num_layers=2, p=p).asnumpy()
    base = run(0.0)
    np.testing.assert_array_equal(run(0.5), base)        # inference
    with tmx.autograd.train_mode():
        a, b = run(0.5), run(0.5)
        np.testing.assert_array_equal(run(0.0), base)
    assert not np.allclose(a, base) and not np.array_equal(a, b)
