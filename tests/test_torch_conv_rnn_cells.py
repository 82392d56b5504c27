"""PyTorch port: the conv recurrent cells (`gluon.rnn.Conv{1,2,3}D{RNN,
LSTM,GRU}Cell`) against the JAX package.

The four cases of `tests/test_conv_rnn_cells.py`, each held against the
JAX package with the same values (`gluon.params_from_jax`; conv gate
weights (G C, C_in, *kernel) in both): the shapes across ranks with one
step's outputs, states and gradients; one conv-LSTM step against a
hand-rolled NumPy step too; a conv-GRU unrolled over time with its
gradients; the rank check's error. Each step's gates are the port's
convolutions, its elementwise part the recurrent cell kernel's plain
version on the CPU (the gates of a step, channels-first, are the kernel's
(N, G H) rows). float32, 2e-5 relative + 2e-5 absolute (XLA's and
PyTorch's CPU convolutions sum in other orders).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import rnn

from torch_port_utils import (assert_recorded_close, recorded,
                              recurrent_pair)

torch.set_num_threads(1)

CPU = tmx.cpu()
RTOL, ATOL = 2e-5, 2e-5


def _arr(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _step(blk, nds):
    out, states = blk(nds[0], list(nds[1:]))
    return [out] + list(states)


@pytest.mark.parametrize("cls,nd,ns", [
    ("Conv1DRNNCell", 1, 1), ("Conv2DRNNCell", 2, 1),
    ("Conv3DRNNCell", 3, 1), ("Conv1DLSTMCell", 1, 2),
    ("Conv2DLSTMCell", 2, 2), ("Conv3DLSTMCell", 3, 2),
    ("Conv1DGRUCell", 1, 1), ("Conv2DGRUCell", 2, 1),
    ("Conv3DGRUCell", 3, 1),
])
def test_shapes_all_ranks_as_jax(cls, nd, ns):
    spatial = (6,) * nd if nd < 3 else (4,) * nd
    jblk, tblk = recurrent_pair(lambda r: getattr(r, cls)((3,) + spatial, 5))
    states = tblk.begin_state(2)
    assert len(states) == ns
    arrays = [_arr(2, 3, *spatial)] + [_arr(2, 5, *spatial, seed=1 + k)
                                       for k in range(ns)]
    got = recorded(True, tblk, _step, arrays)
    want = recorded(False, jblk, _step, arrays)
    assert_recorded_close(got, want, RTOL, ATOL)
    assert got[0][0].shape == (2, 5) + spatial
    for s in got[0][1:]:
        assert s.shape == (2, 5) + spatial


def test_conv_lstm_matches_manual_and_jax():
    """One step against a hand-rolled NumPy conv-LSTM (gate order
    i, f, g, o) and against the JAX package."""
    from scipy import signal
    jblk, tblk = recurrent_pair(
        lambda r: r.Conv2DLSTMCell((1, 5, 5), 1, i2h_kernel=3, h2h_kernel=3))
    rng = np.random.RandomState(1)
    x = rng.randn(1, 1, 5, 5).astype(np.float32)
    h0 = rng.randn(1, 1, 5, 5).astype(np.float32)
    c0 = rng.randn(1, 1, 5, 5).astype(np.float32)
    nd = lambda a: tmx.np.array(a, device=CPU)  # noqa: E731
    out, (h, c) = tblk(nd(x), [nd(h0), nd(c0)])
    p = {n: v.data().detach().numpy()
         for n, v in tblk.collect_params().items()}
    wi, wh, bi, bh = (p["i2h_weight"], p["h2h_weight"], p["i2h_bias"],
                      p["h2h_bias"])

    def conv(img, k):   # SAME cross-correlation
        return signal.correlate2d(img, k, mode="same")

    gates = np.stack([
        conv(x[0, 0], wi[g, 0]) + bi[g] + conv(h0[0, 0], wh[g, 0]) + bh[g]
        for g in range(4)])
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    i, f, g_, o = sig(gates[0]), sig(gates[1]), np.tanh(gates[2]), \
        sig(gates[3])
    c_ref = f * c0[0, 0] + i * g_
    h_ref = o * np.tanh(c_ref)
    np.testing.assert_allclose(c.asnumpy()[0, 0], c_ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h.asnumpy()[0, 0], h_ref, rtol=1e-4,
                               atol=1e-5)
    got = recorded(True, tblk, _step, [x, h0, c0])
    want = recorded(False, jblk, _step, [x, h0, c0])
    assert_recorded_close(got, want, RTOL, ATOL)


def test_unroll_and_grad_as_jax():
    jblk, tblk = recurrent_pair(lambda r: r.Conv2DGRUCell((2, 4, 4), 3))
    seq = _arr(2, 5, 2, 4, 4, seed=2)

    def call(blk, nds):
        merged, states = blk.unroll(5, nds[0], layout="NTC")
        return [merged] + list(states)

    got = recorded(True, tblk, call, [seq])
    want = recorded(False, jblk, call, [seq])
    assert_recorded_close(got, want, RTOL, ATOL)
    assert got[0][0].shape == (2, 5, 3, 4, 4)
    assert float(np.abs(got[2]["i2h_weight"]).sum()) > 0


def test_bad_input_shape_raises():
    for m in (jmx, tmx):
        with pytest.raises(m.MXNetError, match="input_shape"):
            m.gluon.rnn.Conv2DLSTMCell((3, 8), 4)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "softrelu", "softsign",
                                 "log_sigmoid"])
@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_activations_as_jax(kind, act):
    """Every activation the cell kernel takes, in each conv cell, one step
    with its gradients, against the JAX package's `npx.activation`."""
    ns = 2 if kind == "LSTM" else 1
    jblk, tblk = recurrent_pair(
        lambda r: getattr(r, f"Conv1D{kind}Cell")((2, 6), 3, activation=act))
    arrays = [_arr(2, 2, 6)] + [_arr(2, 3, 6, seed=1 + k) for k in range(ns)]
    assert_recorded_close(recorded(True, tblk, _step, arrays),
                          recorded(False, jblk, _step, arrays), RTOL, ATOL)


def test_mish_raises():
    """mish, whose derivative is not a function of its output, is the one
    activation the cell kernel does not take: it raises on every device."""
    with pytest.raises(tmx.MXNetError, match="activations"):
        rnn.Conv1DRNNCell((2, 6), 3, activation="mish")
