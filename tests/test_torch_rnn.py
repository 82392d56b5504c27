"""PyTorch port: `gluon.rnn` (the cells, the modifier cells, `unroll` and
the fused RNN / LSTM / GRU layers) against the JAX package.

Each net is built in both packages with the same arguments; the JAX net's
values are set from numpy (made from a seed) and carried into the port's
with `gluon.params_from_jax`. The same numpy inputs go through both under
`record()`; the outputs, the inputs' gradients and every parameter's
gradient of sum_k (out_k * w_k) (w_k from numpy) must agree. float32 on
both sides, 2e-5 relative + 2e-5 absolute: XLA's and PyTorch's CPU
products sum in other orders, and the port's input product of a fused
layer adds the bias before the recurrent product (the JAX package after).
On the CPU a cell step runs the cell kernel's plain version (`ops.rnn.
cell_fwd_ref` / `cell_bwd_ref`), a fused layer the layer kernels' on the
route `kernels.rnn_layer_route` names (`layer_fwd_ref` / `layer_bwd_ref`).

Dropout draws from each package's own generator, so the masks differ:
parity runs at rate 0, and the rate > 0 tests check the port's scaling
and its training-only rule. The first nine tests are the cases of
`tests/test_rnn.py` run in the port.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon import rnn
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import (assert_recorded_close, recorded,
                              recurrent_pair)

torch.set_num_threads(1)

CPU = tmx.cpu()
RTOL, ATOL = 2e-5, 2e-5


def _arr(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nd(a):
    return tmx.np.array(a, device=CPU)


def _parity(make, call, arrays, resolve=True):
    """Build the pair (resolving deferred shapes with `call` on the JAX
    side) and hold the recorded runs of both against each other."""
    res = (lambda j: call(j, [jmx.np.array(a) for a in arrays])) \
        if resolve else None
    jblk, tblk = recurrent_pair(make, res)
    want = recorded(False, jblk, call, arrays)
    got = recorded(True, tblk, call, arrays)
    assert_recorded_close(got, want, RTOL, ATOL)
    return jblk, tblk


# ---------------------------------------------------------------------------
# the cases of tests/test_rnn.py, in the port
# ---------------------------------------------------------------------------
def test_lstm_cell_shapes():
    cell = rnn.LSTMCell(8, input_size=4)
    cell.initialize(device="cpu")
    out, states = cell(_nd(_arr(2, 4)), cell.begin_state(2))
    assert out.shape == (2, 8)
    assert len(states) == 2


def test_gru_rnn_cells():
    for cell in (rnn.GRUCell(6, input_size=3), rnn.RNNCell(6, input_size=3)):
        cell.initialize(device="cpu")
        out, states = cell(_nd(_arr(2, 3)), cell.begin_state(2))
        assert out.shape == (2, 6)
        assert len(states) == 1


def test_unroll_merge():
    cell = rnn.GRUCell(5, input_size=3)
    cell.initialize(device="cpu")
    seq = _nd(_arr(2, 7, 3))
    merged, states = cell.unroll(7, seq, layout="NTC")
    assert merged.shape == (2, 7, 5)
    outs, _ = cell.unroll(7, seq, layout="NTC", merge_outputs=False)
    assert len(outs) == 7 and outs[0].shape == (2, 5)


def test_sequential_cell():
    stack = rnn.SequentialRNNCell()
    stack.add(rnn.LSTMCell(4, input_size=3))
    stack.add(rnn.LSTMCell(5, input_size=4))
    stack.initialize(device="cpu")
    out, states = stack(_nd(_arr(2, 3)), stack.begin_state(2))
    assert out.shape == (2, 5)
    assert len(states) == 4


def test_residual_dropout_cells():
    cell = rnn.ResidualCell(rnn.GRUCell(3, input_size=3))
    cell.initialize(device="cpu")
    x = _nd(_arr(2, 3))
    out, _ = cell(x, cell.begin_state(2))
    assert out.shape == (2, 3)
    d = rnn.DropoutCell(0.5)
    out2, _ = d(x, [])
    assert out2.shape == x.shape


def test_fused_lstm_fwd_bwd():
    lstm = rnn.LSTM(16, num_layers=2)
    lstm.initialize(device="cpu")
    seq = _nd(_arr(5, 3, 6))
    with tmx.autograd.record():
        out = lstm(seq)
        out.sum().backward()
    assert out.shape == (5, 3, 16)
    g = lstm.collect_params()["l0_i2h_weight"].grad().numpy()
    assert np.isfinite(g).all() and abs(g).sum() > 0


def test_fused_bidirectional_states():
    lstm = rnn.LSTM(8, bidirectional=True, layout="NTC")
    lstm.initialize(device="cpu")
    out, states = lstm(_nd(_arr(3, 5, 4)), lstm.begin_state(3))
    assert out.shape == (3, 5, 16)
    assert states[0].shape == (2, 3, 8)
    assert states[1].shape == (2, 3, 8)


def test_fused_vs_cell_unroll_match():
    """The fused GRU layer matches the GRUCell unrolled over time."""
    gru = rnn.GRU(4, input_size=3)
    gru.initialize(device="cpu")
    cell = rnn.GRUCell(4, input_size=3)
    cell.initialize(device="cpu")
    gp = gru.collect_params()
    for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        cell.collect_params()[n].set_data(gp["l0_" + n].data())
    seq = _nd(_arr(6, 2, 3))
    fused = gru(seq).asnumpy()
    merged, _ = cell.unroll(6, seq, layout="TNC")
    np.testing.assert_allclose(fused, merged.asnumpy(), rtol=1e-5, atol=1e-6)


def test_rnn_relu_mode():
    net = rnn.RNN(8, activation="relu")
    net.initialize(device="cpu")
    assert net(_nd(_arr(4, 2, 3))).shape == (4, 2, 8)


# ---------------------------------------------------------------------------
# every cell, one step, against the JAX package
# ---------------------------------------------------------------------------
def _step(blk, nds):
    out, states = blk(nds[0], list(nds[1:]))
    return [out] + list(states)


CELLS = {
    "rnn_tanh": (lambda r: r.RNNCell(6, input_size=5), 1, 6),
    "rnn_relu": (lambda r: r.RNNCell(6, activation="relu", input_size=5),
                 1, 6),
    "lstm": (lambda r: r.LSTMCell(6, input_size=5), 2, 6),
    "gru": (lambda r: r.GRUCell(6, input_size=5), 1, 6),
    "lstm_deferred": (lambda r: r.LSTMCell(6), 2, 6),
    "gru_deferred": (lambda r: r.GRUCell(6), 1, 6),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_as_jax(name):
    make, n_states, H = CELLS[name]
    arrays = [_arr(3, 5)] + [_arr(3, H, seed=2 + k) for k in range(n_states)]
    _parity(make, _step, arrays)


def test_lstmp_cell_as_jax():
    arrays = [_arr(3, 5), _arr(3, 4, seed=2), _arr(3, 7, seed=3)]
    _parity(lambda r: r.LSTMPCell(7, 4, input_size=5), _step, arrays)


def test_deferred_input_size_inferred():
    cell = rnn.LSTMCell(6)
    cell.initialize(device="cpu")
    assert cell.collect_params()["i2h_weight"].shape == (24, 0)
    cell(_nd(_arr(3, 5)), cell.begin_state(3))
    assert cell.collect_params()["i2h_weight"].shape == (24, 5)


# ---------------------------------------------------------------------------
# the modifier cells
# ---------------------------------------------------------------------------
def _sequential(r):
    s = r.SequentialRNNCell()
    s.add(r.LSTMCell(4, input_size=3))
    s.add(r.GRUCell(5, input_size=4))
    return s


def test_sequential_cell_as_jax():
    arrays = [_arr(2, 3), _arr(2, 4, seed=2), _arr(2, 4, seed=3),
              _arr(2, 5, seed=4)]
    jblk, tblk = _parity(_sequential, _step, arrays)
    assert len(tblk) == 2 and isinstance(tblk[1], rnn.GRUCell)


@pytest.mark.parametrize("modifier", ["residual", "zoneout", "variational",
                                      "dropout_cell"])
def test_modifier_cells_at_rate_zero_as_jax(modifier):
    """At rate 0 the dropout-based modifiers pass the base cell through
    (in training too, under record())."""
    wrap = {"residual": lambda r, c: r.ResidualCell(c),
            "zoneout": lambda r, c: r.ZoneoutCell(c, 0.0, 0.0),
            "variational": lambda r, c: r.VariationalDropoutCell(
                c, 0.0, 0.0, 0.0),
            "dropout_cell": lambda r, c: r.SequentialRNNCell(
                c, r.DropoutCell(0.0))}[modifier]
    arrays = [_arr(3, 4), _arr(3, 4, seed=2)]
    _parity(lambda r: wrap(r, r.GRUCell(4, input_size=4)), _step, arrays)


def test_dropout_cell_scales_in_training_only():
    tmx.random.seed(3)
    d = rnn.DropoutCell(0.5)
    x = _nd(np.ones((64, 32), np.float32))
    out, _ = d(x, [])
    np.testing.assert_array_equal(out.asnumpy(), 1.0)     # inference
    with tmx.autograd.train_mode():
        out, _ = d(x, [])
    v = out.asnumpy()
    assert set(np.unique(v)) <= {0.0, 2.0}
    assert 0.35 < (v == 0).mean() < 0.65


def test_zoneout_keeps_previous_values_in_training():
    tmx.random.seed(4)
    base = rnn.GRUCell(8, input_size=8)
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.5, zoneout_states=0.5)
    cell.initialize(device="cpu")
    x, h = _nd(_arr(16, 8)), _nd(_arr(16, 8, seed=2))
    with tmx.autograd.train_mode():
        out, (s,) = cell(x, [h])
    new, _ = base(x, [h])
    o, n, hv, sv = out.asnumpy(), new.asnumpy(), h.asnumpy(), s.asnumpy()
    # outputs: the new value or the previous output (zeros at the start)
    assert np.all((o == n) | (o == 0.0))
    assert 0 < (o == 0.0).mean() < 1
    # states: the new state or the previous one
    assert np.all((sv == n) | (sv == hv))
    assert 0 < (sv == hv).mean() < 1
    out2, _ = cell(x, [h])          # inference: the base cell's output
    np.testing.assert_array_equal(out2.asnumpy(), n)


def test_variational_dropout_reuses_its_mask_across_steps():
    tmx.random.seed(5)
    cell = rnn.VariationalDropoutCell(rnn.RNNCell(6, input_size=6),
                                      drop_inputs=0.5)
    cell.initialize(device="cpu")
    seq = _nd(_arr(4, 5, 6))
    with tmx.autograd.train_mode():
        cell.unroll(5, seq, layout="NTC")
    mask = cell._mask_in.numpy()
    assert set(np.unique(mask)) <= {0.0, 2.0} and (mask == 0).any()
    with tmx.autograd.train_mode():
        cell(seq[:, 0], cell.begin_state(4))
    np.testing.assert_array_equal(cell._mask_in.numpy(), mask)
    cell.reset()
    assert cell._mask_in is None


# ---------------------------------------------------------------------------
# unroll
# ---------------------------------------------------------------------------
def _unroll(length, layout, merge, valid=False):
    def call(blk, nds):
        kw = {}
        if valid:
            kw["valid_length"] = nds[-1]
            nds = nds[:-1]
        out, states = blk.unroll(length, nds[0], begin_state=list(nds[1:]),
                                 layout=layout, merge_outputs=merge, **kw)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return outs + list(states)
    return call


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [None, False])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_unroll_as_jax(layout, merge, kind):
    T, N, C, H = 5, 3, 4, 6
    x = _arr(N, T, C) if layout == "NTC" else _arr(T, N, C)
    n_states = 2 if kind == "lstm" else 1
    states = [_arr(N, H, seed=3 + k) for k in range(n_states)]
    make = (lambda r: r.LSTMCell(H, input_size=C)) if kind == "lstm" \
        else (lambda r: r.GRUCell(H, input_size=C))
    _parity(make, _unroll(T, layout, merge), [x] + states)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_unroll_valid_length_as_jax(layout):
    T, N, C, H = 6, 3, 4, 5
    x = _arr(N, T, C) if layout == "NTC" else _arr(T, N, C)
    valid = np.array([6, 2, 4], np.float32)
    arrays = [x, _arr(N, H, seed=3), _arr(N, H, seed=4), valid]
    jblk, tblk = recurrent_pair(lambda r: r.LSTMCell(H, input_size=C))
    call = _unroll(T, layout, None, valid=True)
    want = recorded(False, jblk, call, arrays)
    got = recorded(True, tblk, call, arrays)
    assert_recorded_close((got[0], got[1][:-1], got[2]),
                          (want[0], want[1][:-1], want[2]), RTOL, ATOL)
    merged = got[0][0] if layout == "TNC" else got[0][0].swapaxes(0, 1)
    assert np.all(merged[2:, 1] == 0) and np.all(merged[4:, 2] == 0)


def test_bidirectional_cell_unroll_as_jax():
    T, N, C = 5, 2, 3
    arrays = [_arr(N, T, C), _arr(N, 4, seed=2), _arr(N, 4, seed=3),
              _arr(N, 5, seed=4)]
    _parity(lambda r: r.BidirectionalCell(r.LSTMCell(4, input_size=C),
                                          r.GRUCell(5, input_size=C)),
            _unroll(T, "NTC", None), arrays)


def test_bidirectional_cell_cannot_step():
    cell = rnn.BidirectionalCell(rnn.GRUCell(3, input_size=2),
                                 rnn.GRUCell(3, input_size=2))
    cell.initialize(device="cpu")
    with pytest.raises(tmx.MXNetError, match="unroll"):
        cell(_nd(_arr(2, 2)), cell.begin_state(2))


# ---------------------------------------------------------------------------
# the fused layers
# ---------------------------------------------------------------------------
FUSED = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN", "rnn_relu": "RNN"}


def _fused_make(mode, bi, layout="TNC", input_size=4, layers=2):
    def make(r):
        kw = dict(num_layers=layers, bidirectional=bi, layout=layout,
                  input_size=input_size)
        if mode.startswith("rnn"):
            kw["activation"] = mode[4:]
        return getattr(r, FUSED[mode])(5, **kw)
    return make


def _fused_call(with_states):
    def call(blk, nds):
        if not with_states:
            return [blk(nds[0])]
        out, states = blk(nds[0], list(nds[1:]))
        return [out] + list(states)
    return call


@pytest.mark.parametrize("with_states", [True, False])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("mode", sorted(FUSED))
def test_fused_layer_as_jax(mode, bi, with_states):
    T, N, C, H, L = 6, 3, 4, 5, 2
    D = 2 if bi else 1
    arrays = [_arr(T, N, C)]
    if with_states:
        arrays += [_arr(L * D, N, H, seed=3 + k)
                   for k in range(2 if mode == "lstm" else 1)]
    _parity(_fused_make(mode, bi), _fused_call(with_states), arrays)


def test_fused_layer_ntc_and_deferred_input_as_jax():
    arrays = [_arr(3, 6, 4), _arr(2, 3, 5, seed=3), _arr(2, 3, 5, seed=4)]
    _parity(_fused_make("lstm", True, "NTC", input_size=0, layers=1),
            _fused_call(True), arrays)


def test_fused_layer_names_as_jax():
    jblk, tblk = recurrent_pair(_fused_make("gru", True),
                                lambda j: j(jmx.np.array(_arr(6, 3, 4))))
    assert list(tblk.collect_params()) == list(jblk.collect_params())
    assert "r1_h2h_bias" in tblk.collect_params()
    assert repr(tblk) == repr(jblk)


def test_fused_dropout_between_layers_in_training_only():
    tmx.random.seed(6)
    net = rnn.LSTM(8, num_layers=2, dropout=0.5, input_size=4)
    net.initialize(device="cpu")
    plain = rnn.LSTM(8, num_layers=2, input_size=4)
    plain.initialize(device="cpu")
    for name, p in plain.collect_params().items():
        p.set_data(net.collect_params()[name].data())
    x = _nd(_arr(5, 3, 4))
    np.testing.assert_array_equal(net(x).asnumpy(), plain(x).asnumpy())
    with tmx.autograd.train_mode():
        a, b = net(x).asnumpy(), net(x).asnumpy()
    assert not np.allclose(a, plain(x).asnumpy())
    assert not np.array_equal(a, b)          # a new mask each forward
    # one layer has no layer after it: no dropout at all
    one = rnn.LSTM(8, num_layers=1, dropout=0.5, input_size=4)
    one.initialize(device="cpu")
    with tmx.autograd.train_mode():
        np.testing.assert_array_equal(one(x).asnumpy(),
                                      one(x).asnumpy())


def test_fused_layer_steps_count_no_kernel_on_the_cpu():
    kernels.reset_launch_counts()
    net = rnn.GRU(4, num_layers=2, input_size=3)
    net.initialize(device="cpu")
    with tmx.autograd.record():
        net(_nd(_arr(5, 2, 3))).sum().backward()
    counts = kernels.launch_counts()
    assert counts["rnn_cell_fwd"] == counts["rnn_cell_bwd"] == 0
    assert counts["rnn_layer_fwd"] == counts["rnn_layer_bwd"] == 0
    assert counts["rnn_layer_persistent"] == \
        counts["rnn_layer_per_step"] == 0


# ---------------------------------------------------------------------------
# FusedTrainStep (the case of tests/test_fused_step.py:55-75)
# ---------------------------------------------------------------------------
def test_fused_step_adam_with_extras_and_clip_as_jax():
    """Adam, the recurrent states as pass-through extras, global-norm
    clipping: four steps from the same weights give the same losses and
    weights in both packages."""
    x, h0 = _arr(5, 4, 8), np.zeros((1, 4, 16), np.float32)
    jnet, tnet = recurrent_pair(lambda r: r.LSTM(16, 1, input_size=8))

    def fn(net, x, h, c):
        out, (h2, c2) = net(x, [h, c])
        return (out * out).mean(), h2, c2

    def run(pkg, net, step_cls, opt_mod, nd):
        step = step_cls(net, fn, opt_mod.create("adam", learning_rate=1e-2),
                        clip_global_norm=1.0)
        h = c = nd(h0)
        losses = []
        for _ in range(4):
            L, h, c = step(nd(x), h, c)
            losses.append(float(L.asnumpy()))
        return losses, h

    want, jh = run(jmx, jnet, JStep, jopt, jmx.np.array)
    got, th = run(tmx, tnet, TStep, topt, _nd)
    assert all(np.isfinite(v) for v in got)
    assert got[-1] < got[0]
    assert th.shape == (1, 4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.asnumpy(), jh.asnumpy(), rtol=1e-4,
                               atol=1e-5)
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            tnet.collect_params()[name].data().detach().numpy(),
            p.data().asnumpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_public_names_as_jax():
    from incubator_mxnet_tpu.gluon import rnn as jrnn
    from incubator_mxnet_tpu.ops import nn as jnn
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    assert set(rnn.__all__) == set(jrnn.__all__)
    for name in jrnn.__all__:
        assert hasattr(rnn, name), name
    for name in ("lstm_cell", "gru_cell", "rnn_relu_cell", "rnn"):
        assert callable(getattr(jnn, name)) and callable(getattr(tnn, name))
    assert "rnn" in tmx.npx.__all__ and "rnn" in tmx.gluon.__all__
