"""PyTorch port: `autograd` against the JAX package, on the CPU — the
cases of tests/test_autograd.py that apply to tensors (the port's arrays
until it has its own NDArray: `requires_grad_()` or `mark_variables` in
place of `attach_grad()`, `autograd.backward(y)` in place of
`y.backward()`).

Each case runs the same numpy inputs through both packages and compares
the gradients to rtol 1e-6 (the same few float32 operations on both
sides), except where a value is exact (grad_req, scopes).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import gluon as tgluon

torch.set_num_threads(1)

RTOL = 1e-6


def _jvar(a, grad_req="write"):
    x = mx.np.array(np.asarray(a, np.float32))
    x.attach_grad(grad_req=grad_req)
    return x


def _tvar(a, grad_req="write"):
    x = torch.tensor(np.asarray(a, np.float32))
    ag.mark_variables([x], grad_reqs=grad_req)
    return x


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), j.asnumpy(), rtol=RTOL,
                               atol=1e-7)


# (name, function of the variables, inputs): each run under record() and
# backward from the scalar head, in both packages
CASES = [
    ("simple", lambda x: (x * x).sum(), [[1.0, 2.0, 3.0]]),
    ("chain", lambda x: (x.sin().exp() if isinstance(x, torch.Tensor)
                         else mx.np.exp(mx.np.sin(x))), [[0.5]]),
    ("multi_input", lambda a, b: a * b + a, [[2.0], [3.0]]),
    ("getitem", lambda x: (x[1:3] * 2).sum(), [[1.0, 2.0, 3.0, 4.0]]),
    ("concat", lambda a, b: (torch.cat([a * 2, b * 3]).sum()
                             if isinstance(a, torch.Tensor) else
                             mx.np.concatenate([a * 2, b * 3]).sum()),
     [[1.0], [2.0]]),
    ("tanh_x", lambda x: ((x.tanh() if isinstance(x, torch.Tensor)
                           else mx.np.tanh(x)) * x).sum(),
     [np.random.RandomState(0).randn(5)]),
]


@pytest.mark.parametrize("name,fn,inputs", CASES,
                         ids=[c[0] for c in CASES])
def test_gradients_match_jax(name, fn, inputs):
    jx = [_jvar(a) for a in inputs]
    with jag.record():
        jy = fn(*jx)
    jy.backward()
    tx = [_tvar(a) for a in inputs]
    with ag.record():
        ty = fn(*tx)
    ag.backward(ty)
    for t, j in zip(tx, jx):
        _close(t.grad, j.grad)


def test_head_gradient_and_non_scalar_head():
    """A head gradient weights the backward; a non-scalar head without one
    is seeded with ones (MXNet's per-sample loss.backward())."""
    jx, tx = _jvar([1.0, 1.0]), _tvar([1.0, 1.0])
    with jag.record():
        jy = jx * 2
    jy.backward(mx.np.array([1.0, 10.0]))
    with ag.record():
        ty = tx * 2
    ag.backward(ty, torch.tensor([1.0, 10.0]))
    _close(tx.grad, jx.grad)
    jx, tx = _jvar([1.0, 3.0]), _tvar([1.0, 3.0])
    with jag.record():
        jy = jx * jx
    jy.backward()
    with ag.record():
        ty = tx * tx
    ag.backward(ty)                  # torch's ty.backward() would refuse
    _close(tx.grad, jx.grad)


def test_grad_req_add_accumulates_and_write_overwrites():
    jx, tx = _jvar([1.0], "add"), _tvar([1.0], "add")
    for _ in range(3):
        with jag.record():
            jy = jx * 2
        jy.backward()
        with ag.record():
            ty = tx * 2
        ag.backward(ty)
    _close(tx.grad, jx.grad)
    assert float(tx.grad) == 6.0
    # write: a second backward of a retained graph overwrites
    jx, tx = _jvar([2.0]), _tvar([2.0])
    with jag.record():
        jy = jx * jx
    with ag.record():
        ty = tx * tx
    jy.backward(retain_graph=True)
    ag.backward(ty, retain_graph=True)
    jy.backward()
    ag.backward(ty)
    _close(tx.grad, jx.grad)
    assert float(tx.grad) == 4.0


def test_grad_req_null_leaves_no_gradient():
    tx = _tvar([1.0], "null")
    assert not tx.requires_grad
    with ag.record():
        ty = tx * 2
    with pytest.raises(MXNetError, match="not connected to the tape"):
        ag.backward(ty)
    assert tx.grad is None
    jx = _jvar([1.0], "null")
    with jag.record():
        jy = jx * 2
    jy.backward()
    assert jx.grad is None


def test_shared_weight_writes_the_summed_gradient_once():
    """A variable used twice in one graph gets the sum of both uses, once,
    in write mode."""
    tx = _tvar([3.0])
    with ag.record():
        ty = tx * 2 + tx * tx
    ag.backward(ty)
    ag.backward(tx * 2 + tx * tx)      # taped outside record(): see module
    assert float(tx.grad) == 8.0


def test_scopes_match_jax():
    for mod in (jag, ag):
        assert not mod.is_recording() and not mod.is_training()
        with mod.record():
            assert mod.is_recording() and mod.is_training()
            with mod.pause():
                assert not mod.is_recording() and not mod.is_training()
            assert mod.is_recording()
        with mod.record(train_mode=False):
            assert mod.is_recording() and not mod.is_training()
        with mod.train_mode():
            assert mod.is_training()
            with mod.predict_mode():
                assert not mod.is_training()
        assert not mod.is_recording() and not mod.is_training()
    prev = ag.set_training(True)
    assert prev is False and ag.is_training()
    ag.set_training(False)
    assert ag.set_recording(True) is False and torch.is_grad_enabled()
    ag.set_recording(False)
    assert not torch.is_grad_enabled()
    torch.set_grad_enabled(True)


def test_pause_stops_taping():
    tx = _tvar([1.0])
    with ag.record():
        with ag.pause():
            ty = tx * 2
    with pytest.raises(MXNetError):
        ag.backward(ty)
    jx = _jvar([1.0])
    with jag.record():
        with jag.pause():
            jy = jx * 2
    with pytest.raises(mx.MXNetError):
        jy.backward()


def test_detach():
    jx, tx = _jvar([2.0]), _tvar([2.0])
    with jag.record():
        jz = (jx * 3).detach() * jx
    jz.backward()
    with ag.record():
        tz = (tx * 3).detach() * tx
    ag.backward(tz)
    _close(tx.grad, jx.grad)
    assert float(tx.grad) == 6.0


def test_grad_function_leaves_grad_buffer():
    jx, tx = _jvar([3.0]), _tvar([3.0])
    tx.grad = torch.zeros(1)
    with jag.record():
        jy = jx ** 2
    with ag.record():
        ty = tx ** 2
    jg, tg = jag.grad(jy, jx), ag.grad(ty, tx)
    _close(tg, jg)
    assert float(tx.grad) == 0.0      # grad() writes no .grad


def test_grad_wrt_intermediate():
    x0 = np.array([2.0, 3.0], np.float32)
    jx, tx = _jvar(x0), _tvar(x0)
    with jag.record():
        jy = jx * 2
        jz = jy * jy
    with ag.record():
        ty = tx * 2
        tz = ty * ty
    _close(ag.grad(tz, ty), jag.grad(jz, jy))


@pytest.mark.parametrize("order", [2, 3])
def test_higher_order(order):
    jx, tx = _jvar([2.0]), _tvar([2.0])
    with jag.record():
        jy = jx ** 4
        jg = jy
        for _ in range(order - 1):
            jg = jag.grad(jg, jx, create_graph=True, retain_graph=True)
    jg.backward()
    with ag.record():
        tg = tx ** 4
        for _ in range(order - 1):
            tg = ag.grad(tg, tx, create_graph=True, retain_graph=True)
    ag.backward(tg)
    _close(tx.grad, jx.grad)


def test_mark_variables_with_buffers():
    x0 = np.array([1.0, 2.0], np.float32)
    jx = mx.np.array(x0)
    jag.mark_variables([jx], [mx.np.zeros(2)])
    tx = torch.tensor(x0)
    buf = torch.zeros(2)
    ag.mark_variables([tx], [buf])
    assert tx.grad is buf
    with jag.record():
        jy = (jx * jx).sum()
    jy.backward()
    with ag.record():
        ty = (tx * tx).sum()
    ag.backward(ty)
    _close(tx.grad, jx.grad)
    # the backward wrote into the caller's buffer (ROADMAP C4)
    assert tx.grad is buf
    _close(buf, jx.grad)


# ---------------------------------------------------------------------------
# C4: a backward writes into the caller's gradient buffer, as the JAX
# package's `var.grad[:] = ct` (or `+= ct` for "add") does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounds", [1, 2])
def test_write_lands_in_the_callers_buffer(rounds):
    """grad_req "write": each backward overwrites the buffer given to
    `mark_variables`, which stays the variable's `.grad`."""
    rng = np.random.RandomState(11)
    x0 = rng.randn(4).astype(np.float32)
    ws = [rng.randn(4).astype(np.float32) for _ in range(rounds)]
    jx = mx.np.array(x0)
    jag.mark_variables([jx], [mx.np.zeros(4)])
    tx = torch.tensor(x0)
    buf = torch.full((4,), 5.0)
    ag.mark_variables([tx], [buf], grad_reqs="write")
    for w in ws:
        with jag.record():
            jy = (jx * jx * mx.np.array(w)).sum()
        jy.backward()
        with ag.record():
            ty = (tx * tx * torch.tensor(w)).sum()
        ag.backward(ty)
        assert tx.grad is buf
        _close(buf, jx.grad)


def test_add_sums_into_the_callers_buffer():
    """grad_req "add": two backwards sum into the caller's buffer; the
    buffer's earlier content is overwritten by the first (a round starts
    afresh), as in the JAX package after `attach_grad`."""
    rng = np.random.RandomState(12)
    x0 = rng.randn(3).astype(np.float32)
    ws = [rng.randn(3).astype(np.float32) for _ in range(2)]
    jx = mx.np.array(x0)
    jag.mark_variables([jx], [mx.np.full((3,), 9.0)], grad_reqs="add")
    tx = torch.tensor(x0)
    buf = torch.full((3,), 9.0)
    ag.mark_variables([tx], [buf], grad_reqs="add")
    for w in ws:
        with jag.record():
            jy = (jx * jx * mx.np.array(w)).sum()
        jy.backward()
        with ag.record():
            ty = (tx * tx * torch.tensor(w)).sum()
        ag.backward(ty)
        assert tx.grad is buf
    _close(buf, jx.grad)
    np.testing.assert_allclose(buf.numpy(), 2 * x0 * (ws[0] + ws[1]),
                               rtol=RTOL)
    # the round's first backward overwrote the buffer: one copy
    assert ag.buffer_copies() >= 1


def test_parameter_grad_buffer_holds_the_gradient():
    """The tensor `p.grad()` returned before a backward holds the gradient
    after it, equal to the JAX Dense's, and bit-equal to the gradient
    `torch.autograd.grad` takes on the same graph."""
    rng = np.random.RandomState(13)
    x0 = rng.randn(5, 3).astype(np.float32)
    jnet = mx.gluon.nn.Dense(2, in_units=3)
    jnet.initialize()
    tnet = tgluon.nn.Dense(2, in_units=3).initialize(device="cpu")
    w0 = rng.randn(2, 3).astype(np.float32)
    b0 = rng.randn(2).astype(np.float32)
    jnet.weight.set_data(mx.np.array(w0))
    jnet.bias.set_data(mx.np.array(b0))
    params = tnet.collect_params()
    params["weight"].set_data(w0)
    params["bias"].set_data(b0)
    held = {n: p.grad() for n, p in params.items()}
    for _ in range(2):           # write: the second backward overwrites
        with jag.record():
            jy = (jnet(mx.np.array(x0)) ** 2).sum()
        jy.backward()
        with ag.record():
            ty = (tnet(torch.tensor(x0)) ** 2).sum()
        want = torch.autograd.grad(ty, [p.data() for p in params.values()],
                                   retain_graph=True)
        ag.backward(ty)
        for (n, p), g in zip(params.items(), want):
            assert p.grad() is held[n]
            assert torch.equal(held[n], g)
    _close(held["weight"], jnet.weight.grad())
    _close(held["bias"], jnet.bias.grad())


def test_custom_function():
    class Square:
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            x, = self._saved
            return dy * 2 * x

    class JSquare(Square, jag.Function):
        pass

    class TSquare(Square, ag.Function):
        pass

    jx, tx = _jvar([3.0]), _tvar([3.0])
    with jag.record():
        jz = JSquare()(jx) * 2
    jz.backward()
    with ag.record():
        tz = TSquare()(tx) * 2
    ag.backward(tz)
    _close(tx.grad, jx.grad)
    assert float(tx.grad) == 12.0


def test_grad_of_nonfloat_output_is_skipped():
    x0 = [1.0, 5.0, 3.0]
    jx, tx = _jvar(x0), _tvar(x0)
    with jag.record():
        jx.argmax()
        jy = (jx * 2).sum()
    jy.backward()
    with ag.record():
        tx.argmax()
        ty = (tx * 2).sum()
    ag.backward(ty)
    _close(tx.grad, jx.grad)


def test_grad_under_autograd_grad_leaves_parameters_alone():
    """`torch.autograd.grad` (FusedTrainStep's) neither writes a
    Parameter's gradient nor marks it fresh for the Trainer."""
    net = tgluon.nn.Dense(2, in_units=3).initialize(device="cpu")
    p = net.collect_params()["weight"]
    p.grad()[:] = 7.0
    with ag.record():
        y = net(torch.ones(1, 3)).sum()
    torch.autograd.grad(y, [p.data()])
    assert torch.equal(p.grad(), torch.full((2, 3), 7.0))
    assert not ag.variable(p.data()).fresh
    with ag.record():
        y = net(torch.ones(1, 3)).sum()
    ag.backward(y)
    assert torch.equal(p.grad(), torch.ones(2, 3))
    assert ag.variable(p.data()).fresh
