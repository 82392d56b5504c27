"""PyTorch port: `FusedTrainStep(remat=None | "full" | "dots")`.

Rematerialization changes what the backward keeps, never the result: the
three policies give the same losses, gradients (read off plain SGD
updates) and BatchNorm running statistics, with Dropout in the net (its
masks drawn again, equal, in the recompute), and the same as the JAX
package's policies (`tests/test_fused_step.py::
test_remat_policies_numerically_identical`'s net and form, values carried
across from numpy). The recompute launches the forward's fused ops again:
under "full" and "dots" each apply launch of the forward happens twice a
step (counted on the dispatcher the CPU reaches), while "dots" keeps the
convolution's output, as the JAX package's `dots_saveable` does, and runs
it once.

Tolerances: the port's policies against each other within 1e-6 relative
(the same ops on the same values: they agree bit for bit on the CPU);
against the JAX package as its own test holds its policies (1e-5 relative
on the loss, 1e-5 relative + 1e-6 absolute on the weights).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.ops import fused as tfused

from torch_port_utils import assert_values_close, jax_values, port_values

torch.set_num_threads(1)

POLICIES = (None, "full", "dots")
RTOL = 1e-6
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6
STEPS = 3


def _x(seed=0):
    return np.random.RandomState(seed).rand(4, 8, 8, 3).astype(np.float32)


def _y(seed=1):
    return np.random.RandomState(seed).randint(0, 10, (4,)).astype(np.int32)


def _values(net, seed=2):
    """numpy values for every parameter and running stat of `net`, in the
    JAX package's layout."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, v in port_values(net).items():
        shape = v.shape
        if name.endswith("running_var") or name.endswith("gamma"):
            out[name] = (1 + 0.2 * np.abs(rng.randn(*shape)))
        else:
            out[name] = 0.3 * rng.randn(*shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _port_net(dropout, act=None):
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(8, 3, padding=1, layout="NHWC", activation=act),
            tnn.BatchNorm(axis=3), tnn.Activation("relu"))
    if dropout:
        net.add(tnn.Dropout(0.3))
    net.add(tnn.Flatten(), tnn.Dense(10))
    return net.initialize(device="cpu")


def _port_run(remat, dropout=True, use_fusion=False, act=None):
    """STEPS SGD steps (lr 1: each update is the gradient) of a fresh port
    net from the same values and dropout seed; (losses, values after each
    step)."""
    trandom.seed(7)
    net = _port_net(dropout, act)
    net(torch.zeros(1, 8, 8, 3))
    tgluon.params_from_jax(net, _values(net))
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    step = TStep(net, lambda n, a, b: L(n(a), b).sum(),
                 topt.create("sgd", learning_rate=1.0), remat=remat,
                 use_fusion=use_fusion)
    losses, values = [], []
    for _ in range(STEPS):
        losses.append(float(step(_x(), _y())))
        values.append(port_values(net))
    gen_state = trandom.generator("cpu").get_state()
    return losses, values, gen_state


def _port_net_values():
    net = _port_net(False)
    net(torch.zeros(1, 8, 8, 3))
    return _values(net)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_policies_agree_with_dropout_and_batchnorm(remat):
    base_l, base_v, base_gen = _port_run(None)
    got_l, got_v, got_gen = _port_run(remat)
    np.testing.assert_allclose(got_l, base_l, rtol=RTOL)
    for k in range(STEPS):   # every update (the gradient), every stat
        assert_values_close(got_v[k], base_v[k], RTOL, 0.0,
                            f"{remat} step {k}:")
    # the recompute restored the dropout generator: later draws agree
    assert torch.equal(got_gen, base_gen)


def test_recompute_launches_the_forward_apply_again():
    """Under fusion the convolution's bias + relu and the BatchNorm take
    the apply: 2 launches a forward; "full" and "dots" recompute the
    forward in the backward (4 a step), None does not (2)."""
    orig = tfused._apply_fwd
    counts = {}
    for remat in POLICIES:
        calls = []

        def counting(*a):
            calls.append(1)
            return orig(*a)
        tfused._apply_fwd = counting
        try:
            _port_run(remat, dropout=True, use_fusion=True, act="relu")
        finally:
            tfused._apply_fwd = orig
        counts[remat] = len(calls) // STEPS
    assert counts == {None: 2, "full": 4, "dots": 4}


class _CountOps(TorchDispatchMode):
    """Counts the calls of each aten op that reach the dispatcher below
    autograd (a saved output is not computed again, so it is not
    counted)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket.__name__
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_convolution():
    """"dots" keeps the convolution's output, as `dots_saveable` keeps
    `conv_general_dilated`'s: the convolution's forward runs once a step
    under None and "dots" and twice under "full", while the apply (no
    product) runs again in the recompute under both policies."""
    orig = tfused._apply_fwd
    convs, applies = {}, {}
    for remat in POLICIES:
        calls = []

        def counting(*a):
            calls.append(1)
            return orig(*a)
        tfused._apply_fwd = counting
        try:
            with _CountOps() as mode:
                _port_run(remat, dropout=True, use_fusion=True, act="relu")
        finally:
            tfused._apply_fwd = orig
        convs[remat] = mode.counts.get("convolution", 0) // STEPS
        applies[remat] = len(calls) // STEPS
    assert convs == {None: 1, "full": 2, "dots": 1}
    assert applies == {None: 2, "full": 4, "dots": 4}


def test_policies_match_jax():
    """The JAX package's remat test net (Conv NHWC, BN, relu, Dense; no
    dropout) and SGD lr 0.1 over 3 steps: each port policy against each
    JAX policy."""
    def jax_net():
        net = jnn.HybridSequential()
        net.add(jnn.Conv2D(8, 3, padding=1, layout="NHWC"),
                jnn.BatchNorm(axis=3), jnn.Activation("relu"),
                jnn.Flatten(), jnn.Dense(10))
        net.initialize()
        net(mx.np.zeros((1, 8, 8, 3)))
        return net

    values = _port_net_values()
    x, y = _x(), _y()
    jL, tL = (jgluon.loss.SoftmaxCrossEntropyLoss(),
              tgluon.loss.SoftmaxCrossEntropyLoss())
    for jremat, tremat in zip(POLICIES, POLICIES):
        jnet = jax_net()
        for name, p in jnet.collect_params().items():
            p.set_data(mx.np.array(values[name]))
        jstep = JStep(jnet, lambda n, a, b: jL(n(a), b).sum(),
                      jopt.create("sgd", learning_rate=0.1), remat=jremat)
        prev = jfused.set_interpret(True)
        try:
            want = [float(jstep(mx.np.array(x), mx.np.array(y)).asnumpy())
                    for _ in range(STEPS)]
        finally:
            jfused.set_interpret(prev)
        tnet = _port_net(False)
        tnet(torch.zeros(1, 8, 8, 3))
        tgluon.params_from_jax(tnet, values)
        tstep = TStep(tnet, lambda n, a, b: tL(n(a), b).sum(),
                      topt.create("sgd", learning_rate=0.1), remat=tremat)
        got = [float(tstep(x, y)) for _ in range(STEPS)]
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL)
        assert_values_close(port_values(tnet), jax_values(jnet), JAX_RTOL,
                            JAX_ATOL, f"remat {tremat}:")


def test_unknown_policy_raises():
    net = _port_net(False)
    net(torch.zeros(1, 8, 8, 3))
    with pytest.raises(MXNetError, match="unknown remat policy"):
        TStep(net, lambda n, a: n(a).sum(), "sgd", remat="bogus")
