"""PyTorch port: the plain ops, the loss, the optimizer rule and the
initializers of the training slice against the JAX package, from the
same numpy inputs.

`ops.nn` (convolution, fully_connected, the unfused batch_norm, pooling,
activation, log_softmax, pick) against `incubator_mxnet_tpu.ops.nn`,
values and gradients; `gluon.loss.SoftmaxCrossEntropyLoss` against the
JAX loss; `optimizer.SGD` (MXNet's momentum rule, rescale, clip, wd)
against the JAX optimizer's update. Float32 on both sides, only the order
of sums differing: 1e-5 relative and absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.ops import nn as jnn

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _grads_match(jfn, tfn, arrays, ct_seed=0):
    """Values and the gradients of sum(out * ct) for every array."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    ct = _rand(np.random.RandomState(ct_seed), want.shape)
    wgrads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = tfn(*ts)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for i, (t, g) in enumerate(zip(ts, wgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=f"grad {i}", **TOL)


@pytest.mark.parametrize("stride,pad,k,bias", [
    (1, 1, 3, False), (2, 3, 7, False), (2, 0, 1, True)],
    ids=["3x3", "7x7s2", "1x1s2_bias"])
def test_convolution_nhwc_matches_jax(stride, pad, k, bias):
    rng = np.random.RandomState(1)
    x = _rand(rng, (2, 10, 10, 4))
    w_hwio = _rand(rng, (k, k, 4, 6), 0.3)
    b = _rand(rng, (6,), 0.1)
    arrays = [x, w_hwio] + ([b] if bias else [])

    def jfn(x, w, *bb):
        return jnn.conv(x, w, bb[0] if bb else None, stride=stride,
                        padding=pad, layout="NHWC")

    def tfn(x, w, *bb):
        return tnn.convolution(x, w.permute(3, 2, 0, 1),
                               bb[0] if bb else None, stride=stride,
                               pad=pad, no_bias=not bb, layout="NHWC")

    _grads_match(jfn, tfn, arrays)


def test_fully_connected_matches_jax():
    rng = np.random.RandomState(2)
    arrays = [_rand(rng, (3, 1, 1, 8)), _rand(rng, (5, 8)),
              _rand(rng, (5,))]
    _grads_match(lambda x, w, b: jnn.dense(x, w, b),
                 lambda x, w, b: tnn.fully_connected(x, w, b), arrays)


@pytest.mark.parametrize("kw", [
    dict(kernel=3, pool_type="max", stride=2, padding=1),
    dict(kernel=2, pool_type="avg", stride=2, padding=0),
    dict(kernel=3, pool_type="avg", stride=2, padding=1,
         count_include_pad=False),
    dict(kernel=3, pool_type="max", stride=2, padding=0, ceil_mode=True),
    dict(kernel=1, pool_type="avg", global_pool=True),
    dict(kernel=1, pool_type="max", global_pool=True),
], ids=["max3s2p1", "avg2", "avg3p1_exclpad", "max3_ceil", "global_avg",
        "global_max"])
def test_pooling_nhwc_matches_jax(kw):
    x = _rand(np.random.RandomState(3), (2, 9, 9, 4))
    jkw = dict(kw)
    tkw = dict(kw)
    tkw["pad"] = tkw.pop("padding", 0)
    _grads_match(lambda a: jnn.pooling(a, layout="NHWC", **jkw),
                 lambda a: tnn.pooling(a, layout="NHWC", **tkw), [x])


@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
def test_unfused_batch_norm_matches_jax(training):
    rng = np.random.RandomState(4)
    x = _rand(rng, (4, 3, 3, 6), 2.0) + 1.0
    g, b = 1 + _rand(rng, (6,), 0.2), _rand(rng, (6,), 0.2)
    rm, rv = _rand(rng, (6,), 0.2), 1 + np.abs(_rand(rng, (6,), 0.2))
    jout = jnn.batch_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          jnp.asarray(rm), jnp.asarray(rv),
                          training=training, axis=-1)
    tout = tnn.batch_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b),
                          torch.tensor(rm), torch.tensor(rv),
                          training=training, axis=-1)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    _grads_match(
        lambda a, gg, bb: jnn.batch_norm(a, gg, bb, jnp.asarray(rm),
                                         jnp.asarray(rv), training=training,
                                         axis=-1)[0],
        lambda a, gg, bb: tnn.batch_norm(a, gg, bb, torch.tensor(rm),
                                         torch.tensor(rv), training=training,
                                         axis=-1)[0], [x, g, b])


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "log_sigmoid", "mish"])
def test_activation_matches_jax(act):
    x = _rand(np.random.RandomState(5), (4, 7), 2.0)
    _grads_match(lambda a: jnn.activation(a, act),
                 lambda a: tnn.activation(a, act), [x])


def test_log_softmax_and_pick_match_jax():
    rng = np.random.RandomState(6)
    x = _rand(rng, (5, 7), 3.0)
    idx = np.array([0, 6, 3, 9, -1], np.int32)      # clipped like mode='clip'
    _grads_match(lambda a: jnn.pick(jnn.log_softmax(a), jnp.asarray(idx)),
                 lambda a: tnn.pick(tnn.log_softmax(a), torch.tensor(idx)),
                 [x])


@pytest.mark.parametrize("kw", [dict(), dict(weight=0.5),
                                dict(sparse_label=False)],
                         ids=["sparse", "weighted", "dense_label"])
def test_softmax_ce_loss_matches_jax(kw):
    rng = np.random.RandomState(7)
    pred = _rand(rng, (4, 6), 2.0)
    if kw.get("sparse_label", True):
        label = rng.randint(0, 6, size=4).astype(np.int32)
    else:
        label = np.abs(_rand(rng, (4, 6)))
        label /= label.sum(-1, keepdims=True)
    want = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        mx.np.array(pred), mx.np.array(label)).asnumpy()
    got = tgluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.tensor(pred), torch.tensor(label))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kw", [
    dict(momentum=0.9), dict(momentum=0.0),
    dict(momentum=0.9, wd=1e-3, clip_gradient=0.05)],
    ids=["momentum", "plain", "wd_clip"])
def test_sgd_rule_matches_jax(kw):
    """Three updates of one weight: MXNet's rule, rescale before clip and
    wd, momentum as mom = mu*mom - lr*g; w += mom."""
    rng = np.random.RandomState(8)
    w0 = _rand(rng, (6, 5))
    grads = [_rand(rng, (6, 5)) for _ in range(3)]
    jo = jopt.create("sgd", learning_rate=0.1, rescale_grad=0.25, **kw)
    to = topt.create("sgd", learning_rate=0.1, rescale_grad=0.25, **kw)
    jw = mx.np.array(w0)
    js = jo.create_state(0, jw)
    tw = torch.tensor(w0)
    ts = to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, mx.np.array(g), js)
        to.update(0, tw, torch.tensor(g), ts)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-7)
    if ts is not None:
        np.testing.assert_allclose(ts.numpy(), js.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    assert to.num_update == 3


def test_initializers_dispatch_on_names_and_seed():
    u = tinit.create(None)
    assert isinstance(u, tinit.Uniform) and u.scale == 0.07
    g = torch.Generator().manual_seed(3)
    w = u("features.0.weight", (64, 32), g)
    assert w.abs().max() <= 0.07 and w.std() > 0.03
    assert torch.equal(u("x.gamma", (4,), g), torch.ones(4))
    assert torch.equal(u("x.running_var", (4,), g), torch.ones(4))
    assert torch.equal(u("x.beta", (4,), g), torch.zeros(4))
    assert torch.equal(tinit.create("zeros")("w", (2,), g), torch.zeros(2))
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("nope")
    a = tgluon.nn.Dense(3, in_units=4).initialize(device="cpu", seed=5)
    b = tgluon.nn.Dense(3, in_units=4).initialize(device="cpu", seed=5)
    c = tgluon.nn.Dense(3, in_units=4).initialize(device="cpu", seed=6)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    assert torch.equal(a.bias, torch.zeros(3))


def test_layers_need_explicit_channels():
    """Channel counts are no longer needed: Conv2D and Dense without them
    defer their weights to the first forward (their shapes then equal the
    JAX package's), and the values equal an explicit layer's from the same
    seed, drawn at `initialize()`."""
    for layout, x in (("NCHW", np.zeros((2, 5, 6, 6), np.float32)),
                      ("NHWC", np.zeros((2, 6, 6, 5), np.float32))):
        conv = tgluon.nn.Conv2D(8, 3, layout=layout).initialize(
            device="cpu", seed=2)
        with pytest.raises(tgluon.DeferredInitializationError):
            conv.collect_params()["weight"].data()
        conv(torch.from_numpy(x))
        jconv = mx.gluon.nn.Conv2D(8, 3, layout=layout)
        jconv.initialize()
        jconv(mx.np.array(x))
        want = {n: p.shape for n, p in jconv.collect_params().items()}
        if layout == "NHWC":            # HWIO there, (O, I, kh, kw) here
            want["weight"] = (8, 5, 3, 3)
        assert {n: p.shape for n, p in conv.collect_params().items()} == want
        eager = tgluon.nn.Conv2D(8, 3, layout=layout, in_channels=5)
        eager.initialize(device="cpu", seed=2)
        assert torch.equal(conv.weight, eager.weight)
    dense = tgluon.nn.Dense(8).initialize(device="cpu", seed=3)
    dense(torch.zeros(4, 2, 3))                      # flatten: 6 in units
    assert dense.weight.shape == (8, 6)
    with pytest.raises(MXNetError, match="incompatible"):
        dense.collect_params()["weight"].shape = (8, 7)
