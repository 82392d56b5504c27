"""PyTorch port: `gluon.Parameter` and the block's Parameter surface
(deferred shapes, grad_req, zero_grad, cast, shared Parameters, the
`.npz` files of `save_parameters`) against the JAX package, on the CPU.

Deferred layers are built without channel counts in both packages, run
once on the same numpy input, and must then hold Parameters of the same
structural names and shapes (an NHWC convolution's weight is HWIO in the
JAX package, (O, I, kh, kw) here). A file written by either package's
`save_parameters` loads in the other, and the two nets' outputs on one
input then agree to rtol 1e-5 (float32; convolutions and products sum in
their own orders).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep

torch.set_num_threads(1)

RTOL = 1e-5


def _layers(pkg, layout="NHWC"):
    nn = pkg.nn
    return {
        "dense": (lambda: nn.Dense(10), (3, 2, 4)),
        "dense_noflat": (lambda: nn.Dense(10, flatten=False), (3, 2, 4)),
        "conv": (lambda: nn.Conv2D(8, 3, layout=layout), (2, 6, 6, 5)),
        "conv_nchw": (lambda: nn.Conv2D(8, 3, layout="NCHW"), (2, 5, 6, 6)),
        "batchnorm": (lambda: nn.BatchNorm(axis=-1), (4, 3, 3, 6)),
        "layernorm": (lambda: nn.LayerNorm(), (2, 3, 7)),
    }


def _port_shape(name, shape):
    """The JAX package's shape of a value as the port holds it."""
    if name == "conv" and len(shape) == 4:
        kh, kw, i, o = shape
        return (o, i, kh, kw)
    return shape


@pytest.mark.parametrize("kind", ["dense", "dense_noflat", "conv",
                                  "conv_nchw", "batchnorm", "layernorm"])
def test_deferred_shapes_match_jax(kind):
    jmake, in_shape = _layers(jgluon)[kind]
    tmake, _ = _layers(tgluon)[kind]
    x = np.random.RandomState(0).randn(*in_shape).astype(np.float32)
    jblk = jmake()
    jblk.initialize()
    tblk = tmake().initialize(device="cpu")
    deferred = [p for p in tblk.collect_params().values() if 0 in p.shape]
    assert deferred                     # a bias of known shape is drawn
    for p in deferred:
        with pytest.raises(tgluon.DeferredInitializationError):
            p.data()
    with pytest.raises(MXNetError, match="fully initialized"):
        FusedTrainStep(tblk, lambda n, a: n(a).sum(), "sgd")
    jblk(mx.np.array(x))
    tblk(torch.from_numpy(x))
    want = {n: _port_shape(kind, tuple(p.shape))
            for n, p in jblk.collect_params().items()}
    got = {n: tuple(p.shape) for n, p in tblk.collect_params().items()}
    assert got == want
    assert {n: tuple(p.data().shape)
            for n, p in tblk.collect_params().items()} == want
    assert dict(tblk.named_parameters()).keys() | \
        dict(tblk.named_buffers()).keys() == set(want)


def test_deferred_values_equal_eager_ones_and_land_on_the_input_device():
    lazy = tgluon.nn.HybridSequential(tgluon.nn.Dense(6),
                                      tgluon.nn.LayerNorm(),
                                      tgluon.nn.Dense(3))
    eager = tgluon.nn.HybridSequential(tgluon.nn.Dense(6, in_units=4),
                                       tgluon.nn.LayerNorm(in_channels=6),
                                       tgluon.nn.Dense(3, in_units=6))
    lazy.initialize(device="cpu", seed=9)
    eager.initialize(device="cpu", seed=9)
    x = torch.randn(2, 4)
    torch.testing.assert_close(lazy(x), eager(x), rtol=0, atol=0)
    for (n, a), (_, b) in zip(lazy.collect_params().items(),
                              eager.collect_params().items()):
        assert torch.equal(a.data(), b.data()), n
        assert a.data().device == x.device


def test_nhwc_conv_weight_is_drawn_channels_last():
    conv = tgluon.nn.Conv2D(8, 3, layout="NHWC").initialize(device="cpu")
    conv(torch.zeros(1, 5, 5, 4))
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)


def test_grad_req_write_add_null_on_parameters():
    net = tgluon.nn.Dense(2, in_units=3, use_bias=False).initialize(
        device="cpu", seed=1)
    p = net.collect_params()["weight"]
    x = torch.ones(1, 3)

    def backward():
        with ag.record():
            y = net(x).sum()
        ag.backward(y)

    backward()
    backward()
    assert torch.equal(p.grad(), torch.ones(2, 3))          # write
    p.grad_req = "add"
    backward()
    backward()
    assert torch.equal(p.grad(), torch.full((2, 3), 2.0))   # add, fresh
    p.zero_grad()
    assert torch.equal(p.grad(), torch.zeros(2, 3))
    p.grad_req = "null"
    with pytest.raises(MXNetError, match="grad_req='null'"):
        p.grad()
    assert not p.data().requires_grad
    with pytest.raises(MXNetError, match="invalid grad_req"):
        p.grad_req = "sometimes"


def test_add_mode_starts_over_after_a_step():
    """grad_req "add": the first backward after a Trainer step overwrites,
    as the JAX package's fresh flag does."""
    for mod, trainer_cls in ((jgluon, jgluon.Trainer),
                             (tgluon, tgluon.Trainer)):
        net = mod.nn.Dense(1, in_units=2, use_bias=False)
        if mod is jgluon:
            net.initialize()
            net.collect_params()["weight"].set_data(mx.np.ones((1, 2)))
            x = mx.np.ones((1, 2))
            rec, back = mx.autograd.record, lambda y: y.backward()
        else:
            net.initialize(device="cpu")
            net.collect_params()["weight"].set_data(torch.ones(1, 2))
            x = torch.ones(1, 2)
            rec, back = ag.record, ag.backward
        net.collect_params()["weight"].grad_req = "add"
        tr = trainer_cls(net.collect_params(), "sgd", {"learning_rate": 0})
        for _ in range(2):
            with rec():
                y = net(x).sum()
            back(y)
        tr.step(1)
        with rec():
            y = net(x).sum()
        back(y)
        g = net.collect_params()["weight"].grad()
        g = g.asnumpy() if mod is jgluon else g.numpy()
        np.testing.assert_array_equal(g, np.ones((1, 2), np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_and_zero_grad(dtype):
    net = tgluon.nn.Dense(4, in_units=3).initialize(device="cpu", seed=2)
    w32 = net.weight.detach().clone()
    net.cast(dtype)
    for p in net.collect_params().values():
        assert p.dtype == dtype and p.data().dtype == getattr(torch, dtype)
    assert torch.equal(net.weight.float(), w32.to(getattr(torch,
                                                          dtype)).float())
    with ag.record():
        y = net(torch.ones(2, 3, dtype=getattr(torch, dtype))).sum()
    ag.backward(y)
    assert net.weight.grad.dtype == getattr(torch, dtype)
    net.zero_grad()
    assert not net.weight.grad.any()


def test_set_data_constant_and_reset_ctx():
    net = tgluon.nn.Dense(2).initialize(device="cpu")
    p = net.collect_params()["weight"]
    p.set_data(torch.full((2, 5), 0.5))            # resolves the deferred
    assert p.shape == (2, 5) and torch.equal(net.weight,
                                             torch.full((2, 5), 0.5))
    with pytest.raises(MXNetError, match="set_data shape"):
        p.set_data(torch.zeros(3, 5))
    p.reset_ctx("cpu")
    assert p.data().device.type == "cpu"
    c = tgluon.Constant(np.arange(4, dtype=np.float32))
    c.initialize(device=torch.device("cpu"))
    assert c.grad_req == "null"
    np.testing.assert_array_equal(c.data().numpy(), np.arange(4))


def test_share_parameters_holds_one_tensor():
    a = tgluon.nn.Dense(3, in_units=2).initialize(device="cpu", seed=3)
    b = tgluon.nn.Dense(3, in_units=2).initialize(device="cpu", seed=4)
    b.share_parameters(a.collect_params())
    assert b.collect_params()["weight"] is a.collect_params()["weight"]
    assert b.weight is a.weight
    x = torch.randn(4, 2)
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    a.collect_params()["weight"].set_data(torch.zeros(3, 2))
    assert not b.weight.any()
    a.collect_params()["weight"].cast("float16")
    assert b.weight.dtype == torch.float16


def _nets():
    """A small NHWC conv net in both packages, built without channel
    counts: conv, BatchNorm, relu, pool, Dense."""
    def build(gluon):
        nn = gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(6, 3, layout="NHWC", use_bias=True),
                nn.BatchNorm(axis=-1), nn.Activation("relu"),
                nn.GlobalAvgPool2D(layout="NHWC"), nn.Flatten(),
                nn.Dense(4))
        return net
    return build(jgluon), build(tgluon)


def _set_random(jnet, seed):
    rng = np.random.RandomState(seed)
    for n, p in jnet.collect_params().items():
        v = rng.randn(*p.shape).astype(np.float32) * 0.3
        if n.endswith("running_var"):
            v = np.abs(v) + 1.0
        p.set_data(mx.np.array(v))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_parameters_loads_in_the_other_package(writer, tmp_path):
    x = np.random.RandomState(5).randn(2, 7, 7, 3).astype(np.float32)
    jnet, tnet = _nets()
    jnet.initialize()
    jnet(mx.np.array(x))
    tnet.initialize(device="cpu", seed=7)
    f = str(tmp_path / "net.params")
    if writer == "jax":
        _set_random(jnet, 11)
        jnet.save_parameters(f)
        tnet.load_parameters(f, device="cpu")       # resolves every shape
    else:
        tnet(torch.from_numpy(x))
        tnet.save_parameters(f)
        jnet.load_parameters(f)
    with np.load(f) as saved:
        assert sorted(saved.files) == sorted(jnet.collect_params())
        assert saved["0.weight"].shape == (3, 3, 3, 6)           # HWIO
    want = jnet(mx.np.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # load_dict takes the same layout
    vals = {n: np.asarray(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}
    _, other = _nets()
    other.initialize(device="cpu")
    other.load_dict(vals)
    np.testing.assert_allclose(other(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=RTOL, atol=1e-6)


def test_load_refuses_missing_and_extra_names(tmp_path):
    net = tgluon.nn.Dense(2, in_units=3).initialize(device="cpu")
    f = str(tmp_path / "d.params")
    net.save_parameters(f)
    other = tgluon.nn.HybridSequential(tgluon.nn.Dense(2, in_units=3))
    other.initialize(device="cpu")
    with pytest.raises(MXNetError, match="missing"):
        other.load_parameters(f, ignore_extra=True)
    with pytest.raises(MXNetError, match="extra parameters"):
        other.load_parameters(f, allow_missing=True)
    other.load_parameters(f, allow_missing=True, ignore_extra=True)
