"""PyTorch port: the vision families beyond ResNet and MobileNet
(AlexNet, VGG with and without BN, SqueezeNet, DenseNet, Inception v3)
and `get_model` against the JAX package.

Every one of the 16 names at full width: the structural names and value
shapes (the port's in the JAX package's layout) after one forward at the
family's smallest valid input resolves the deferred shapes, and the
port's `save_parameters` file loaded by the JAX net, value for value. Then one
forward per family at that input, the nets holding the same values (made
with numpy from a seed, carried across with `gluon.params_from_jax`),
predict mode (running statistics, no dropout). The families take no
layout, as in the JAX package: channels first.

Tolerance: float32 on both sides, XLA's and PyTorch's CPU convolutions
and reductions summing in another order: within 1e-5 of the largest
logit (relative to the output's size; up to 120 layers deep).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.ops import fused as tfused
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import (assert_values_close, jax_values, port_values,
                              vision_pair)

torch.set_num_threads(1)

RTOL = 1e-5
# the smallest input each family takes (its last pool needs its window)
SMALLEST = {"alexnet": 63, "vgg": 32, "squeezenet": 32, "densenet": 224,
            "inception": 299}
NAMES = ["alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
         "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
         "squeezenet1.1", "densenet121", "densenet161", "densenet169",
         "densenet201", "inceptionv3"]


def _family(name):
    return next(f for f in SMALLEST if name.startswith(f))


def _zeros(name):
    hw = SMALLEST[_family(name)]
    return (1, 3, hw, hw)


@pytest.mark.parametrize("name", NAMES)
def test_names_and_shapes_match_jax(name, tmp_path):
    """... and the port's `.npz` loads into the JAX net value for value."""
    jnet = jvision.get_model(name, classes=10)
    jnet.initialize()
    jnet(mx.np.zeros(_zeros(name)))
    tnet = tvision.get_model(name, classes=10, device="cpu")
    assert type(tnet).__name__ == type(jnet).__name__
    out = tnet(torch.zeros(_zeros(name)))
    assert out.shape == (1, 10)
    want = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    got = {n: tuple(tnet._file_layout(n, p.data()).shape)
           for n, p in tnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want
    f = str(tmp_path / "net.npz")
    tnet.save_parameters(f)
    jnet.load_parameters(f)
    assert_values_close(jax_values(jnet), port_values(tnet), 0, 0, name)


@pytest.mark.parametrize("name", ["alexnet", "vgg11_bn", "squeezenet1.1",
                                  "densenet121", "inceptionv3"])
def test_forward_matches_jax(name):
    make = lambda v: v.get_model(name, classes=10, **(  # noqa: E731
        {"device": "cpu"} if v is tvision else {}))
    jnet, tnet = vision_pair(make, _zeros(name), seed=11)
    x = np.random.RandomState(12).rand(*_zeros(name)).astype(np.float32)
    want = jnet(mx.np.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 10)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_dense_relu_pairs_take_the_apply_kernel_in_a_fusion_scope():
    """AlexNet's and VGG's two Dense(4096, relu) are the families' only
    fused ops (channels first: every convolution, BatchNorm and pool
    stays plain); the apply's dispatcher takes its plain version on the
    CPU."""
    net = tvision.alexnet(classes=10, device="cpu")
    x = torch.rand(2, 3, 63, 63)
    plain = net(x)
    calls = []
    orig = tfused._apply_fwd

    def counting(x2d, *a):
        calls.append(tuple(x2d.shape))
        return orig(x2d, *a)
    tfused._apply_fwd = counting
    try:
        with tfused.fusion_scope(True):
            fused = net(x)
    finally:
        tfused._apply_fwd = orig
    assert calls == [(2, 4096), (2, 4096)]
    torch.testing.assert_close(fused, plain, rtol=1e-6, atol=1e-6)
    assert kernels.launch_counts()["scale_shift_act"] == 0


def test_get_model_builds_every_jax_name():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    with pytest.raises(MXNetError, match="not in the zoo"):
        tvision.get_model("vgg17")
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.get_model("densenet121", pretrained=True, device="cpu")
    with pytest.raises(MXNetError, match="version"):
        tvision.SqueezeNet("1.2")
