"""PyTorch port: ResNet v2, MobileNet v1/v2, `get_model` and
`FusedInferStep` against the JAX package.

Nets hold the same values in both packages (`torch_port_utils.vision_pair`,
made with numpy from a seed, carried across with `gluon.params_from_jax`).
The JAX fused ops run their Pallas kernels in interpret mode, as
tests/test_fused_ops.py runs them; the port's fused ops take their plain
versions on the CPU.

Tolerances: float32 on both sides, summation orders differ (XLA's CPU
convolutions and reductions against PyTorch's): forwards within 1e-4
relative + 1e-5 absolute; the training step as
tests/test_torch_resnet_train.py holds ResNet v1 (1e-4 relative on losses,
2e-4 relative + 2e-5 absolute on every weight and running stat).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import (FusedInferStep as JInfer,
                                               FusedTrainStep as JStep)
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon.contrib import (FusedInferStep as TInfer,
                                                     FusedTrainStep as TStep)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.ops import fused as tfused

from torch_port_utils import (assert_values_close, jax_values, port_values,
                              vision_pair)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-4
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
SMALL = dict(layers=[1, 1], channels=[8, 16, 32], classes=10)


def _small_v2(layout, thumbnail=False):
    return lambda v: v.ResNetV2(v.BottleneckV2, thumbnail=thumbnail,
                                layout=layout, **SMALL)


def _images(layout, seed=1, batch=2, hw=32):
    x = np.random.RandomState(seed).randn(batch, 3, hw, hw).astype(
        np.float32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) \
        if layout == "NHWC" else x


def _labels(seed=2, batch=2):
    return np.random.RandomState(seed).randint(0, 10, size=batch).astype(
        np.int32)


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_v2_names_and_shapes_match_jax(depth, layout):
    """The full-width nets: every structural name and value shape (the
    port's in the JAX package's layout), after one forward at 64x64
    resolves the deferred shapes."""
    jnet = getattr(jvision, f"resnet{depth}_v2")(layout=layout)
    jnet.initialize()
    jnet(mx.np.zeros((1, 64, 64, 3) if layout == "NHWC" else (1, 3, 64,
                                                             64)))
    tnet = getattr(tvision, f"resnet{depth}_v2")(layout=layout,
                                                  device="cpu")
    tnet(torch.zeros((1, 64, 64, 3) if layout == "NHWC" else (1, 3, 64,
                                                             64)))
    want = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    got = {n: tuple(tnet._file_layout(n, p.data()).shape)
           for n, p in tnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want
    frozen = [n for n, p in tnet.collect_params().items()
              if p.grad_req == "null"]
    assert "features.0.gamma" in frozen and "features.0.beta" in frozen


@pytest.mark.parametrize("fusion", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_v2_forward_matches_jax(layout, fusion):
    """Predict-mode forward (running stats) at 32x32, batch 2, fusion on
    (the JAX fused ops in interpret mode) and off."""
    jnet, tnet = vision_pair(_small_v2(layout), _images(layout).shape)
    x = _images(layout, seed=3)
    prev = jfused.set_interpret(True)
    try:
        with jfused.fusion_scope(fusion):
            want = jnet(mx.np.array(x)).asnumpy()
    finally:
        jfused.set_interpret(prev)
    with tfused.fusion_scope(fusion):
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_resnet_v2_train_step_matches_jax(layout):
    """Two SGD-momentum FusedTrainStep steps, fusion on in both packages:
    losses, every weight and every BN running stat."""
    jnet, tnet = vision_pair(_small_v2(layout), _images(layout).shape,
                             seed=4)
    x, y = _images(layout, seed=5, batch=4), _labels(6, batch=4)
    sgd = dict(learning_rate=0.1, momentum=0.9, rescale_grad=0.25)
    jL, tL = (jgluon.loss.SoftmaxCrossEntropyLoss(),
              tgluon.loss.SoftmaxCrossEntropyLoss())
    jstep = JStep(jnet, lambda n, a, b: jL(n(a), b).sum(),
                  jopt.create("sgd", **sgd), use_fusion=True)
    tstep = TStep(tnet, lambda n, a, b: tL(n(a), b).sum(),
                  topt.create("sgd", **sgd), use_fusion=True)
    prev = jfused.set_interpret(True)
    try:
        want = [float(jstep(mx.np.array(x), mx.np.array(y)).asnumpy())
                for _ in range(2)]
    finally:
        jfused.set_interpret(prev)
    got = [float(tstep(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_values_close(port_values(tnet), jax_values(jnet), STEP_RTOL,
                        STEP_ATOL, "after 2 steps:")


@pytest.mark.parametrize("version", [1, 2])
def test_mobilenet_forward_matches_jax(version):
    """MobileNet v1 / v2 at multiplier 0.25 (NCHW, grouped depthwise
    convolutions, ReLU6 in v2), 10 classes, 32x32, batch 2."""
    def make(v):
        klass = v.MobileNet if version == 1 else v.MobileNetV2
        return klass(0.25, classes=10)
    jnet, tnet = vision_pair(make, (2, 3, 32, 32), seed=7)
    x = _images("NCHW", seed=8)
    want = jnet(mx.np.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


PORTED = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
          "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
          "resnet101_v2", "resnet152_v2", "mobilenet1.0", "mobilenet0.75",
          "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
          "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25"]


@pytest.mark.parametrize("name", ["resnet18_v2", "mobilenet0.25",
                                  "MobileNetV2_0.25", "resnet34_v1"])
def test_get_model_builds_the_jax_packages_architecture(name):
    tnet = tvision.get_model(name, classes=7, device="cpu")
    jnet = jvision.get_model(name, classes=7)
    assert type(tnet).__name__ == type(jnet).__name__
    assert tnet(torch.zeros(1, 3, 32, 32)).shape == (1, 7)
    jnet.initialize()
    jnet(mx.np.zeros((1, 3, 32, 32)))
    assert list(tnet.collect_params()) == list(jnet.collect_params())


def test_get_model_names(tmp_path):
    """Every name of the JAX package's zoo is the port's (the families
    other than ResNet and MobileNet: tests/test_torch_vision_families.py)."""
    assert set(PORTED) <= set(tvision._models)
    assert sorted(tvision._models) == sorted(jvision._models)
    with pytest.raises(MXNetError, match="not in the zoo"):
        tvision.get_model("resnet19_v3")
    with pytest.raises(MXNetError, match="no pretrained weights for "
                       "'resnet18_v2'"):
        tvision.get_model("resnet18_v2", pretrained=True,
                          root=str(tmp_path), device="cpu")


@pytest.mark.parametrize("fusion", [True, False], ids=["fused", "plain"])
def test_fused_infer_step_chain_matches_jax(fusion):
    """Three chained calls, x <- x + 0.1 * mean(logits): the third call's
    logits, inference mode (running stats), nothing taped."""
    jnet, tnet = vision_pair(_small_v2("NHWC"), _images("NHWC").shape,
                             seed=9)
    x = _images("NHWC", seed=10)
    prev = jfused.set_interpret(True)
    try:
        jstep = JInfer(jnet, perturb=0.1, use_fusion=fusion)
        jstep(mx.np.array(x))
        jstep()
        want = jstep().asnumpy()
    finally:
        jfused.set_interpret(prev)
    tstep = TInfer(tnet, perturb=0.1, use_fusion=fusion)
    xt = torch.from_numpy(x.copy())
    first = tstep(xt)
    tstep()
    got = tstep()
    assert torch.equal(xt, torch.from_numpy(x))    # the seed is copied
    assert got.grad_fn is None and first.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_infer_step_steps_per_call_and_refusals():
    _, tnet = vision_pair(_small_v2("NHWC", thumbnail=True),
                          (2, 8, 8, 3), seed=11)
    x = torch.from_numpy(_images("NHWC", seed=12, hw=8))
    one = TInfer(tnet, perturb=0.1)
    one(x)
    second = one()
    two = TInfer(tnet, perturb=0.1, steps_per_call=2)
    torch.testing.assert_close(two(x), second, rtol=1e-6, atol=1e-6)
    with pytest.raises(MXNetError, match="seed the chain"):
        TInfer(tnet)()
    deferred = tvision.MobileNet(0.25, classes=3).initialize(device="cpu")
    with pytest.raises(MXNetError, match="FusedInferStep needs a fully "
                                         "initialized net: run one forward "
                                         "pass first"):
        TInfer(deferred)
