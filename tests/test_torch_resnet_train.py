"""PyTorch port: ResNet v1 training through FusedTrainStep against the JAX
package.

A small `ResNetV1(BottleneckV1, [1, 1], [8, 16, 32], classes=10,
layout="NHWC")` — with the thumbnail stem on 8x8 images and with the full
stem (conv7 s2, BN, relu, maxpool) on 32x32 images — holds the same values
in both packages (`torch_port_utils.resnet_pair`, carried across with
`gluon.params_from_jax`). The JAX step runs with fusion on and its Pallas
kernels in interpret mode, as tests/test_fused_ops.py runs them; the port's
step runs on the CPU, where its fused ops take their plain versions.

Tolerances: float32 on both sides, summation orders differ (XLA's CPU
convolutions and reductions against PyTorch's), and three SGD-momentum
steps carry the differences forward: 1e-4 relative on losses, 2e-4
relative + 2e-5 absolute on every weight and running stat. Under bf16 AMP
both packages round at the same op boundaries but their bf16 convolutions
and products accumulate differently: 2e-2 relative on the loss.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.ops import fused as tfused, kernels

from torch_port_utils import (resnet_pair, resnet_batch, jax_values,
                              port_values, assert_values_close,
                              jax_amp_restored)

torch.set_num_threads(1)

STEPS = 3
LOSS_RTOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
SGD = dict(learning_rate=0.1, momentum=0.9)


def _jax_train(jnet, x, y, steps=STEPS):
    L = jgluon.loss.SoftmaxCrossEntropyLoss()
    opt = jopt.create("sgd", rescale_grad=1.0 / len(y), **SGD)
    step = JStep(jnet, lambda n, a, b: L(n(a), b).sum(), opt,
                 use_fusion=True)
    prev = jfused.set_interpret(True)
    try:
        return [float(step(mx.np.array(x), mx.np.array(y)).asnumpy())
                for _ in range(steps)]
    finally:
        jfused.set_interpret(prev)


def _port_train(tnet, x, y, steps=STEPS, use_fusion=True):
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    opt = topt.create("sgd", rescale_grad=1.0 / len(y), **SGD)
    step = TStep(tnet, lambda n, a, b: L(n(a), b).sum(), opt,
                 use_fusion=use_fusion)
    return [float(step(x, y)) for _ in range(steps)]


@pytest.mark.parametrize("thumbnail", [True, False],
                         ids=["thumbnail8", "stem32"])
def test_forward_matches_jax(thumbnail):
    """Predict-mode forward (running stats) from the same values."""
    jnet, tnet = resnet_pair(thumbnail)
    x, _ = resnet_batch(thumbnail)
    want = jnet(mx.np.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (len(x), 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("thumbnail", [True, False],
                         ids=["thumbnail8", "stem32"])
def test_fused_train_steps_match_jax(thumbnail):
    """Three SGD-momentum FusedTrainStep steps, fusion on in both
    packages: losses, every weight and every BN running stat."""
    jnet, tnet = resnet_pair(thumbnail, seed=2)
    x, y = resnet_batch(thumbnail, seed=3)
    want = _jax_train(jnet, x, y)
    got = _port_train(tnet, x, y)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0], f"loss did not fall: {got}"
    assert_values_close(port_values(tnet), jax_values(jnet), RTOL, ATOL,
                        "after 3 steps:")


@pytest.mark.parametrize("steps_per_call", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip0.5"])
def test_fused_step_options_match_jax(clip, steps_per_call):
    """FusedTrainStep's `clip_global_norm` (0.5: well under the gradients'
    global norm, so every step clips) and `steps_per_call=2` (inputs with a
    leading K axis, K losses a call) against the JAX package's step: Adam,
    whose update reads each inner step's own count, two calls, fusion on
    in both packages."""
    jnet, tnet = resnet_pair(True, seed=6)
    batches = [resnet_batch(True, seed=7 + k) for k in range(2 * steps_per_call)]
    xs = np.stack([b[0] for b in batches])
    ys = np.stack([b[1] for b in batches])
    adam = dict(learning_rate=1e-2, rescale_grad=1.0 / len(ys[0]))
    jL, tL = (jgluon.loss.SoftmaxCrossEntropyLoss(),
              tgluon.loss.SoftmaxCrossEntropyLoss())
    jstep = JStep(jnet, lambda n, a, b: jL(n(a), b).sum(),
                  jopt.create("adam", **adam), clip_global_norm=clip,
                  steps_per_call=steps_per_call, use_fusion=True)
    tstep = TStep(tnet, lambda n, a, b: tL(n(a), b).sum(),
                  topt.create("adam", **adam), clip_global_norm=clip,
                  steps_per_call=steps_per_call, use_fusion=True)
    calls = [(xs[k], ys[k]) for k in range(2)] if steps_per_call == 1 else \
        [(xs[2 * k:2 * k + 2], ys[2 * k:2 * k + 2]) for k in range(2)]
    prev = jfused.set_interpret(True)
    try:
        want = [np.asarray(jstep(mx.np.array(x), mx.np.array(y)).asnumpy())
                for x, y in calls]
    finally:
        jfused.set_interpret(prev)
    got = [tstep(x, y).numpy() for x, y in calls]
    assert got[0].shape == (() if steps_per_call == 1 else (2,))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_values_close(port_values(tnet), jax_values(jnet), RTOL, ATOL,
                        f"clip {clip}, K {steps_per_call}:")


def test_fusion_on_matches_fusion_off():
    """The port's fused step (fused ops) against its unfused step (plain
    ops) from the same values."""
    _, fused_net = resnet_pair(False, seed=4)
    _, plain_net = resnet_pair(False, seed=4)
    x, y = resnet_batch(False, seed=5)
    a = _port_train(fused_net, x, y, use_fusion=True)
    b = _port_train(plain_net, x, y, use_fusion=False)
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    assert_values_close(port_values(fused_net), port_values(plain_net),
                        RTOL, ATOL, "fused vs plain:")


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "planted"])
def test_update_check_sees_a_dropped_bn_scale_gradient(fault, monkeypatch):
    """chip_smoke.py's fused-vs-unfused float32 check, at its learning
    rate and step count, on the small net: the per-value update reading
    stays far under its limit when sound, and goes over it when the apply
    backward drops dscale, a fault the step-2 loss barely shows."""
    chip_smoke = _load_chip_smoke()
    lr, steps = chip_smoke.CHECK_LR, chip_smoke.CHECK_STEPS
    _, init_net = resnet_pair(False, seed=10)
    nets = [resnet_pair(False, seed=10)[1] for _ in range(2)]
    x, y = resnet_batch(False, seed=11)
    if fault:
        orig = tfused._apply_bwd

        def no_dscale(ctx, ct, x2d, scale, shift, res):
            dx, _, dshift, dres = orig(ctx, ct, x2d, scale, shift, res)
            return dx, None, dshift, dres
        monkeypatch.setattr(tfused, "_apply_bwd", no_dscale)
    losses = []
    for net, use_fusion in zip(nets, (True, False)):
        L = tgluon.loss.SoftmaxCrossEntropyLoss()
        opt = topt.create("sgd", learning_rate=lr, momentum=0.9,
                          rescale_grad=1.0 / len(y))
        step = TStep(net, lambda n, a, b: L(n(a), b).sum(), opt,
                     use_fusion=use_fusion)
        losses.append([float(step(x, y)) for _ in range(steps)])
    np.testing.assert_allclose(*losses, rtol=chip_smoke.CHECK_LOSS_RTOL)
    rel = chip_smoke.update_parting(init_net.collect_params(),
                                    nets[0].collect_params(),
                                    nets[1].collect_params())
    worst = max(rel.values())
    if fault:
        assert worst > 2 * chip_smoke.CHECK_UPDATE_RTOL, rel
    else:
        assert worst < 1e-3, rel


@jax_amp_restored()
def test_amp_bf16_step_matches_jax():
    """One step under bf16 AMP in both packages (the JAX package's op
    lists and classes: convs and the dense in bf16, the fused BN in f32,
    the pool in bf16, log_softmax in f32)."""
    jnet, tnet = resnet_pair(False, seed=6)
    x, y = resnet_batch(False, seed=7)
    jamp.init("bfloat16")
    try:
        want = _jax_train(jnet, x, y, steps=2)
    finally:
        jamp.uninit()
    tamp.init("bfloat16")
    try:
        got = _port_train(tnet, x, y, steps=2)
    finally:
        tamp.uninit()
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_train_step_launches_no_kernel_on_cpu_and_takes_k_steps():
    """On the CPU the fused ops take their plain versions (no launch);
    steps_per_call=K consumes a leading K axis and returns K losses,
    which equal K single steps."""
    _, net_a = resnet_pair(True, seed=8)
    _, net_b = resnet_pair(True, seed=8)
    x, y = resnet_batch(True, seed=9)
    kernels.reset_launch_counts()
    single = _port_train(net_a, x, y, steps=2)
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    step = TStep(net_b, lambda n, a, b: L(n(a), b).sum(),
                 topt.create("sgd", rescale_grad=1.0 / len(y), **SGD),
                 steps_per_call=2)
    losses = step(np.stack([x, x]), np.stack([y, y]))
    assert tuple(losses.shape) == (2,)
    np.testing.assert_allclose(losses.numpy(), single, rtol=1e-6)
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(MXNetError, match="torch.cuda.is_available"):
        tvision.resnet50_v1()
    with pytest.raises(MXNetError, match="unknown remat policy"):
        _, net = resnet_pair(True)
        TStep(net, lambda n, a, b: None, "sgd", remat="bogus")


def test_params_from_jax_refuses_unknown_and_missing_names():
    jnet, tnet = resnet_pair(True)
    values = jax_values(jnet)
    extra = dict(values, **{"features.9.weight": np.zeros(3, np.float32)})
    with pytest.raises(MXNetError, match="unknown names"):
        tgluon.params_from_jax(tnet, extra)
    short = dict(values)
    short.pop("output.bias")
    with pytest.raises(MXNetError, match="missing names"):
        tgluon.params_from_jax(tnet, short)


def test_resnet50_names_and_shapes_match_jax():
    """The full ResNet-50 v1 (NHWC, 1000 classes): every structural name
    of the JAX package, with its shape in the port's layout."""
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    jnet = jvision.resnet50_v1(layout="NHWC")
    jnet.initialize()
    jnet(mx.np.zeros((1, 32, 32, 3)))
    tnet = tvision.ResNetV1(tvision.BottleneckV1, [3, 4, 6, 3],
                            [64, 256, 512, 1024, 2048], layout="NHWC")
    jshapes = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    tshapes = {n: tuple(t.shape) for n, t in tnet.collect_params().items()}
    assert list(jshapes) == list(tshapes)
    for n, s in jshapes.items():
        want = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
        assert tshapes[n] == want, n
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 25_610_152
