"""PyTorch port: SSD300 (`gluon.model_zoo.detection`) against the JAX
package's, at 300x300 in float32, in both layouts.

The nets hold the same values, made with numpy from a seed and carried
into the port with `gluon.params_from_jax`. Checked: every structural
name and value shape (the port's in the JAX package's layout), the `.npz`
the port writes loading into the JAX net, the 8732 anchors, the forward,
`targets` and `detect`, and one training step.

Tolerances: the forward is 23 float32 convolutions deep and XLA's and
PyTorch's CPU convolutions sum in another order, so its outputs are held
within 1e-4 of their largest value; the anchors within 1e-6. `targets`
and the decode under `detect` take the same numpy inputs in both packages
(the JAX forward's outputs): class targets and ids exactly equal, floats
within 1e-6 (an IoU within an ulp of a threshold would flip a row, so
they are not fed each package's own forward). The training step (plain
ops in both packages, the targets made once beforehand) as
tests/test_torch_resnet_train.py holds ResNet: losses within 1e-4
relative, every value within 2e-4 relative + 2e-5 absolute.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import numpy_extension as jnpx
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu.gluon.model_zoo import detection as jdet
from incubator_mxnet_tpu.ops import contrib as jcontrib

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.gluon.model_zoo import detection as tdet
from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import nn as tops

from torch_port_utils import assert_values_close, jax_values, port_values

torch.set_num_threads(1)

CLASSES = 3
ANCHORS = 8732
FWD_RTOL = 1e-4
RTOL = ATOL = 1e-6
LOSS_RTOL = 1e-4
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
_PAIRS = {}


def _shape(layout, batch=1):
    return (batch, 3, 300, 300) if layout == "NCHW" else (batch, 300, 300, 3)


def _value(name, shape, layout, rng):
    """He-scaled weights (fan-in of the layout's storage), 0.1-scaled
    biases."""
    if name.endswith("bias"):
        return 0.1 * rng.randn(*shape)
    out_ch = shape[0] if layout == "NCHW" else shape[-1]
    return rng.randn(*shape) * np.sqrt(2.0 / (np.prod(shape) / out_ch))


def _pair(layout):
    """(JAX SSD300, port SSD300 on the CPU) holding the same values; built
    once per layout for the module."""
    if layout not in _PAIRS:
        jnet = jdet.ssd_300_vgg16(classes=CLASSES, layout=layout)
        jnet.initialize()
        jnet(mx.np.zeros(_shape(layout)))
        rng = np.random.RandomState(0)
        values = {}
        for name, p in jnet.collect_params().items():
            values[name] = _value(name, p.shape, layout, rng).astype(
                np.float32)
            p.set_data(mx.np.array(values[name]))
        tnet = tdet.ssd_300_vgg16(classes=CLASSES, layout=layout,
                                  device="cpu")
        tgluon.params_from_jax(tnet, values)
        _PAIRS[layout] = jnet, tnet
    return _PAIRS[layout]


def _images(layout, seed=1, batch=1):
    x = np.random.RandomState(seed).rand(batch, 3, 300, 300).astype(
        np.float32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) \
        if layout == "NHWC" else x


def _labels(seed=2, batch=1, rows=4):
    """[cls, x1, y1, x2, y2] rows, 1-3 boxes an image, padded with -1."""
    rng = np.random.RandomState(seed)
    out = -np.ones((batch, rows, 5), np.float32)
    for b in range(batch):
        for g in range(rng.randint(1, rows)):
            xy = rng.rand(2) * 0.6
            out[b, g] = [rng.randint(0, CLASSES), *xy,
                         *(xy + 0.1 + rng.rand(2) * 0.3)]
    return out


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_ssd300_names_and_shapes_match_jax(layout):
    jnet, tnet = _pair(layout)
    want = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    got = {n: tuple(tnet._file_layout(n, p.data()).shape)
           for n, p in tnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want
    assert len(want) == 2 * (23 + 12)    # 23 conv + ReLU, 12 heads


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_ssd300_forward_matches_jax(layout):
    jnet, tnet = _pair(layout)
    x = _images(layout)
    want = [a.asnumpy() for a in jnet(mx.np.array(x))]
    got = [a.numpy() for a in tnet(torch.from_numpy(x))]
    assert got[0].shape == (1, ANCHORS, 4)
    assert got[1].shape == (1, ANCHORS, CLASSES + 1)
    assert got[2].shape == (1, ANCHORS * 4)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= FWD_RTOL * np.abs(w).max()


def _jax_forward(layout):
    jnet, _ = _pair(layout)
    return [np.array(a.asnumpy())
            for a in jnet(mx.np.array(_images(layout)))]


def test_ssd300_targets_match_jax():
    """`targets` on the same inputs (the JAX forward's), negative mining
    at ratio 3."""
    jnet, tnet = _pair("NHWC")
    anchors, cls_preds, _ = _jax_forward("NHWC")
    labels = _labels()
    want = [a.asnumpy() for a in jnet.targets(
        mx.np.array(anchors), mx.np.array(labels), mx.np.array(cls_preds))]
    got = [a.numpy() for a in tnet.targets(
        torch.from_numpy(anchors), torch.from_numpy(labels),
        torch.from_numpy(cls_preds))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert (got[2] > 0).any() and (got[2] == 0).any() \
        and (got[2] == -1).any()


def test_ssd300_detect_matches_jax():
    """The decode and NMS of `detect` over all 8732 rows on the same
    probabilities in both packages; `detect` itself is that decode of the
    port's own forward."""
    _, tnet = _pair("NHWC")
    anchors, cls_preds, loc_preds = _jax_forward("NHWC")
    e = np.exp(cls_preds - cls_preds.max(axis=-1, keepdims=True))
    probs = np.ascontiguousarray(
        (e / e.sum(axis=-1, keepdims=True)).transpose(0, 2, 1))
    import jax.numpy as jnp
    want = np.asarray(jcontrib.multibox_detection(
        jnp.asarray(probs), jnp.asarray(loc_preds), jnp.asarray(anchors),
        nms_threshold=0.45, threshold=0.01))
    got = tcontrib.multibox_detection(
        torch.from_numpy(probs), torch.from_numpy(loc_preds),
        torch.from_numpy(anchors), nms_threshold=0.45,
        threshold=0.01).numpy()
    assert got.shape == (1, ANCHORS, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL)
    assert 0 < (got[..., 0] >= 0).sum() < ANCHORS

    x = torch.from_numpy(_images("NHWC"))
    a, c, lp = tnet(x)
    decoded = tcontrib.multibox_detection(
        torch.softmax(c, dim=-1).transpose(1, 2), lp, a, nms_threshold=0.45,
        threshold=0.01)
    assert torch.equal(tnet.detect(x), decoded)


def _ssd_loss(package, F):
    """examples/ssd_amp.py's loss over precomputed targets: CE over the
    class targets ignoring -1, Huber on loc x mask."""
    huber = package.loss.HuberLoss()

    def loss(net, x, loc_t, loc_m, cls_t):
        _, cls, box = net(x)
        valid = F.valid(cls_t)
        nll = -F.pick(F.log_softmax(cls), F.maximum(cls_t, 0))
        lcls = (nll * valid).sum() / F.maximum(valid.sum(), 1)
        return lcls + huber(box * loc_m, loc_t * loc_m).mean() * 4.0
    return loss


class _JaxF:
    valid = staticmethod(lambda t: (t >= 0).astype("float32"))
    pick = staticmethod(lambda x, i: jnpx.pick(x, i, axis=-1))
    maximum = staticmethod(mx.np.maximum)
    log_softmax = staticmethod(lambda c: jnpx.log_softmax(c, axis=-1))


class _TorchF:
    valid = staticmethod(lambda t: (t >= 0).float())
    pick = staticmethod(lambda x, i: tops.pick(x, i, axis=-1))
    maximum = staticmethod(lambda a, b: torch.clamp(a, min=b))
    log_softmax = staticmethod(lambda c: torch.log_softmax(c, dim=-1))


def test_ssd300_train_step_matches_jax():
    """One SGD-momentum FusedTrainStep step (NHWC, plain ops in both) on
    targets made once from the JAX forward: the loss and every value."""
    jnet, tnet = _pair("NHWC")
    x = _images("NHWC", seed=5)
    anchors, cls_preds, _ = _jax_forward("NHWC")
    targets = [a.asnumpy() for a in jnet.targets(
        mx.np.array(anchors), mx.np.array(_labels(6)),
        mx.np.array(cls_preds))]
    sgd = dict(learning_rate=0.01, momentum=0.9, wd=5e-4)
    jstep = JStep(jnet, _ssd_loss(jgluon, _JaxF), jopt.create("sgd", **sgd),
                  use_fusion=False)
    tstep = TStep(tnet, _ssd_loss(tgluon, _TorchF), topt.create("sgd", **sgd),
                  use_fusion=False)
    want = float(jstep(mx.np.array(x), *[mx.np.array(t)
                                         for t in targets]).asnumpy())
    got = float(tstep(x, *targets))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_values_close(port_values(tnet), jax_values(jnet), STEP_RTOL,
                        STEP_ATOL, "after 1 step:")
    _PAIRS.clear()     # the weights moved


def test_ssd300_npz_loads_into_jax(tmp_path):
    """The port's `save_parameters` file (NHWC: weights written kernel
    dims first) loads into the JAX package's SSD300 value for value."""
    tnet = tdet.ssd_300_vgg16(classes=CLASSES, layout="NHWC", device="cpu",
                              seed=5)
    tnet(torch.zeros(_shape("NHWC")))
    f = str(tmp_path / "ssd.npz")
    tnet.save_parameters(f)
    jnet = jdet.ssd_300_vgg16(classes=CLASSES, layout="NHWC")
    jnet.initialize()
    jnet(mx.np.zeros(_shape("NHWC")))
    jnet.load_parameters(f)
    assert_values_close(jax_values(jnet), port_values(tnet), 0, 0, "npz")


def test_ssd300_preset_refuses_pretrained():
    with pytest.raises(MXNetError, match="pretrained"):
        tdet.ssd_300_vgg16(pretrained=True, device="cpu")
    assert tdet.ssd_anchor_sizes() == jdet.ssd_anchor_sizes()
