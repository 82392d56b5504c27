"""gluon.model_zoo.vision of the PyTorch port: the JAX package's CNN catalog
and `get_model`.

Counterpart of `incubator_mxnet_tpu/gluon/model_zoo/vision.py`
(`BasicBlockV1`, `BottleneckV1`, `ResNetV1`, `BasicBlockV2`,
`BottleneckV2`, `ResNetV2`, `get_resnet`, `resnet{18,34,50,101,152}_v{1,2}`,
`AlexNet`, `VGG`, `vgg{11,13,16,19}[_bn]`, `SqueezeNet`,
`squeezenet1_{0,1}`, `DenseNet`, `densenet{121,161,169,201}`,
`MobileNet`, `MobileNetV2`, `LinearBottleneck`, `mobilenet{1_0,0_75,0_5,
0_25}`, `mobilenet_v2_{1_0,0_75,0_5,0_25}`, `Inception3`, `inception_v3`,
`get_model`), with the same child names, so `collect_params()` keys match
the JAX package's. Each
residual block takes the fused branch exactly when the JAX package's does
(inside a fusion scope, channels last): every BN (+ReLU) is one fused op,
and a v1 block's tail (BN + residual add + ReLU) is one fused op; a v2
(pre-activation) block's three BN + ReLU are fused ops and its residual
add is plain. The other families are channels-first only, as in the JAX
package, so the apply kernel runs only where a Dense with bias fuses its
activation (the two `Dense(4096, "relu")` of AlexNet and VGG, inside a
fusion scope); their convolutions, pools (DenseNet's transition average
pool included) and BatchNorms take the plain ops, and MobileNet's
depthwise convolutions go to cuDNN.

The model functions take `device=` (default: the card; without one they
raise) and `seed=`, and return an initialized net: random weights from the
seed (`HybridBlock.initialize`; another initializer through
`net.initialize(init, force_reinit=True)`), or the JAX package's through
`gluon.params_from_jax`. `pretrained=True` raises: the port downloads
nothing.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import fused as _fused
from ...ops import nn as _ops
from .. import nn
from ..block import HybridBlock

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "BasicBlockV2",
           "BottleneckV2", "ResNetV2", "get_resnet", "get_model",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "MobileNet", "MobileNetV2",
           "LinearBottleneck", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25",
           "AlexNet", "alexnet", "VGG", "get_vgg", "vgg11", "vgg13", "vgg16",
           "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "DenseNet",
           "get_densenet", "densenet121", "densenet161", "densenet169",
           "densenet201", "Inception3", "inception_v3"]


def _bn_axis(layout):
    return 1 if layout.startswith("NC") else -1


def _fuse(layout):
    """The fused branch: inside a fusion scope, channels last (the apply
    kernel takes channels last; a channels-first block stays plain)."""
    return _fused.fusion_enabled() and layout == "NHWC"


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self._layout = layout
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                                in_channels=in_channels, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                                in_channels=channels, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, 1, stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        if self.downsample is not None:
            residual = self.downsample(residual)
        if _fuse(self._layout):
            conv1, bn1, _act, conv2, bn2 = list(self.body)
            h = bn1.fused_forward(conv1(x), act_type="relu")
            return bn2.fused_forward(conv2(h), act_type="relu",
                                     residual=residual)
        return _ops.relu(_ops.add(self.body(x), residual))


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        mid = channels // 4
        self._layout = layout
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, 1, stride, use_bias=False,
                                in_channels=in_channels, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(mid, 3, 1, 1, use_bias=False,
                                in_channels=mid, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 1, 1, use_bias=False,
                                in_channels=mid, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, 1, stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        if self.downsample is not None:
            residual = self.downsample(residual)
        if _fuse(self._layout):
            (conv1, bn1, _a1, conv2, bn2, _a2,
             conv3, bn3) = list(self.body)
            h = bn1.fused_forward(conv1(x), act_type="relu")
            h = bn2.fused_forward(conv2(h), act_type="relu")
            return bn3.fused_forward(conv3(h), act_type="relu",
                                     residual=residual)
        return _ops.relu(_ops.add(self.body(x), residual))


class ResNetV1(HybridBlock):
    """ResNet v1 over 3-channel images; `layers`/`channels` as the JAX
    package's (`channels[0]` is the stem's width)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW"):
        super().__init__()
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(nn.Conv2D(channels[0], 3, 1, 1, use_bias=False,
                                        in_channels=3, layout=layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        in_channels=3, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax, in_channels=channels[0]))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], layout=layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, num_layers, channels, stride, in_channels=0,
                    layout="NCHW"):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout))
        for _ in range(num_layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BN-ReLU-conv3 twice, the identity (or
    a strided 1x1 conv of the first activation) added."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self._layout = layout
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                               in_channels=in_channels, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                               in_channels=channels, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        fuse = _fuse(self._layout)
        residual = x
        x = _bn_relu(self.bn1, x, fuse)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = _bn_relu(self.bn2, self.conv1(x), fuse)
        return _ops.add(self.conv2(x), residual)


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: BN-ReLU-conv1, BN-ReLU-conv3 (strided),
    BN-ReLU-conv1, the identity (or a strided 1x1 conv of the first
    activation) added."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self._layout = layout
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False,
                               layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1, use_bias=False,
                               layout=layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        fuse = _fuse(self._layout)
        residual = x
        x = _bn_relu(self.bn1, x, fuse)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = _bn_relu(self.bn2, self.conv1(x), fuse)
        x = _bn_relu(self.bn3, self.conv2(x), fuse)
        return _ops.add(self.conv3(x), residual)


def _bn_relu(bn, x, fuse):
    """BN then ReLU: one fused op on the fused branch."""
    return bn.fused_forward(x, act_type="relu") if fuse \
        else _ops.relu(bn(x))


class ResNetV2(HybridBlock):
    """ResNet v2 (pre-activation) over 3-channel images: a BN of the data
    (no scale, no centre), the stem, the stages, a final BN + ReLU, the
    global pool and the classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW"):
        super().__init__()
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(nn.Conv2D(channels[0], 3, 1, 1, use_bias=False,
                                        layout=layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(ResNetV1._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=in_channels, layout=layout))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def _no_download(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not supported by the port; "
                         "carry weights across with gluon.params_from_jax")


def _build(klass, *args, pretrained=False, device=None, seed=0, **kwargs):
    _no_download(pretrained)
    return klass(*args, **kwargs).initialize(device=device, seed=seed)


def get_resnet(version, num_layers, pretrained=False, device=None, seed=0,
               **kwargs):
    """A ResNet of the given version (1 or 2) and depth, initialized on
    `device` (default: the card) from `seed`."""
    _no_download(pretrained)
    if version not in (1, 2):
        raise MXNetError(f"no ResNet version {version}; 1 or 2")
    if num_layers not in _resnet_spec:
        raise MXNetError(f"no ResNet of depth {num_layers}; "
                         f"{sorted(_resnet_spec)}")
    block_type, layers, channels = _resnet_spec[num_layers]
    if version == 1:
        block = BasicBlockV1 if block_type == "basic_block" else BottleneckV1
        net = ResNetV1(block, layers, channels, **kwargs)
    else:
        block = BasicBlockV2 if block_type == "basic_block" else BottleneckV2
        net = ResNetV2(block, layers, channels, **kwargs)
    return net.initialize(device=device, seed=seed)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)


# ---------------------------------------------------------------------------
# MobileNet v1 / v2 (channels first, as in the JAX package)
# ---------------------------------------------------------------------------
def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu") if not relu6 else _ReLU6())


class _ReLU6(HybridBlock):
    def forward(self, x):
        return _ops.clip(x, 0, 6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, 3, stride, 1, num_group=dw_channels,
              relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: 1x1 expand (ReLU6), 3x3 depthwise
    (ReLU6), 1x1 project; the input added when the shapes allow."""

    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, 3, stride, 1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = _ops.add(out, x)
        return out


class MobileNet(HybridBlock):
    """MobileNet v1 at width `multiplier`."""

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2 at width `multiplier`."""

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), 3, 2, 1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                             + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                          + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_c, c, t, s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, use_bias=False))
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def mobilenet1_0(**kw): return _build(MobileNet, 1.0, **kw)
def mobilenet0_75(**kw): return _build(MobileNet, 0.75, **kw)
def mobilenet0_5(**kw): return _build(MobileNet, 0.5, **kw)
def mobilenet0_25(**kw): return _build(MobileNet, 0.25, **kw)
def mobilenet_v2_1_0(**kw): return _build(MobileNetV2, 1.0, **kw)
def mobilenet_v2_0_75(**kw): return _build(MobileNetV2, 0.75, **kw)
def mobilenet_v2_0_5(**kw): return _build(MobileNetV2, 0.5, **kw)
def mobilenet_v2_0_25(**kw): return _build(MobileNetV2, 0.25, **kw)


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------
class AlexNet(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(**kw): return _build(AlexNet, **kw)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------
class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        self.features = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], 3, padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(2, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, **kwargs):
    layers, filters = _vgg_spec[num_layers]
    return _build(VGG, layers, filters, **kwargs)


def vgg11(**kw): return get_vgg(11, **kw)
def vgg13(**kw): return get_vgg(13, **kw)
def vgg16(**kw): return get_vgg(16, **kw)
def vgg19(**kw): return get_vgg(19, **kw)
def vgg11_bn(**kw): return get_vgg(11, batch_norm=True, **kw)
def vgg13_bn(**kw): return get_vgg(13, batch_norm=True, **kw)
def vgg16_bn(**kw): return get_vgg(16, batch_norm=True, **kw)
def vgg19_bn(**kw): return get_vgg(19, batch_norm=True, **kw)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------
def _fire(squeeze, expand):
    """squeeze 1x1, then the 1x1 and 3x3 expands joined on the channels."""
    out = nn.HybridConcatenate(axis=1)
    left = nn.HybridSequential()
    right = nn.HybridSequential()
    out_pre = nn.HybridSequential()
    out_pre.add(nn.Conv2D(squeeze, 1, activation="relu"))
    left.add(nn.Conv2D(expand, 1, activation="relu"))
    right.add(nn.Conv2D(expand, 3, padding=1, activation="relu"))
    out.add(left)
    out.add(right)
    wrap = nn.HybridSequential()
    wrap.add(out_pre)
    wrap.add(out)
    return wrap


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise MXNetError("version must be 1.0 or 1.1")
        f = self.features = nn.HybridSequential()
        if version == "1.0":
            f.add(nn.Conv2D(96, 7, 2, activation="relu"))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(16, 64), _fire(16, 64), _fire(32, 128))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(32, 128), _fire(48, 192), _fire(48, 192),
                  _fire(64, 256))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(64, 256))
        else:
            f.add(nn.Conv2D(64, 3, 2, activation="relu"))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(16, 64), _fire(16, 64))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(32, 128), _fire(32, 128))
            f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            f.add(_fire(48, 192), _fire(48, 192), _fire(64, 256),
                  _fire(64, 256))
        f.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw): return _build(SqueezeNet, "1.0", **kw)
def squeezenet1_1(**kw): return _build(SqueezeNet, "1.1", **kw)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------
class _DenseLayerConcat(HybridBlock):
    """BN-ReLU-conv1x1-BN-ReLU-conv3x3 (+ dropout), its output joined to
    its input on the channels."""

    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return _ops.concat([x, self.body(x)], axis=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    out = nn.HybridSequential()
    for _ in range(num_layers):
        out.add(_DenseLayerConcat(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, 1, use_bias=False))
    out.add(nn.AvgPool2D(2, 2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                    use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(3, 2, 1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features //= 2
                self.features.add(_make_transition(num_features))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.AvgPool2D(7))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, **kwargs):
    return _build(DenseNet, *_densenet_spec[num_layers], **kwargs)


def densenet121(**kw): return get_densenet(121, **kw)
def densenet161(**kw): return get_densenet(161, **kw)
def densenet169(**kw): return get_densenet(169, **kw)
def densenet201(**kw): return get_densenet(201, **kw)


# ---------------------------------------------------------------------------
# Inception v3 (299x299 input)
# ---------------------------------------------------------------------------
def _conv_bn(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _InceptionBranch(HybridBlock):
    """Parallel branches (children "0", "1", ...) joined on the channels."""

    def __init__(self, *branches):
        super().__init__()
        for b in branches:
            self.register_child(b)

    def forward(self, x):
        return _ops.concat([b(x) for b in self._modules.values()], axis=1)


def _branch(*specs):
    out = nn.HybridSequential()
    for spec in specs:
        if spec[0] == "pool_avg":
            out.add(nn.AvgPool2D(3, 1, 1))
        elif spec[0] == "pool_max":
            out.add(nn.MaxPool2D(spec[1], spec[2]))
        else:
            out.add(_conv_bn(*spec))
    return out


def _make_A(pool_features):
    return _InceptionBranch(
        _branch((64, 1, 1, 0)),
        _branch((48, 1, 1, 0), (64, 5, 1, 2)),
        _branch((64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)),
        _branch(("pool_avg",), (pool_features, 1, 1, 0)))


def _make_B():
    return _InceptionBranch(
        _branch((384, 3, 2, 0)),
        _branch((64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)),
        _branch(("pool_max", 3, 2)))


def _make_C(channels_7x7):
    c = channels_7x7
    return _InceptionBranch(
        _branch((192, 1, 1, 0)),
        _branch((c, 1, 1, 0), (c, (1, 7), 1, (0, 3)),
                (192, (7, 1), 1, (3, 0))),
        _branch((c, 1, 1, 0), (c, (7, 1), 1, (3, 0)), (c, (1, 7), 1, (0, 3)),
                (c, (7, 1), 1, (3, 0)), (192, (1, 7), 1, (0, 3))),
        _branch(("pool_avg",), (192, 1, 1, 0)))


def _make_D():
    return _InceptionBranch(
        _branch((192, 1, 1, 0), (320, 3, 2, 0)),
        _branch((192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)),
        _branch(("pool_max", 3, 2)))


class _SplitConcat(HybridBlock):
    """An optional head, then two convolutions of its output joined on the
    channels (Inception E's split branches)."""

    def __init__(self, pre_specs, post_a, post_b):
        super().__init__()
        self.pre = _branch(*pre_specs) if pre_specs else None
        self.post_a = _conv_bn(*post_a)
        self.post_b = _conv_bn(*post_b)

    def forward(self, x):
        if self.pre is not None:
            x = self.pre(x)
        return _ops.concat([self.post_a(x), self.post_b(x)], axis=1)


def _make_E():
    return _InceptionBranch(
        _branch((320, 1, 1, 0)),
        _SplitConcat([(384, 1, 1, 0)],
                     (384, (1, 3), 1, (0, 1)), (384, (3, 1), 1, (1, 0))),
        _SplitConcat([(448, 1, 1, 0), (384, 3, 1, 1)],
                     (384, (1, 3), 1, (0, 1)), (384, (3, 1), 1, (1, 0))),
        _branch(("pool_avg",), (192, 1, 1, 0)))


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        f = self.features = nn.HybridSequential()
        f.add(_conv_bn(32, 3, 2, 0), _conv_bn(32, 3, 1, 0),
              _conv_bn(64, 3, 1, 1), nn.MaxPool2D(3, 2),
              _conv_bn(80, 1, 1, 0), _conv_bn(192, 3, 1, 0),
              nn.MaxPool2D(3, 2))
        f.add(_make_A(32), _make_A(64), _make_A(64), _make_B(),
              _make_C(128), _make_C(160), _make_C(160), _make_C(192),
              _make_D(), _make_E(), _make_E())
        f.add(nn.AvgPool2D(8), nn.Dropout(0.5), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(**kw): return _build(Inception3, **kw)


_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """The model `name` of the zoo (the JAX package's names), built by its
    model function with `kwargs` (`device=`, `seed=`, `classes=`, ...)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name!r} is not in the zoo "
                         f"({sorted(_models)})")
    return _models[name](**kwargs)
