"""gluon.model_zoo.vision of the PyTorch port: ResNet v1 and v2, MobileNet
v1 and v2, and `get_model`.

Counterpart of `incubator_mxnet_tpu/gluon/model_zoo/vision.py`
(`BasicBlockV1`, `BottleneckV1`, `ResNetV1`, `BasicBlockV2`,
`BottleneckV2`, `ResNetV2`, `get_resnet`, `resnet{18,34,50,101,152}_v{1,2}`,
`MobileNet`, `MobileNetV2`, `LinearBottleneck`, `mobilenet{1_0,0_75,0_5,
0_25}`, `mobilenet_v2_{1_0,0_75,0_5,0_25}`, `get_model`), with the same
child names, so `collect_params()` keys match the JAX package's. Each
residual block takes the fused branch exactly when the JAX package's does
(inside a fusion scope, channels last): every BN (+ReLU) is one fused op,
and a v1 block's tail (BN + residual add + ReLU) is one fused op; a v2
(pre-activation) block's three BN + ReLU are fused ops and its residual
add is plain. MobileNet is channels-first only, as in the JAX package, so
it takes no kernel: its depthwise convolutions go to cuDNN. The other
families of the JAX package's zoo (AlexNet, VGG, SqueezeNet, DenseNet,
Inception3) are not ported yet: `get_model` names them and raises.

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
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


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


def _mobilenet(klass, multiplier, pretrained=False, device=None, seed=0,
               **kwargs):
    _no_download(pretrained)
    return klass(multiplier, **kwargs).initialize(device=device, seed=seed)


def mobilenet1_0(**kw): return _mobilenet(MobileNet, 1.0, **kw)
def mobilenet0_75(**kw): return _mobilenet(MobileNet, 0.75, **kw)
def mobilenet0_5(**kw): return _mobilenet(MobileNet, 0.5, **kw)
def mobilenet0_25(**kw): return _mobilenet(MobileNet, 0.25, **kw)
def mobilenet_v2_1_0(**kw): return _mobilenet(MobileNetV2, 1.0, **kw)
def mobilenet_v2_0_75(**kw): return _mobilenet(MobileNetV2, 0.75, **kw)
def mobilenet_v2_0_5(**kw): return _mobilenet(MobileNetV2, 0.5, **kw)
def mobilenet_v2_0_25(**kw): return _mobilenet(MobileNetV2, 0.25, **kw)


_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}

# the JAX package's other families, not ported yet (ROADMAP A4 item 7)
_NOT_PORTED = ("alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
               "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
               "squeezenet1.1", "densenet121", "densenet161", "densenet169",
               "densenet201", "inceptionv3")


def get_model(name, **kwargs):
    """The model `name` of the zoo (the JAX package's names), built by its
    model function with `kwargs` (`device=`, `seed=`, `classes=`, ...)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not ported yet (ROADMAP A4 "
                         f"item 7); ported: {sorted(_models)}")
    if name not in _models:
        raise MXNetError(f"model {name!r} is not in the zoo "
                         f"({sorted(_models)})")
    return _models[name](**kwargs)
