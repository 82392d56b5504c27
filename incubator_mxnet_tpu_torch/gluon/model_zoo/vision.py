"""gluon.model_zoo.vision of the PyTorch port: the ResNet v1 family.

Counterpart of `incubator_mxnet_tpu/gluon/model_zoo/vision.py`
(`BasicBlockV1`, `BottleneckV1`, `ResNetV1`, `get_resnet`,
`resnet{18,34,50,101,152}_v1`), with the same child names, so
`collect_params()` keys match the JAX package's. Each residual block takes
the fused branch exactly when the JAX package's does (inside a fusion
scope): every BN (+ReLU) is one fused op, and the block's tail (BN +
residual add + ReLU) is one fused op. The v2 family is not ported yet.

The model functions take `device=` (default: the card; without one they
raise) and `seed=`, and return an initialized net: random weights from the
seed (`HybridBlock.initialize`), or the JAX package's through
`gluon.params_from_jax`. `pretrained=True` is not supported.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import fused as _fused
from ...ops import nn as _ops
from .. import nn
from ..block import HybridBlock

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1"]


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


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def get_resnet(version, num_layers, pretrained=False, device=None, seed=0,
               **kwargs):
    """A ResNet of the given version and depth, initialized on `device`
    (default: the card) from `seed`."""
    if pretrained:
        raise MXNetError("pretrained weights are not supported by the port; "
                         "carry weights across with gluon.params_from_jax")
    if version != 1:
        raise MXNetError("only ResNet v1 is ported so far")
    if num_layers not in _resnet_spec:
        raise MXNetError(f"no ResNet of depth {num_layers}; "
                         f"{sorted(_resnet_spec)}")
    block_type, layers, channels = _resnet_spec[num_layers]
    block = BasicBlockV1 if block_type == "basic_block" else BottleneckV1
    net = ResNetV1(block, layers, channels, **kwargs)
    return net.initialize(device=device, seed=seed)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
