"""gluon.model_zoo.detection of the PyTorch port: SSD-300 over a reduced
VGG16, on the multibox ops of `ops.contrib`.

Counterpart of `incubator_mxnet_tpu/gluon/model_zoo/detection.py`
(`SSD300`, `ssd_300_vgg16`, `ssd_anchor_sizes`), with the same child names,
so `collect_params()` keys and shapes match the JAX package's. Both
layouts: channels last ("NHWC") routes each convolution + ReLU through
the fused bias + activation (`fused.bias_act`, the apply kernel on the
card) inside a fusion scope, as the JAX package's convolution does; the
heads have no activation and stay plain. At 300x300 the six feature maps
are 38, 19, 10, 5, 3 and 1 wide, 8732 anchors in all.

`ssd_300_vgg16` takes `device=` (default: the card; without one it
raises) and `seed=`, and returns an initialized net whose deferred shapes
resolve at the first forward; `pretrained=True` raises.
"""
from __future__ import annotations

import math

from ...ops import contrib as _contrib
from ...ops import nn as _ops
from .. import nn
from ..block import HybridBlock
from .vision import _no_download

__all__ = ["SSD300", "ssd_300_vgg16", "ssd_anchor_sizes"]

# per feature map: the anchor aspect ratios (SSD paper, 300px preset)
_RATIOS = ((1, 2, 0.5),
           (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5),
           (1, 2, 0.5))


def ssd_anchor_sizes(num_maps=6, s_min=0.2, s_max=0.9):
    """Per-map (s_k, sqrt(s_k * s_{k+1})) size pairs (SSD paper eq. 4)."""
    scales = [0.1] + [s_min + (s_max - s_min) * k / (num_maps - 1)
                      for k in range(num_maps)]
    return [(scales[k], float(math.sqrt(scales[k] * scales[k + 1])))
            for k in range(num_maps)]


def _vgg16_reduced(layout):
    """VGG16 through conv4_3 (38x38x512 at 300px): three pooled stages,
    pool3 with ceil (75 -> 38), then conv4 without its pool."""
    net = nn.HybridSequential()
    for bi, (blocks, ch) in enumerate([(2, 64), (2, 128), (3, 256)]):
        for _ in range(blocks):
            net.add(nn.Conv2D(ch, 3, padding=1, activation="relu",
                              layout=layout))
        net.add(nn.MaxPool2D(2, 2, layout=layout, ceil_mode=(bi == 2)))
    for _ in range(3):
        net.add(nn.Conv2D(512, 3, padding=1, activation="relu",
                          layout=layout))
    return net


class SSD300(HybridBlock):
    """SSD with a reduced VGG16 backbone at 300x300 (8732 anchors).

    forward(x) -> (anchors (1, 8732, 4), cls_preds (B, 8732, classes + 1),
    loc_preds (B, 8732 * 4)); `detect(x)` runs the softmax and
    `multibox_detection` (NMS inside) and returns (B, 8732, 6) rows [id,
    score, x1, y1, x2, y2]; `targets(...)` is `multibox_target`."""

    def __init__(self, classes=20, layout="NCHW"):
        super().__init__()
        self._classes = classes
        self._layout = layout
        self._sizes = ssd_anchor_sizes()
        self._num_anchors = [len(s) + len(r) - 1
                             for s, r in zip(self._sizes, _RATIOS)]
        self.stem = _vgg16_reduced(layout)                 # -> 38
        self.conv5 = nn.HybridSequential()
        self.conv5.add(nn.MaxPool2D(2, 2, layout=layout))   # pool4: 19
        for _ in range(3):
            self.conv5.add(nn.Conv2D(512, 3, padding=1, activation="relu",
                                     layout=layout))
        self.conv5.add(nn.MaxPool2D(3, 1, padding=1, layout=layout))
        self.fc = nn.HybridSequential()
        self.fc.add(nn.Conv2D(1024, 3, padding=6, dilation=6,
                              activation="relu", layout=layout),   # fc6
                    nn.Conv2D(1024, 1, activation="relu",
                              layout=layout))                      # fc7
        self.extras = nn.HybridSequential()                # 10, 5, 3, 1
        for mid, out, stride, pad in ((256, 512, 2, 1), (128, 256, 2, 1),
                                      (128, 256, 1, 0), (128, 256, 1, 0)):
            blk = nn.HybridSequential()
            blk.add(nn.Conv2D(mid, 1, activation="relu", layout=layout),
                    nn.Conv2D(out, 3, strides=stride, padding=pad,
                              activation="relu", layout=layout))
            self.extras.add(blk)
        self.cls_heads = nn.HybridSequential()
        self.loc_heads = nn.HybridSequential()
        for na in self._num_anchors:
            self.cls_heads.add(nn.Conv2D(na * (classes + 1), 3, padding=1,
                                         layout=layout))
            self.loc_heads.add(nn.Conv2D(na * 4, 3, padding=1,
                                         layout=layout))

    def _flatten_pred(self, p, per_anchor):
        # (B, C, H, W) or (B, H, W, C) -> (B, H*W*na, per_anchor)
        if self._layout == "NCHW":
            p = p.permute(0, 2, 3, 1)
        return p.reshape(p.shape[0], -1, per_anchor)

    def forward(self, x):
        h = self.stem(x)
        feats = [h]                                       # 38
        h = self.fc(self.conv5(h))
        feats.append(h)                                   # 19
        for blk in self.extras:
            h = blk(h)
            feats.append(h)                               # 10, 5, 3, 1
        anchors, cls_preds, loc_preds = [], [], []
        for i, f in enumerate(feats):
            anchors.append(_contrib.multibox_prior(
                f, sizes=self._sizes[i], ratios=_RATIOS[i],
                layout=self._layout))
            cls_preds.append(self._flatten_pred(self.cls_heads[i](f),
                                                self._classes + 1))
            loc_preds.append(self._flatten_pred(self.loc_heads[i](f), 4))
        loc = _ops.concat(loc_preds, axis=1)
        return (_ops.concat(anchors, axis=1), _ops.concat(cls_preds, axis=1),
                loc.reshape(loc.shape[0], -1))

    def detect(self, x, nms_threshold=0.45, threshold=0.01):
        anchors, cls_preds, loc_preds = self(x)
        probs = _ops.softmax(cls_preds, axis=-1).transpose(1, 2)
        return _contrib.multibox_detection(
            probs, loc_preds, anchors, nms_threshold=nms_threshold,
            threshold=threshold)

    def targets(self, anchors, labels, cls_preds, negative_mining_ratio=3.0):
        """(loc_target, loc_mask, cls_target) of `multibox_target`."""
        return _contrib.multibox_target(
            anchors, labels, cls_preds.transpose(1, 2),
            negative_mining_ratio=negative_mining_ratio)


def ssd_300_vgg16(classes=20, layout="NCHW", pretrained=False, device=None,
                  seed=0):
    """The SSD-300/VGG16 preset (GluonCV's ssd_300_vgg16_atrous), drawn on
    `device` (default: the card) from `seed`."""
    _no_download(pretrained)
    return SSD300(classes=classes, layout=layout).initialize(device=device,
                                                             seed=seed)
