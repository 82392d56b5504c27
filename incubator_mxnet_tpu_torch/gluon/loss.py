"""gluon.loss of the PyTorch port: `Loss` and `SoftmaxCrossEntropyLoss`.

Counterpart of `incubator_mxnet_tpu/gluon/loss.py`, same semantics:
per-example loss, `weight` scaling and `sample_weight` broadcasting
(`_apply_weighting`), mean over every axis but `batch_axis`. The ops go
through `ops.nn`, so under AMP they cast as the JAX package's do
(log_softmax in float32, the weighting products in the target dtype).
"""
from __future__ import annotations

from ..ops import nn as _ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = _ops.multiply(loss, sample_weight)
    if weight is not None:
        loss = _ops.multiply(loss, weight)
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return _ops.mean(loss, axis=axes) if axes else loss


class Loss(HybridBlock):
    """Base loss."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with integer (`sparse_label`) or dense
    labels; `from_logits` skips the log_softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_ops.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            label = label.reshape(pred.shape)
            loss = -_ops.sum(_ops.multiply(pred, label), axis=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)
