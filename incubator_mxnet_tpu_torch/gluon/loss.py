"""gluon.loss of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/gluon/loss.py`, the same losses with
the same semantics: `L1Loss`, `L2Loss`, `SigmoidBinaryCrossEntropyLoss`
(`SigmoidBCELoss`), `SoftmaxCrossEntropyLoss` (`SoftmaxCELoss`),
`KLDivLoss`, `CTCLoss`, `HuberLoss`, `HingeLoss`, `SquaredHingeLoss`,
`LogisticLoss`, `TripletLoss`, `PoissonNLLLoss` and `CosineEmbeddingLoss`:
per-example loss, `weight` scaling and `sample_weight` broadcasting
(`_apply_weighting`), mean over every axis but `batch_axis` where the JAX
package takes it. Under AMP the log-softmaxes, the weighting products
and the means cast as the JAX package's ops of those names do
(`ops.nn`); the elementwise arithmetic between them is plain torch, whose
type promotion computes a bf16 prediction against a float32 label in
float32, as the JAX package's fused (bulked) elementwise steps do (op by
op, its eager steps round each intermediate to bf16).

`CTCLoss` runs the JAX package's log-space forward recursion (blank 0,
`label_lengths` defaulting to the count of nonzero labels, one loss per
sample, no batch mean) in torch ops, one step per time position, with the
same -1e30 for an impossible path: an alignment that cannot exist gives a
finite ~1e30, not inf.
"""
from __future__ import annotations

import math

import torch

from .. import amp
from ..base import MXNetError
from ..ops import nn as _ops
from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _softplus_tail(x):
    """log1p(exp(-|x|)), the stable tail of log(1 + exp(x))."""
    return torch.log1p(torch.exp(-x.abs()))


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

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L1Loss(Loss):
    """|label - pred|."""

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (label - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L2Loss(Loss):
    """(label - pred)^2 / 2 (the 1/2 rides on `weight`, default 1)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (label - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (or, `from_sigmoid`, of
    probabilities), with an optional `pos_weight` on the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            # log(1 + exp(x)) - x*z as max(x, 0) - x*z + log1p(exp(-|x|))
            relu_x = pred.clamp_min(0)
            tail = _softplus_tail(pred)
            if pos_weight is None:
                loss = relu_x - pred * label + tail
            else:
                w = (pos_weight - 1) * label + 1
                loss = relu_x - pred * label + w * tail \
                    + (w - 1) * (-pred).clamp_min(0)
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log(label) - pred), pred log-probabilities (or logits,
    with `from_logits=False`)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


_NEG_INF = -1e30


def _ctc_loss_raw(logits, labels, pred_lengths=None, label_lengths=None,
                  blank=0):
    """The log-domain CTC forward algorithm. logits (N, T, C), labels
    (N, L) integer; returns (N,) negative log-likelihoods."""
    n, t_len, _ = logits.shape
    L = labels.shape[1]
    dev = logits.device
    labels = labels.to(device=dev, dtype=torch.int64)
    if pred_lengths is None:
        pred_lengths = torch.full((n,), t_len, dtype=torch.int64, device=dev)
    else:
        pred_lengths = pred_lengths.to(device=dev, dtype=torch.int64)
    if label_lengths is None:
        label_lengths = (labels != blank).sum(dim=1)
    else:
        label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    S = 2 * L + 1
    ext = torch.full((n, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    neg = torch.full((), _NEG_INF, dtype=logp.dtype, device=dev)
    has_label = label_lengths > 0
    alpha = torch.cat([
        logp[:, 0, blank][:, None],
        torch.where(has_label,
                    _ops.take_fill(logp[:, 0], ext[:, 1:2], 1)[:, 0],
                    neg)[:, None],
        neg.expand(n, S - 2)], dim=1)
    same_as_prev2 = torch.cat([torch.ones((n, 2), dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1, pad2 = neg.expand(n, 1), neg.expand(n, 2)
    for t in range(1, t_len):
        lp = _ops.take_fill(logp[:, t], ext, 1)
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(same_as_prev2, neg,
                         torch.cat([pad2, alpha[:, :-2]], dim=1))
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + lp
        alpha = torch.where((t < pred_lengths)[:, None], new, alpha)
    s_last = 2 * label_lengths
    ll_blank = alpha.gather(1, s_last[:, None])[:, 0]
    ll_label = alpha.gather(1, (s_last - 1).clamp(min=0)[:, None])[:, 0]
    ll_label = torch.where(has_label, ll_label, neg)
    return -torch.logaddexp(ll_blank, ll_label)


class CTCLoss(Loss):
    """Connectionist temporal classification over (N, T, C) logits
    (`layout="TNC"`: time first) and (N, L) labels (`label_layout="TN"`:
    time first), blank 0."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"unsupported layout {layout}")
        super().__init__(weight, 0 if layout.startswith("N") else 1)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        (pred,) = amp.cast_inputs("ctc_loss", "neutral", pred)
        loss = _ctc_loss_raw(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """|e| - rho/2 where |e| > rho, e^2 / (2 rho) within."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        err = (label - pred).abs()
        loss = torch.where(err > self._rho, err - 0.5 * self._rho,
                           (0.5 / self._rho) * err.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """max(margin - pred * label, 0), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (self._margin - pred * label).clamp_min(0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """max(margin - pred * label, 0)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (self._margin - pred * label).clamp_min(0).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) with labels in {-1, 1} ("signed") or
    {0, 1} ("binary")."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = pred.clamp_min(0) - pred * label + _softplus_tail(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """max(mean(|pred - positive|^2 - |pred - negative|^2) + margin, 0),
    the mean over every axis but the batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = (pred - positive).square() - (pred - negative).square()
        loss = _batch_mean(loss, self._batch_axis)
        loss = (loss + self._margin).clamp_min(0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) - target * pred (`from_logits`), else pred - target *
    log(pred + epsilon), plus Stirling's term with `compute_full`; the mean
    over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * torch.log(target + epsilon) - target
                        + 0.5 * torch.log(2 * math.pi * (target + epsilon)))
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _ops.mean(loss)


class CosineEmbeddingLoss(Loss):
    """1 - cos(input1, input2) for label 1, max(cos - margin, 0) for the
    others; one loss per sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        num = (input1 * input2).sum(dim=1)
        den = torch.sqrt(input1.square().sum(dim=1)
                         * input2.square().sum(dim=1) + 1e-12)
        cos = num / den
        label = label.reshape((-1,)).to(cos.device)
        loss = torch.where(label == 1, 1.0 - cos,
                           (cos - self._margin).clamp_min(0))
        return _apply_weighting(loss, self._weight, sample_weight)
