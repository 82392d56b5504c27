"""gluon.metric of the PyTorch port: evaluation metrics.

Counterpart of `incubator_mxnet_tpu/gluon/metric.py`, the port's own copy
(it imports nothing of the JAX package): `EvalMetric` with update / reset /
get, `CompositeEvalMetric`, `Accuracy`, `TopKAccuracy`, `BinaryAccuracy`,
`F1`, `MCC`, `MAE`, `MSE`, `RMSE`, `CrossEntropy`, `Perplexity`,
`NegativeLogLikelihood`, `PearsonCorrelation`, `Loss`, `CustomMetric`,
`MeanAveragePrecision` and `VOC07MApMetric`, with `register` and `create`
(names and aliases as there). Metrics are host-side numpy bookkeeping:
labels and predictions come in as tensors on any device (or numpy arrays)
and are copied to the host; a bfloat16 tensor is widened to float32 first,
since numpy has no bfloat16 (an AMP loop hands bf16 logits in).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError

__all__ = [
    "MeanAveragePrecision", "VOC07MApMetric",
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "BinaryAccuracy", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
    "Perplexity", "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
    "create",
]

_REGISTRY = {}


_ALIASES = {
    "accuracy": ["acc"],
    "topkaccuracy": ["top_k_accuracy", "top_k_acc"],
    "crossentropy": ["ce", "cross-entropy"],
    "negativeloglikelihood": ["nll_loss", "nll-loss"],
    "pearsoncorrelation": ["pearsonr"],
    "meanaverageprecision": ["map", "voc07mapmetric"],
}


def register(klass):
    key = klass.__name__.lower()
    _REGISTRY[key] = klass
    for alias in _ALIASES.get(key, []):
        _REGISTRY[alias] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a callable (`CustomMetric`), an instance, a list
    (`CompositeEvalMetric`) or a registered name."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    if name not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}: {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)


def _to_numpy(x):
    """A label or prediction as a numpy array on the host (bfloat16 as
    float32)."""
    x = getattr(x, "_t", x)      # an NDArray's tensor
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    """Base metric: `update(labels, preds)` accumulates `sum_metric` and
    `num_inst`, `get()` gives (name, value)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def update_dict(self, labels, preds):
        self.update(list(labels.values()), list(preds.values()))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_lists(labels, preds):
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    return labels, preds


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int64).ravel()
            label = label.astype(_np.int64).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(_np.int64).ravel()
            topk = _np.argsort(-pred, axis=-1)[..., :self.top_k]
            hits = (topk == label[:, None]).any(axis=-1)
            self.sum_metric += float(hits.sum())
            self.num_inst += len(label)


@register
class BinaryAccuracy(EvalMetric):
    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = (_to_numpy(pred).ravel() > self.threshold)
            label = _to_numpy(label).ravel() > 0.5
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


class _BinaryClassBase(EvalMetric):
    def reset(self):
        super().reset()
        self.tp = self.fp = self.tn = self.fn = 0.0

    def _accumulate(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(_np.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1).ravel()
            else:
                pred = (pred.ravel() > 0.5).astype(_np.int64)
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.tn += float(((pred == 0) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)


@register
class F1(_BinaryClassBase):
    def __init__(self, name="f1", average="macro", **kwargs):
        self.average = average
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._accumulate(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        precision = self.tp / max(self.tp + self.fp, 1e-12)
        recall = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return self.name, f1


@register
class MCC(_BinaryClassBase):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._accumulate(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        num = self.tp * self.tn - self.fp * self.fn
        den = _np.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                       * (self.tn + self.fp) * (self.tn + self.fn))
        return self.name, float(num / den) if den else 0.0


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(_np.abs(label - pred).mean()) * len(label)
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(((label - pred) ** 2).mean()) * len(label)
            self.num_inst += len(label)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, float(_np.sqrt(value))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel().astype(_np.int64)
            pred = _to_numpy(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += len(label)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel().astype(_np.int64)
            pred = _to_numpy(pred).reshape(-1, _to_numpy(pred).shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            ce = -_np.log(prob + self.eps)
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                ce = ce[keep]
                self.num_inst += int(keep.sum())
            else:
                self.num_inst += len(label)
            self.sum_metric += float(ce.sum())

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.exp(self.sum_metric / self.num_inst))


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self._labels.append(_to_numpy(label).ravel())
            self._preds.append(_to_numpy(pred).ravel())
            self.num_inst += len(self._labels[-1])

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        x = _np.concatenate(self._labels)
        y = _np.concatenate(self._preds)
        return self.name, float(_np.corrcoef(x, y)[0, 1])


@register
class Loss(EvalMetric):
    """Running mean of a loss output."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            p = _to_numpy(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            val = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


np = _np  # MXNet exposes numpy as mx.gluon.metric.np


@register
class MeanAveragePrecision(EvalMetric):
    """Detection mAP (GluonCV's VOCMApMetric): per-class average
    precision over an IoU threshold, averaged.

    update(labels, preds):
      labels: (B, M, 5) ground truth [cls, x1, y1, x2, y2] (cls -1 pads)
      preds:  (B, N, 6) detections  [cls, score, x1, y1, x2, y2]
              (cls -1 entries ignored — multibox_detection's pad rows)

    `get()` computes integral AP per class (precision envelope, the
    VOC2010+ convention) unless voc07=True (11-point interpolation).
    """

    def __init__(self, iou_thresh=0.5, class_names=None, voc07=False,
                 name="mAP", **kwargs):
        self._iou = float(iou_thresh)
        self._voc07 = bool(voc07)
        self._class_names = class_names
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._records = {}   # cls -> list of (score, is_tp)
        self._npos = {}      # cls -> #ground-truth boxes

    @staticmethod
    def _iou_matrix(a, b):
        # a: (n,4), b: (m,4) corner boxes
        lt = _np.maximum(a[:, None, :2], b[None, :, :2])
        rb = _np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = _np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        area_a = _np.clip(a[:, 2] - a[:, 0], 0, None) \
            * _np.clip(a[:, 3] - a[:, 1], 0, None)
        area_b = _np.clip(b[:, 2] - b[:, 0], 0, None) \
            * _np.clip(b[:, 3] - b[:, 1], 0, None)
        union = area_a[:, None] + area_b[None, :] - inter
        return inter / _np.maximum(union, 1e-12)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for lab_x, det_x in zip(labels, preds):
            lab = _to_numpy(lab_x)
            det = _to_numpy(det_x)
            for b in range(lab.shape[0]):
                self._update_one(lab[b], det[b])
        self.num_inst = 1   # get() computes from the records

    def _update_one(self, lab, det):
        gts = lab[lab[:, 0] >= 0]
        dets = det[det[:, 0] >= 0]
        classes = set(gts[:, 0].astype(int)) | set(dets[:, 0].astype(int))
        for c in classes:
            g = gts[gts[:, 0].astype(int) == c][:, 1:5]
            d = dets[dets[:, 0].astype(int) == c]
            self._npos[c] = self._npos.get(c, 0) + len(g)
            rec = self._records.setdefault(c, [])
            if len(d) == 0:
                continue
            d = d[_np.argsort(-d[:, 1])]
            if len(g) == 0:
                rec.extend((float(s), False) for s in d[:, 1])
                continue
            ious = self._iou_matrix(d[:, 2:6], g)   # one (N, M) matrix
            matched = _np.zeros(len(g), bool)
            for i in range(len(d)):
                j = int(_np.argmax(ious[i]))
                if ious[i, j] >= self._iou and not matched[j]:
                    matched[j] = True
                    rec.append((float(d[i, 1]), True))
                else:
                    rec.append((float(d[i, 1]), False))

    def _class_ap(self, c):
        rec = self._records.get(c, [])
        npos = self._npos.get(c, 0)
        if npos == 0:
            return None
        if not rec:
            return 0.0
        arr = _np.array(sorted(rec, key=lambda r: -r[0]), dtype=_np.float64)
        tp = _np.cumsum(arr[:, 1])
        fp = _np.cumsum(1.0 - arr[:, 1])
        recall = tp / npos
        precision = tp / _np.maximum(tp + fp, 1e-12)
        if self._voc07:
            ap = 0.0
            for t in _np.linspace(0, 1, 11):
                p = precision[recall >= t]
                ap += (p.max() if len(p) else 0.0) / 11.0
            return float(ap)
        # integral AP with the precision envelope
        mrec = _np.concatenate([[0.0], recall, [1.0]])
        mpre = _np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = _np.where(mrec[1:] != mrec[:-1])[0]
        return float(_np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def get(self):
        aps = [ap for ap in (self._class_ap(c) for c in
                             sorted(self._npos)) if ap is not None]
        if not aps:
            return self.name, float("nan")
        return self.name, float(_np.mean(aps))

    def get_class_aps(self):
        """Per-class APs, keyed by class id (or class_names entry)."""
        out = {}
        for c in sorted(self._npos):
            ap = self._class_ap(c)
            if ap is None:
                continue
            key = (self._class_names[c]
                   if self._class_names and c < len(self._class_names)
                   else c)
            out[key] = ap
        return out


@register
class VOC07MApMetric(MeanAveragePrecision):
    """The 11-point interpolated VOC-2007 convention (GluonCV's
    VOC07MApMetric): same accumulation, voc07 AP by default."""

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP_voc07",
                 **kwargs):
        kwargs.pop("voc07", None)
        super().__init__(iou_thresh=iou_thresh, class_names=class_names,
                         voc07=True, name=name, **kwargs)
