"""PyTorch port: every `gluon.metric` (and the `metric` alias) against the
JAX package's.

The same update sequence, made with numpy from a seed, goes to both
packages' metrics: numpy arrays to the JAX package's, torch tensors to the
port's (float32, and bfloat16 predictions, whose values the JAX side gets
as the same bf16-rounded float32 numbers). Both compute in numpy on the
host, so `get()` must agree to 1e-12 relative (the same arithmetic on the
same arrays).
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.gluon import metric as jmetric

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon import metric as tmetric

torch.set_num_threads(1)

RTOL = 1e-12


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _cls(rng):
    return (rng.randint(0, 5, size=8).astype(np.int32),
            rng.randn(8, 5).astype(np.float32))


def _prob_cls(rng):
    return (rng.randint(0, 5, size=8).astype(np.int32),
            _softmax(rng.randn(8, 5)))


def _binary(rng):
    return ((rng.rand(8) > 0.5).astype(np.float32),
            rng.rand(8).astype(np.float32))


def _binary2(rng):
    return ((rng.rand(8) > 0.5).astype(np.int32),
            _softmax(rng.randn(8, 2)))


def _regress(rng):
    return (rng.randn(8, 3).astype(np.float32),
            rng.randn(8, 3).astype(np.float32))


def _vec(rng):
    x = rng.randn(8).astype(np.float32)
    return x, (x + 0.5 * rng.randn(8)).astype(np.float32)


def _loss(rng):
    return None, rng.rand(8).astype(np.float32)


def _boxes(rng):
    """(labels (2, 4, 5) [cls, x1, y1, x2, y2] with a -1 pad row, preds
    (2, 6, 6) [cls, score, box] with one -1 row): detections near the
    boxes, some off."""
    lab = np.full((2, 4, 5), -1.0, np.float32)
    det = np.full((2, 6, 6), -1.0, np.float32)
    for b in range(2):
        for j in range(3):
            xy = rng.uniform(0, 0.6, 2)
            wh = rng.uniform(0.1, 0.4, 2)
            lab[b, j] = [rng.randint(0, 3), *xy, *(xy + wh)]
        for j in range(5):
            g = lab[b, rng.randint(0, 3)]
            jit = rng.uniform(-0.08, 0.08, 4) * (1 + 3 * (j % 2))
            det[b, j] = [g[0] if j != 4 else (g[0] + 1) % 3, rng.rand(),
                         *(g[1:] + jit)]
    return lab, det


METRICS = {
    "Accuracy": (lambda m: m.Accuracy(), _cls),
    "TopKAccuracy": (lambda m: m.TopKAccuracy(top_k=3), _cls),
    "BinaryAccuracy": (lambda m: m.BinaryAccuracy(threshold=0.3), _binary),
    "F1": (lambda m: m.F1(), _binary2),
    "F1-scores": (lambda m: m.F1(), _binary),
    "MCC": (lambda m: m.MCC(), _binary2),
    "MAE": (lambda m: m.MAE(), _regress),
    "MSE": (lambda m: m.MSE(), _regress),
    "RMSE": (lambda m: m.RMSE(), _regress),
    "CrossEntropy": (lambda m: m.CrossEntropy(), _prob_cls),
    "Perplexity": (lambda m: m.Perplexity(ignore_label=0), _prob_cls),
    "NegativeLogLikelihood": (lambda m: m.NegativeLogLikelihood(),
                              _prob_cls),
    "PearsonCorrelation": (lambda m: m.PearsonCorrelation(), _vec),
    "Loss": (lambda m: m.Loss(), _loss),
    "CustomMetric": (lambda m: m.create(
        lambda label, pred: float(np.abs(label - pred).sum())), _regress),
    "CompositeEvalMetric": (lambda m: m.CompositeEvalMetric(
        ["acc", m.TopKAccuracy(top_k=2)]), _cls),
    "MeanAveragePrecision": (lambda m: m.MeanAveragePrecision(), _boxes),
    "VOC07MApMetric": (lambda m: m.VOC07MApMetric(iou_thresh=0.4), _boxes),
}


def _port_arr(a, dtype):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(dtype) if t.is_floating_point() else t


def _as_jax(a, dtype):
    """What the port's `dtype` tensor holds, as float32 numpy."""
    if a is None or not np.issubdtype(a.dtype, np.floating):
        return a
    return torch.from_numpy(a).to(dtype).float().numpy()


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, rel=RTOL, abs=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax_after_the_same_updates(name, dtype):
    make, data = METRICS[name]
    tm, jm = make(tmetric), make(jmetric)
    assert tm.get()[0] == jm.get()[0]
    rng = np.random.RandomState(len(name))
    for step in range(3):
        label, pred = data(rng)
        if name == "MeanAveragePrecision" or name == "VOC07MApMetric":
            # boxes stay float32: bf16 would move them past the IoU cut
            tl, tp = torch.from_numpy(label), torch.from_numpy(pred)
            jl, jp = label, pred
        else:
            tl = _port_arr(label, torch.float32)
            tp = _port_arr(pred, dtype)
            jl, jp = label, _as_jax(pred, dtype)
        if step == 1 and tl is not None:
            # lists of (label, pred) pairs, as a multi-device script hands
            # them in
            tm.update([tl], [tp])
            jm.update([jl], [jp])
        else:
            tm.update(tl, tp)
            jm.update(jl, jp)
    got, want = tm.get(), jm.get()
    assert got[0] == want[0]
    _same(got[1], want[1])
    tm.reset()
    jm.reset()
    _same(tm.get()[1], jm.get()[1])


@pytest.mark.parametrize("name", ["acc", "accuracy", "top_k_accuracy",
                                  "ce", "cross-entropy", "nll_loss",
                                  "pearsonr", "mae", "mse", "rmse", "f1",
                                  "mcc", "perplexity", "loss", "map",
                                  "voc07mapmetric"])
def test_create_resolves_names_as_jax(name):
    assert type(tmetric.create(name)).__name__ == \
        type(jmetric.create(name)).__name__
    assert tmetric.create(name).name == jmetric.create(name).name


def test_create_lists_and_refuses_unknown_names():
    comp = tmetric.create(["acc", "mse"])
    assert isinstance(comp, tmetric.CompositeEvalMetric)
    assert [m.name for m in comp.metrics] == ["accuracy", "mse"]
    with pytest.raises(MXNetError, match="unknown metric"):
        tmetric.create("no_such_metric")


def test_mx_metric_is_the_gluon_metric():
    assert tmx.metric.RMSE is tmetric.RMSE
    assert tmx.metric.create is tmetric.create
