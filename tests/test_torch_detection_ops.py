"""PyTorch port: the detection ops (`ops.contrib`) against the JAX package's.

The same numpy inputs, made from a seed, go through
`incubator_mxnet_tpu.ops.contrib` (jitted on the CPU, as its own tests run
it) and `incubator_mxnet_tpu_torch.ops.contrib` on the CPU (where the NMS
sweep takes its plain version, `nms_sweep_ref`). Ties are planted where
the order of equal keys decides the result: equal scores in `box_nms`,
two identical ground-truth boxes and equal background probabilities in
`multibox_target`, equal class probabilities in `multibox_detection`.

Tolerances: integer outputs (class targets, ids, keep masks) exactly
equal; float outputs within 1e-6 (relative and absolute) in float32: both
packages compute them op by op in float32, and XLA's and PyTorch's
elementwise kernels may round a transcendental (exp, log) differently.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import contrib as jcontrib

from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _j(fn, *arrays, **kw):
    import jax.numpy as jnp
    out = fn(*[jnp.asarray(a) for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(fn, *arrays, **kw):
    out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
             **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _corner_boxes(rng, shape, spread=1.0):
    xy = rng.rand(*shape, 2) * spread
    wh = 0.05 + rng.rand(*shape, 2) * 0.4
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rng = np.random.RandomState(0)
    lhs = _corner_boxes(rng, (2, 5), 0.6)
    rhs = _corner_boxes(rng, (2, 7), 0.6)
    rhs[0, 3] = [0.5, 0.5, 0.5, 0.9]         # zero area
    rhs[1, 2] = lhs[1, 4]                    # identical: IoU 1
    want = _j(jcontrib.box_iou, lhs, rhs, fmt=fmt)
    got = _t(tcontrib.box_iou, lhs, rhs, fmt=fmt)
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _nms_data(seed=1, batch=2, n=40):
    """Rows [id, score, x1, y1, x2, y2] clustered so that boxes overlap,
    with equal scores planted (ties keep their order)."""
    rng = np.random.RandomState(seed)
    boxes = _corner_boxes(rng, (batch, n), 0.5)
    scores = rng.rand(batch, n).astype(np.float32)
    scores[:, 5:9] = scores[:, 4:5]          # a run of equal scores
    scores[:, 20] = 0.0                      # at the valid threshold
    ids = rng.randint(0, 3, size=(batch, n)).astype(np.float32)
    return np.concatenate([ids[..., None], scores[..., None], boxes],
                          axis=-1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_thresh=0.3, id_index=0),
    dict(overlap_thresh=0.3, id_index=0, force_suppress=True),
    dict(overlap_thresh=0.4, topk=12, id_index=0),
    dict(overlap_thresh=0.5, valid_thresh=0.3),
], ids=["default", "per_class", "force_suppress", "topk", "valid_thresh"])
def test_box_nms_matches_jax(kw):
    data = _nms_data()
    want = _j(jcontrib.box_nms, data, **kw)
    got = _t(tcontrib.box_nms, data, **kw)
    assert got.shape == data.shape
    np.testing.assert_array_equal(got, want)
    kept = (got[..., 1] >= 0).sum()
    assert 0 < kept < np.isfinite(got[..., 1]).sum()   # NMS suppressed some


def test_box_nms_one_image_matches_jax():
    data = _nms_data(seed=2, batch=1)[0]
    np.testing.assert_array_equal(
        _t(tcontrib.box_nms, data, overlap_thresh=0.3, id_index=0),
        _j(jcontrib.box_nms, data, overlap_thresh=0.3, id_index=0))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [
    dict(sizes=(0.2, 0.35), ratios=(1, 2, 0.5)),
    dict(sizes=(0.5, 0.9), ratios=(1, 3, 1 / 3), clip=True),
    dict(sizes=(0.3,), ratios=(2, 1), steps=(0.1, 0.15), offsets=(0.3, 0.6)),
], ids=["plain", "clip", "steps_offsets"])
def test_multibox_prior_matches_jax(layout, kw):
    feat = np.zeros((1, 4, 5, 7) if layout == "NCHW" else (1, 5, 7, 4),
                    np.float32)
    want = _j(jcontrib.multibox_prior, feat, layout=layout, **kw)
    got = _t(tcontrib.multibox_prior, feat, layout=layout, **kw)
    k = len(kw["sizes"]) + len(kw["ratios"]) - 1
    assert got.shape == (1, 5 * 7 * k, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _anchors():
    feats = [np.zeros((1, 1, 6, 6), np.float32),
             np.zeros((1, 1, 3, 3), np.float32)]
    return np.concatenate([
        np.asarray(jcontrib.multibox_prior(f, sizes=s, ratios=(1, 2, 0.5)))
        for f, s in zip(feats, [(0.2, 0.3), (0.5, 0.7)])], axis=1)


def _target_inputs(seed=3, classes=4):
    """Anchors (1, 180, 4); labels (3, 6, 5) with a padding row in the
    middle of image 1 (every row after it counts as padding), two
    identical boxes in image 0 and one gt-free image; class predictions
    with equal rows (equal background probabilities)."""
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    A = anchors.shape[1]
    labels = -np.ones((3, 6, 5), np.float32)
    for b, n in ((0, 4), (1, 5), (2, 0)):
        for g in range(n):
            labels[b, g, 0] = rng.randint(0, classes)
            labels[b, g, 1:] = _corner_boxes(rng, (), 0.6)
    labels[0, 3] = labels[0, 1]              # two identical gt boxes
    labels[1, 2] = -1                        # padding in the middle
    cls_pred = rng.randn(3, classes + 1, A).astype(np.float32)
    cls_pred[:, :, ::3] = 0.0                # ties: equal probabilities
    return anchors, labels, cls_pred


@pytest.mark.parametrize("kw", [
    dict(),
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=3.0, minimum_negative_samples=40),
    dict(negative_mining_ratio=2.0, overlap_threshold=0.3,
         negative_mining_thresh=0.4, ignore_label=-2.0),
    dict(overlap_threshold=0.0),
], ids=["no_mining", "mining3", "min_negatives", "thresholds", "bipartite"])
def test_multibox_target_matches_jax(kw):
    anchors, labels, cls_pred = _target_inputs()
    want = _j(jcontrib.multibox_target, anchors, labels, cls_pred, **kw)
    got = _t(tcontrib.multibox_target, anchors, labels, cls_pred, **kw)
    A = anchors.shape[1]
    for g, w, shape in zip(got, want, [(3, A * 4), (3, A * 4), (3, A)]):
        assert g.shape == shape and g.dtype == np.float32
    np.testing.assert_array_equal(got[2], want[2])        # class targets
    np.testing.assert_array_equal(got[1], want[1])        # masks
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert (got[2] > 0).any() and (got[2] == 0).any()
    if kw.get("negative_mining_ratio", -1) > 0:
        assert (got[2] == kw.get("ignore_label", -1.0)).any()


def test_multibox_target_bipartite_counts():
    """The matcher alone (overlap_threshold 0): each valid gt box takes one
    anchor, the two identical boxes of image 0 two different ones, and
    image 1's rows after its padding row count as padding."""
    anchors, labels, cls_pred = _target_inputs()
    _, _, cls_t = _t(tcontrib.multibox_target, anchors, labels, cls_pred,
                     overlap_threshold=0.0)
    assert [(c > 0).sum() for c in cls_t] == [4, 2, 0]


def _detection_inputs(seed=4, batch=2, classes=4):
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    A = anchors.shape[1]
    logits = rng.randn(batch, classes + 1, A).astype(np.float32) * 2
    logits[:, 1:3, ::5] = logits[:, 1:2, ::5]     # tied best classes
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(batch, A * 4) * 0.3).astype(np.float32)
    return probs, loc, anchors


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_threshold=0.3, threshold=0.2),
    dict(background_id=2, nms_threshold=0.45),
    dict(nms_topk=30, nms_threshold=0.4),
    dict(force_suppress=True, nms_threshold=0.3, clip=False),
], ids=["default", "thresholds", "background_id", "nms_topk",
        "force_suppress"])
def test_multibox_detection_matches_jax(kw):
    probs, loc, anchors = _detection_inputs()
    want = _j(jcontrib.multibox_detection, probs, loc, anchors, **kw)
    got = _t(tcontrib.multibox_detection, probs, loc, anchors, **kw)
    assert got.shape == (2, anchors.shape[1], 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])       # ids
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL)
    valid = got[..., 0] >= 0
    assert valid.any() and (~valid).any()


def test_multibox_ops_are_not_differentiable():
    probs, loc, anchors = _detection_inputs()
    loc_t = torch.from_numpy(loc).requires_grad_()
    out = tcontrib.multibox_detection(torch.from_numpy(probs), loc_t,
                                      torch.from_numpy(anchors))
    assert not out.requires_grad
    anchors, labels, cls_pred = _target_inputs()
    pred = torch.from_numpy(cls_pred).requires_grad_()
    outs = tcontrib.multibox_target(torch.from_numpy(anchors),
                                    torch.from_numpy(labels), pred,
                                    negative_mining_ratio=3.0)
    assert not any(o.requires_grad for o in outs)


def test_nms_sweep_dispatch():
    """A CPU tensor takes the plain sweep; the kernel's wrapper takes CUDA
    tensors only and refuses what its kernel does not take."""
    data = torch.from_numpy(_nms_data()[..., 2:]).contiguous()
    keep = torch.ones(data.shape[:2], dtype=torch.bool)
    ids = torch.zeros(data.shape[:2])
    before = kernels.launch_counts()["nms_sweep"]
    got = tcontrib.nms_sweep(data, ids, keep, 0.3)
    assert torch.equal(got, tcontrib.nms_sweep_ref(data, None, keep, 0.3))
    assert kernels.launch_counts()["nms_sweep"] == before
    with pytest.raises(Exception, match="CUDA tensors only"):
        kernels.nms_sweep_cuda(data, ids, keep, 0.3)
