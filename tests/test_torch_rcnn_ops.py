"""PyTorch port: the Faster-RCNN / R-FCN op tail (`ops.contrib.roi_align`,
`bilinear_resize2d`, `proposal`, `deformable_convolution`,
`psroi_pooling`) against the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through
`incubator_mxnet_tpu.ops.contrib` (jitted on the CPU, as its own tests run
it) and the port's. Tolerances, float32 throughout:
  * `roi_align` and `bilinear_resize2d`, values and gradients: 1e-5
    (both sum the same samples in another order);
  * `proposal`: rois within a relative 1e-5 (the decode's exp rounds in
    each library's own way) and the survivors in the same order, scores
    equal;
  * `deformable_convolution` (all four gradients) and `psroi_pooling`
    (its gradient in data): 1e-4 (a matrix product over 9 C terms, and a
    sum of 16 samples a bin, in other orders).
`proposal_sweep_ref` is also held against a plain numpy greedy loop over
boxes that touch at one pixel, boxes inverted (as rpn_min_size = 0 lets
through), equal boxes and equal scores, NaN boxes and a negative
threshold. The npx names run through the port's dispatch with the JAX
package's result dtypes under `amp.autocast` bf16. On CPU tensors the
sweep takes its plain version: no kernel launch is counted.

Every test runs inside `process_state_kept()`, with both packages' AMP
state put back.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import contrib as jcontrib

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import (jax_amp_restored, port_amp_restored,
                              process_state_kept)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL4 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept(), jax_amp_restored(), port_amp_restored():
        kernels.reset_launch_counts()
        yield
        assert sum(kernels.launch_counts().values()) == 0


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
        return tuple(o.detach().numpy() for o in out)
    return out.detach().numpy()


def _grads(jfn, tfn, arrays, wrt, seed=9):
    """(JAX, port) outputs and gradients of sum(out * cot) in the inputs
    numbered `wrt`, cot a numpy normal draw of the output's shape."""
    import jax
    import jax.numpy as jnp
    jargs = [jnp.asarray(a) for a in arrays]
    out, vjp = jax.vjp(lambda *d: jfn(*[d[wrt.index(i)] if i in wrt
                                         else jargs[i]
                                         for i in range(len(arrays))]),
                       *[jargs[i] for i in wrt])
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=i in wrt)
             for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    tg = torch.autograd.grad(tout, [targs[i] for i in wrt],
                             torch.from_numpy(cot))
    return ((np.asarray(out), [np.asarray(g) for g in jg]),
            (tout.detach().numpy(), [g.numpy() for g in tg]))


def _assert_grads(pair, tol):
    (jout, jg), (tout, tg) = pair
    np.testing.assert_allclose(tout, jout, **tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# roi_align and the bilinear resize
# ---------------------------------------------------------------------------
def _roi_inputs(seed=0):
    rng = np.random.RandomState(seed)
    data = rng.randn(2, 3, 10, 12).astype(np.float32)
    rois = np.array([[0, 1.3, 2.2, 8.7, 7.9],      # inside
                     [1, -2.1, 0.5, 5.2, 30.7],    # past two borders
                     [1, 3.1, 3.3, 3.6, 3.45],     # under a pixel wide
                     [-1.0, 0.3, 0.6, 11.4, 9.2],  # batch index from the end
                     [5.0, 4.4, 1.7, 9.9, 6.1]],   # past the last image
                    np.float32)
    return data, rois


@pytest.mark.parametrize("pooled,scale,ratio", [
    (3, 1.0, 2), ((3, 4), 0.5, 2), (2, 0.75, 0), ((1, 5), 1.0, 3)],
    ids=["square", "rect_half", "ratio0", "rect_ratio3"])
def test_roi_align_matches_jax(pooled, scale, ratio):
    data, rois = _roi_inputs()
    kw = dict(pooled_size=pooled, spatial_scale=scale, sample_ratio=ratio)
    want = _j(jcontrib.roi_align, data, rois, **kw)
    got = _t(tcontrib.roi_align, data, rois, **kw)
    ph, pw = (pooled, pooled) if isinstance(pooled, int) else pooled
    assert got.shape == (5, 3, ph, pw)
    np.testing.assert_allclose(got, want, **TOL)


def test_roi_align_gradients_match_jax():
    data, rois = _roi_inputs(1)
    rois = rois[[0, 1, 3]]            # away from the size floor's kink
    _assert_grads(_grads(
        lambda d, r: jcontrib.roi_align(d, r, (3, 2), 0.5, 2),
        lambda d, r: tcontrib.roi_align(d, r, (3, 2), 0.5, 2),
        [data, rois], wrt=[0, 1]), TOL)


def test_roi_align_chunks_the_rois(monkeypatch):
    """Chunked over the ROIs (here one ROI a chunk) the result is the
    same; its gradient (the corners' scatter in another order) stays at
    the JAX package's."""
    data, rois = _roi_inputs(2)
    whole = _grads(lambda d: jcontrib.roi_align(d, rois, 2, 1.0, 2),
                   lambda d: tcontrib.roi_align(d, torch.from_numpy(rois),
                                                2, 1.0, 2), [data], [0])
    monkeypatch.setattr(tcontrib, "ROI_CHUNK_BYTES", 1)
    chunked = _grads(lambda d: jcontrib.roi_align(d, rois, 2, 1.0, 2),
                     lambda d: tcontrib.roi_align(d, torch.from_numpy(rois),
                                                  2, 1.0, 2), [data], [0])
    np.testing.assert_array_equal(chunked[1][0], whole[1][0])
    _assert_grads(chunked, TOL)


RESIZES = [("grow", (16, 20), "NCHW"), ("shrink", (4, 5), "NCHW"),
           ("mixed", (17, 5), "NCHW"), ("mixed_nhwc", (3, 25), "NHWC"),
           ("same", (10, 12), "NCHW"), ("height_only", (7, 12), "NCHW")]


@pytest.mark.parametrize("name,hw,layout", RESIZES,
                         ids=[r[0] for r in RESIZES])
def test_bilinear_resize2d_matches_jax(name, hw, layout):
    x = np.random.RandomState(3).randn(2, 3, 10, 12).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(height=hw[0], width=hw[1], layout=layout)
    want = _j(jcontrib.bilinear_resize2d, x, **kw)
    got = _t(tcontrib.bilinear_resize2d, x, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(16, 20), (4, 5), (17, 5)],
                         ids=["grow", "shrink", "mixed"])
def test_bilinear_resize2d_gradient_matches_jax(hw):
    x = np.random.RandomState(4).randn(2, 3, 10, 12).astype(np.float32)
    _assert_grads(_grads(
        lambda d: jcontrib.bilinear_resize2d(d, *hw),
        lambda d: tcontrib.bilinear_resize2d(d, *hw), [x], [0]), TOL)


def test_bilinear_resize2d_of_integers_is_float32():
    x = np.arange(2 * 1 * 4 * 6, dtype=np.int32).reshape(2, 1, 4, 6)
    want = _j(jcontrib.bilinear_resize2d, x, height=7, width=3)
    got = _t(tcontrib.bilinear_resize2d, x, height=7, width=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# proposal and its sweep
# ---------------------------------------------------------------------------
K, H, W = 12, 8, 8


def _proposal_inputs(seed=5, scale=1.0):
    rng = np.random.RandomState(seed)
    cls = rng.rand(1, 2 * K, H, W).astype(np.float32)
    cls[0, K + 3, 2, 2:6] = cls[0, K + 3, 2, 1]      # equal scores
    bbox = (rng.randn(1, 4 * K, H, W) * 0.3).astype(np.float32)
    info = np.array([[128, 120, scale]], np.float32)
    return cls, bbox, info


@pytest.mark.parametrize("kw", [
    dict(), dict(output_score=True), dict(iou_loss=True),
    dict(iou_loss=True, output_score=True), dict(rpn_min_size=0),
    dict(threshold=0.3, rpn_post_nms_top_n=120, output_score=True),
    dict(rpn_min_size=24, output_score=True)],
    ids=["default", "score", "iou_loss", "iou_loss_score", "min_size0",
         "thresh0.3", "min_size24"])
def test_proposal_matches_jax(kw):
    cls, bbox, info = _proposal_inputs(scale=1.5 if "rpn_min_size" in kw
                                       else 1.0)
    if kw.get("iou_loss"):
        bbox = bbox * 20
    base = dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=50)
    base.update(kw)
    want = _j(jcontrib.proposal, cls, bbox, info, **base)
    got = _t(tcontrib.proposal, cls, bbox, info, **base)
    if kw.get("output_score"):
        (want, wscore), (got, gscore) = want, got
        np.testing.assert_array_equal(gscore, wscore)
    assert got.shape == want.shape == (base["rpn_post_nms_top_n"], 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_proposal_survivors_keep_the_jax_order():
    """The survivors' boxes in the JAX package's order: each port row's
    nearest JAX row is the first JAX row holding its box (the padding
    repeats the best proposal), as it is for the JAX rows themselves."""
    cls, bbox, info = _proposal_inputs(seed=6)
    want, wscore = _j(jcontrib.proposal, cls, bbox, info,
                      rpn_pre_nms_top_n=200, rpn_post_nms_top_n=200,
                      threshold=0.5, output_score=True)
    got, gscore = _t(tcontrib.proposal, cls, bbox, info,
                     rpn_pre_nms_top_n=200, rpn_post_nms_top_n=200,
                     threshold=0.5, output_score=True)
    dist = np.abs(got[:, None, 1:] - want[None, :, 1:]).sum(-1)
    self_dist = np.abs(want[:, None, 1:] - want[None, :, 1:]).sum(-1)
    np.testing.assert_array_equal(dist.argmin(1), self_dist.argmin(1))
    np.testing.assert_array_equal(gscore, wscore)
    padded = (want == want[0]).all(-1)
    assert padded[-1] and not padded.all()     # some rows were suppressed


def _numpy_sweep(boxes, alive, thresh):
    """The greedy sweep written out in numpy float32, one pair at a time:
    row i alive kills each later row j whose pixel-inclusive IoU with it
    is above thresh."""
    b = boxes.astype(np.float32)
    keep = alive.copy()
    one = np.float32(1)
    with np.errstate(all="ignore"):
        for i in range(len(b)):
            if not keep[i]:
                continue
            ai = (b[i, 2] - b[i, 0] + one) * (b[i, 3] - b[i, 1] + one)
            for j in range(i + 1, len(b)):
                iw = np.maximum(np.float32(0), np.minimum(b[i, 2], b[j, 2])
                                - np.maximum(b[i, 0], b[j, 0]) + one)
                ih = np.maximum(np.float32(0), np.minimum(b[i, 3], b[j, 3])
                                - np.maximum(b[i, 1], b[j, 1]) + one)
                inter = iw * ih
                aj = (b[j, 2] - b[j, 0] + one) * (b[j, 3] - b[j, 1] + one)
                iou = inter / (ai + aj - inter)
                if iou > np.float32(thresh):
                    keep[j] = False
    return keep


def _sweep_boxes(seed, n=60):
    """Pixel boxes on a small grid (many overlaps), with planted cases:
    rows 0-1 share one pixel column (IoU 41/42 counting pixels, 0 without),
    rows 2-3 touch at one pixel corner, rows 4-5 are equal, rows 6-7 are
    inverted by under a pixel, row 8 has a NaN coordinate, rows 9-10 are
    the same single pixel."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 40, (n, 2)).astype(np.float32)
    wh = rng.randint(0, 12, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], 1)
    b[0], b[1] = [100, 100, 100, 140], [100, 100, 100, 141]
    b[2], b[3] = [60, 60, 64, 64], [64, 64, 68, 68]
    b[4] = b[5] = [10, 10, 20, 25]
    b[6], b[7] = [30.5, 30.25, 30.0, 30.0], [30.4, 30.2, 30.1, 30.05]
    b[8] = [5, np.nan, 9, 9]
    b[9] = b[10] = [7, 7, 7, 7]
    return b


@pytest.mark.parametrize("thresh", [0.7, 0.3, 0.0, -0.1])
@pytest.mark.parametrize("seed", [0, 1])
def test_proposal_sweep_ref_matches_a_numpy_loop(thresh, seed):
    boxes = _sweep_boxes(seed)
    alive = np.random.RandomState(seed + 7).rand(len(boxes)) > 0.1
    alive[:11] = True
    want = _numpy_sweep(boxes, alive, thresh)
    got = tcontrib.proposal_sweep_ref(torch.from_numpy(boxes)[None],
                                      torch.from_numpy(alive)[None],
                                      thresh)[0].numpy()
    np.testing.assert_array_equal(got, want)
    if thresh == 0.7:
        # the one-pixel-wide pair and the single pixels: suppressed
        # counting pixels, kept by box_iou's continuous convention
        assert not got[1] and not got[10] and not got[5]
        cont = tcontrib.nms_sweep_ref(torch.from_numpy(boxes)[None], None,
                                      torch.from_numpy(alive)[None],
                                      thresh)[0].numpy()
        assert cont[1] and cont[10]


def test_proposal_sweep_ref_matches_the_jax_sweep():
    """`proposal` over pixel boxes (`iou_loss` adds integer deltas to
    small anchors on a 4-pixel grid, clipped at the image's edge), so
    that many boxes touch at one pixel; rpn_min_size 0 lets boxes
    inverted by up to a pixel in, and four scores are equal. The JAX
    package's sweep and the port's keep the same rows, in order."""
    n = K * H * W
    rng = np.random.RandomState(11)
    cls = rng.rand(1, 2 * K, H, W).astype(np.float32)
    cls[0, K:, 0, 0:4] = 0.95                        # four equal scores
    bbox = rng.randint(-4, 5, (1, 4 * K, H, W)).astype(np.float32)
    info = np.array([[400, 400, 1.0]], np.float32)
    kw = dict(rpn_pre_nms_top_n=n, rpn_post_nms_top_n=n, rpn_min_size=0,
              threshold=0.6, output_score=True, iou_loss=True,
              scales=(1, 2, 3, 4), ratios=(0.5, 1, 2), feature_stride=4)
    jrois, jscore = _j(jcontrib.proposal, cls, bbox, info, **kw)
    trois, tscore = _t(tcontrib.proposal, cls, bbox, info, **kw)
    np.testing.assert_array_equal(trois, jrois)
    np.testing.assert_array_equal(tscore, jscore)
    padded = (jrois == jrois[0]).all(-1)
    assert padded[-1] and not padded.all()     # some rows were suppressed


def test_proposal_on_cpu_takes_the_plain_sweep(monkeypatch):
    calls = []
    ref = tcontrib.proposal_sweep_ref

    def counting(*a):
        calls.append(a[0].shape)
        return ref(*a)
    monkeypatch.setattr(tcontrib, "proposal_sweep_ref", counting)
    cls, bbox, info = _proposal_inputs()
    _t(tcontrib.proposal, cls, bbox, info, rpn_pre_nms_top_n=100,
       rpn_post_nms_top_n=10)
    assert calls == [(1, 100, 4)]


# ---------------------------------------------------------------------------
# deformable convolution and PS ROI pooling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(pad=(1, 1)), dict(stride=(2, 1), dilate=(2, 2), pad=(2, 1)),
    dict(pad=(1, 1), num_deformable_group=2)],
    ids=["pad1", "stride_dilate", "groups2"])
def test_deformable_convolution_matches_jax_with_all_gradients(kw):
    rng = np.random.RandomState(12)
    G = kw.get("num_deformable_group", 1)
    x = rng.randn(2, 4, 7, 8).astype(np.float32)
    wt = (rng.randn(5, 4, 3, 3) / 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    st, pd, dl = (kw.get(k, (1, 1) if k != "pad" else (0, 0))
                  for k in ("stride", "pad", "dilate"))
    ho = (7 + 2 * pd[0] - dl[0] * 2 - 1) // st[0] + 1
    wo = (8 + 2 * pd[1] - dl[1] * 2 - 1) // st[1] + 1
    # offsets of a few pixels, off the integer lattice
    off = (rng.randn(2, 2 * G * 9, ho, wo) * 1.7 + 0.13).astype(np.float32)
    _assert_grads(_grads(
        lambda *a: jcontrib.deformable_convolution(*a, **kw),
        lambda *a: tcontrib.deformable_convolution(*a, **kw),
        [x, off, wt, b], wrt=[0, 1, 2, 3]), TOL4)


def test_deformable_convolution_without_bias_matches_jax():
    rng = np.random.RandomState(13)
    x = rng.randn(1, 3, 6, 6).astype(np.float32)
    off = (rng.randn(1, 18, 6, 6) * 2).astype(np.float32)
    wt = rng.randn(2, 3, 3, 3).astype(np.float32)
    want = _j(jcontrib.deformable_convolution, x, off, wt, pad=(1, 1))
    got = _t(tcontrib.deformable_convolution, x, off, wt, pad=(1, 1))
    np.testing.assert_allclose(got, want, **TOL4)


def _psroi_inputs(seed=14, classes=3, group=3):
    rng = np.random.RandomState(seed)
    data = rng.randn(2, classes * group * group, 10, 12).astype(np.float32)
    rois = np.array([[0, 10.4, 12.5, 80.2, 70.7], [1, 0, 0, 190, 150],
                     [1, 30, 30, 33, 31], [0, -20, 40, 60, 260],
                     [-1, 5.5, 6.5, 100.5, 90.5]], np.float32)
    return data, rois


@pytest.mark.parametrize("pooled,group", [(3, 0), (2, 3), (4, 2)],
                         ids=["group=pooled", "pooled<group",
                              "pooled>group"])
def test_psroi_pooling_matches_jax_with_gradient(pooled, group):
    G = group or pooled
    data, rois = _psroi_inputs(group=G)
    _assert_grads(_grads(
        lambda d: jcontrib.psroi_pooling(d, rois, 1 / 16.0, 3, pooled,
                                         group),
        lambda d: tcontrib.psroi_pooling(d, torch.from_numpy(rois),
                                         1 / 16.0, 3, pooled, group),
        [data], wrt=[0]), TOL4)


# ---------------------------------------------------------------------------
# the npx names through the dispatch, and their dtypes under autocast
# ---------------------------------------------------------------------------
def _npx_calls():
    rng = np.random.RandomState(15)
    data, rois = _roi_inputs()
    ps, psr = _psroi_inputs()
    cls, bbox, info = _proposal_inputs()
    x = rng.randn(1, 4, 6, 6).astype(np.float32)
    off = rng.randn(1, 18, 6, 6).astype(np.float32)
    wt = rng.randn(3, 4, 3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    return [
        ("roi_align", (data, rois), dict(pooled_size=(2, 3),
                                         spatial_scale=0.5)),
        ("bilinear_resize2d", (data,), dict(height=13, width=5)),
        ("proposal", (cls, bbox, info), dict(rpn_pre_nms_top_n=120,
                                             rpn_post_nms_top_n=30,
                                             output_score=True)),
        ("deformable_convolution", (x, off, wt, b), dict(pad=(1, 1))),
        ("psroi_pooling", (ps, psr), dict(spatial_scale=1 / 16.0,
                                          output_dim=3, pooled_size=3)),
    ]


def _npx_both(name, arrays, kw):
    jout = getattr(jmx.npx, name)(*[jmx.np.array(a) for a in arrays], **kw)
    with tmx.cpu():
        tout = getattr(tmx.npx, name)(*[tmx.np.array(a) for a in arrays],
                                      **kw)
    jout = jout if isinstance(jout, (tuple, list)) else (jout,)
    tout = tout if isinstance(tout, (tuple, list)) else (tout,)
    return jout, tout


@pytest.mark.parametrize("i", range(5), ids=[c[0] for c in _npx_calls()])
def test_npx_names_match_jax(i):
    name, arrays, kw = _npx_calls()[i]
    jout, tout = _npx_both(name, arrays, kw)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert str(t.dtype) == str(j.dtype)
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL4)


@pytest.mark.parametrize("i", range(5), ids=[c[0] for c in _npx_calls()])
def test_npx_result_dtypes_under_autocast_bf16_match_jax(i):
    name, arrays, kw = _npx_calls()[i]
    with jmx.amp.autocast(True), tamp.autocast(True):
        assert tamp.is_active() and tamp.target_dtype() == "bfloat16"
        jout, tout = _npx_both(name, arrays, kw)
    assert not tamp.is_active()
    assert [str(t.dtype) for t in tout] == [str(j.dtype) for j in jout]
    tol = dict(rtol=5e-2, atol=5e-2)   # the safe op's inputs go to bf16
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.asnumpy().astype(np.float32),
                                   j.asnumpy().astype(np.float32), **tol)


def test_npx_proposal_has_no_gradient():
    cls, bbox, info = _proposal_inputs()
    with tmx.cpu():
        c = tmx.np.array(cls)
        c.attach_grad()
        with tmx.autograd.record():
            rois = tmx.npx.proposal(c, tmx.np.array(bbox),
                                    tmx.np.array(info),
                                    rpn_pre_nms_top_n=50,
                                    rpn_post_nms_top_n=5)
    assert not rois._t.requires_grad
