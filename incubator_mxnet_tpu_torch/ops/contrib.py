"""Detection ops of the PyTorch port: box IoU, greedy NMS and SSD's multibox
tail (priors, training targets, decode + NMS).

Counterpart of `incubator_mxnet_tpu/ops/contrib.py` (`box_iou`,
`_center_to_corner`, `box_nms`, `multibox_prior`, `_encode_loc`,
`multibox_target`, `multibox_detection`), with the same fixed shapes and
the same order of ties: every sort is stable and ascending over the key
the JAX package sorts (the negated score where it sorts the negation),
and every argmax takes the first maximum. The multibox ops are not
differentiable: their inputs are detached, as the JAX package's
`stop_gradient` does.

The greedy sweep both NMS ops run (`nms_sweep`) takes the card's
hand-written kernels (`ops/csrc/nms.cu`, through `kernels.nms_sweep_cuda`:
a suppression bitmask of every pair computed over the whole card, then a
sweep of it a block an image) for a CUDA tensor and its plain version
`nms_sweep_ref` for a CPU one.
The JAX package runs the sweep as one `lax.fori_loop` inside a jitted
program; eagerly it would cost a few launches a row. The kernel takes
float32 boxes: `box_nms` of another type raises on the card.

The Faster-RCNN / R-FCN tail (`roi_align`, `bilinear_resize2d`,
`proposal`, `deformable_convolution`, `psroi_pooling`) computes what the
JAX module's does, op by op in its order, but over all ROIs (or output
positions) at once with indexed gathers where the JAX package vmaps one at
a time. `roi_align` gathers its ROIs in chunks (`ROI_CHUNK_BYTES` of each
corner's gather at a time), so Faster-RCNN's 300 ROIs over 1024 channels
never hold all four corners of every sample at once. `bilinear_resize2d`
is `jax.image.resize(method="linear")`: two products with the weight
matrices `jax.image.scale_and_translate` builds (half-pixel centres, a
triangle widened by the scale on a shrink, weights normalised per
output), over the axes whose size changes. The matrix products of the
resize and of the deformable convolution go to `torch.matmul`: no Pallas
kernel stands behind them.

`proposal`'s greedy sweep measures IoU as the reference's proposal op does
(pixel-inclusive: `+ 1` on every width and height, no guard on the
division), which `nms_sweep`'s kernel does not. Its sweep
(`proposal_sweep`) takes its own convention of the same kernels
(`kernels.proposal_sweep_cuda`) for a CUDA tensor and its plain version
`proposal_sweep_ref` for a CPU one.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from . import kernels
from .nn import clamp_index

__all__ = ["box_iou", "box_nms", "multibox_prior", "multibox_target",
           "multibox_detection", "nms_sweep", "nms_sweep_ref", "roi_align",
           "bilinear_resize2d", "proposal", "proposal_sweep",
           "proposal_sweep_ref", "deformable_convolution", "psroi_pooling"]


def box_iou(lhs, rhs, fmt="corner"):
    """Pairwise IoU: lhs (..., N, 4), rhs (..., M, 4) -> (..., N, M);
    `fmt` "corner" (x1, y1, x2, y2) or "center" (x, y, w, h)."""
    if fmt == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    lx1, ly1, lx2, ly2 = [lhs[..., :, None, i] for i in range(4)]
    rx1, ry1, rx2, ry2 = [rhs[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1)).clamp(min=0)
    ih = (torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1)).clamp(min=0)
    inter = iw * ih
    area_l = (lx2 - lx1).clamp(min=0) * (ly2 - ly1).clamp(min=0)
    area_r = (rx2 - rx1).clamp(min=0) * (ry2 - ry1).clamp(min=0)
    union = area_l + area_r - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(b):
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


# ---------------------------------------------------------------------------
# the greedy sweep
# ---------------------------------------------------------------------------
def nms_sweep_ref(boxes, ids, keep, thresh):
    """The plain greedy sweep over rows already in score order.

    boxes (B, A, 4) corner boxes; ids (B, A) class ids, or None to
    suppress across classes; keep (B, A) bool, the rows alive at the
    start. Row i, if still alive, kills every later alive row j of its
    class whose IoU with it is above `thresh` (the IoU op by op as
    `box_iou` computes it). Returns the keep mask after the sweep. One row
    a step, vectorised over the batch."""
    keep = keep.clone()
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    cols = torch.arange(boxes.shape[1], device=boxes.device)
    for i in range(boxes.shape[1] - 1):
        s = slice(i, i + 1)
        iw = (torch.minimum(x2[:, s], x2)
              - torch.maximum(x1[:, s], x1)).clamp(min=0)
        ih = (torch.minimum(y2[:, s], y2)
              - torch.maximum(y1[:, s], y1)).clamp(min=0)
        inter = iw * ih
        union = area[:, s] + area - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        kill = (iou > thresh) & (cols > i) & keep[:, s] & keep
        if ids is not None:
            kill &= ids == ids[:, s]
        keep &= ~kill
    return keep


def nms_sweep(boxes, ids, keep, thresh):
    """`nms_sweep_ref`'s sweep: on the card the hand-written kernel
    (float32 boxes and ids), on the CPU the plain version."""
    if boxes.is_cuda:
        return kernels.nms_sweep_cuda(boxes, ids, keep, thresh)
    return nms_sweep_ref(boxes, ids, keep, thresh)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False):
    """Greedy NMS of data (..., N, K), rows [id, score, x1, y1, x2, y2, ...]
    by default: the rows come back in descending score order (ties in
    their order), suppressed and invalid ones with score -1."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    n = flat.shape[1]
    scores = flat[..., score_index]
    order = torch.sort(-scores, dim=1, stable=True).indices
    sorted_batch = torch.gather(
        flat, 1, order[..., None].expand(-1, -1, flat.shape[2]))
    sorted_scores = sorted_batch[..., score_index]
    valid = sorted_scores > valid_thresh
    if topk > 0:
        valid &= torch.arange(n, device=data.device) < topk
    boxes = sorted_batch[..., coord_start:coord_start + 4].contiguous()
    ids = sorted_batch[..., id_index].contiguous() \
        if id_index >= 0 and not force_suppress else None
    keep = nms_sweep(boxes, ids, valid, overlap_thresh)
    out = sorted_batch.clone()
    out[..., score_index] = torch.where(keep, sorted_scores, -1.0)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# SSD's multibox tail
# ---------------------------------------------------------------------------
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), layout="NCHW"):
    """SSD prior boxes of a feature map: (1, H*W*K, 4) corner boxes in
    [0, 1] coordinates, K = len(sizes) + len(ratios) - 1, each cell's in
    the order each size with ratios[0], then sizes[0] with ratios[1:].
    They depend on the map's size alone, not its values."""
    if layout == "NCHW":
        in_h, in_w = int(data.shape[2]), int(data.shape[3])
    else:
        in_h, in_w = int(data.shape[1]), int(data.shape[2])
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    cy = (torch.arange(in_h, dtype=torch.float32, device=dev)
          + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32, device=dev)
          + offsets[1]) * step_x
    hw, hh = [], []
    r0 = math.sqrt(ratios[0]) if len(ratios) else 1.0
    for s in sizes:
        hw.append(s * in_h / in_w * r0 / 2)
        hh.append(s / r0 / 2)
    for r in ratios[1:]:
        sr = math.sqrt(r)
        hw.append(sizes[0] * in_h / in_w * sr / 2)
        hh.append(sizes[0] / sr / 2)
    hw = torch.tensor(hw, dtype=torch.float32, device=dev)
    hh = torch.tensor(hh, dtype=torch.float32, device=dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    boxes = boxes.reshape(1, in_h * in_w * hw.shape[0], 4)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def _encode_loc(anchor, gt, variances):
    """SSD's box encoding of `gt` against `anchor` (corner boxes); the
    variances 0-d float32 tensors on the boxes' device (a division by a
    tensor, not a host scalar: the card divides by a host scalar through
    its reciprocal)."""
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) * 0.5
    ay = (anchor[..., 1] + anchor[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    eps = 1e-12
    return torch.stack([
        (gx - ax) / aw.clamp(min=eps) / variances[0],
        (gy - ay) / ah.clamp(min=eps) / variances[1],
        torch.log(gw.clamp(min=eps) / aw.clamp(min=eps)) / variances[2],
        torch.log(gh.clamp(min=eps) / ah.clamp(min=eps)) / variances[3],
    ], dim=-1)


def _bipartite(ious):
    """The greedy bipartite matcher: G times, the pair of highest IoU left
    (the first in (anchor, gt) order on a tie) is matched when above 1e-6
    and its anchor row and gt column are taken out. ious (B, A, G), -1 at
    padding columns. Returns (match, flags), (B, A) int64: the matched gt
    and 1 where matched, -1 elsewhere."""
    B, A, G = ious.shape
    iou_m = ious.clone()
    flat_m = iou_m.view(B, A * G)
    match = torch.full((B, A), -1, dtype=torch.int64, device=ious.device)
    flags = torch.full_like(match, -1)
    b = torch.arange(B, device=ious.device)
    for _ in range(G):
        flat = flat_m.argmax(dim=1)
        aj, gk = flat // G, flat % G
        take = flat_m[b, flat] > 1e-6
        match[b, aj] = torch.where(take, gk, match[b, aj])
        flags[b, aj] = torch.where(take, 1, flags[b, aj])
        iou_m[b, aj, :] = torch.where(take[:, None], -1.0, iou_m[b, aj, :])
        iou_m[b, :, gk] = torch.where(take[:, None], -1.0, iou_m[b, :, gk])
    return match, flags


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD's training targets.

    anchor (1, A, 4) or (A, 4); label (B, G, 5) rows [cls, x1, y1, x2, y2],
    every row from the first with cls -1 on padding; cls_pred (B, classes,
    A), read by the negative mining. Returns (loc_target (B, A*4),
    loc_mask (B, A*4), cls_target (B, A)): the bipartite match, then every
    other anchor whose best IoU is above `overlap_threshold`; with
    `negative_mining_ratio` > 0 the negatives are the unmatched anchors
    (best IoU below `negative_mining_thresh`) of lowest background softmax
    probability, ratio x positives of them (at least
    `minimum_negative_samples`), the rest `ignore_label`."""
    anc = anchor.detach().reshape(-1, 4)
    label = label.detach()
    cls_pred = cls_pred.detach()
    A = anc.shape[0]
    B, G = label.shape[:2]
    dev = anc.device
    valid = torch.cumprod((label[:, :, 0] != -1.0).to(torch.int32),
                          dim=1).bool()                           # (B, G)
    ious = box_iou(anc, label[:, :, 1:5])                         # (B, A, G)
    ious = torch.where(valid[:, None, :], ious, -1.0)
    match, flags = _bipartite(ious)

    best_iou, _ = ious.max(dim=2)
    best_gt = ious.argmax(dim=2)
    if overlap_threshold > 0:
        thr_pos = (flags != 1) & (best_iou > overlap_threshold)
        match = torch.where(thr_pos, best_gt, match)
        flags = torch.where(thr_pos, 1, flags)
    num_pos = (flags == 1).sum(dim=1)                             # (B,)

    if negative_mining_ratio > 0:
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]            # (B, A)
        neg_cand = (flags != 1) & (best_iou < negative_mining_thresh)
        num_neg = torch.minimum(
            (num_pos * negative_mining_ratio).to(torch.int32), A - num_pos)
        num_neg = num_neg.clamp(min=minimum_negative_samples)
        score = torch.where(neg_cand, -bg_prob, -math.inf)
        order = torch.sort(-score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(B, A))
        flags = torch.where(neg_cand & (rank < num_neg[:, None]), 0, flags)
    else:
        flags = torch.where(flags != 1, 0, flags)

    gt_rows = torch.gather(label, 1, match.clamp(0, G - 1)[..., None]
                           .expand(B, A, label.shape[2]))          # (B, A, 5)
    var = [torch.full((), v, dtype=torch.float32, device=dev)
           for v in variances]
    loc_t = _encode_loc(anc, gt_rows[..., 1:5], var)
    pos = flags == 1
    loc_t = torch.where(pos[..., None], loc_t, 0.0)
    loc_m = pos[..., None].expand(B, A, 4).to(torch.float32)
    cls_t = torch.where(pos, gt_rows[..., 0] + 1.0,
                        torch.where(flags == 0, 0.0, float(ignore_label)))
    return (loc_t.reshape(B, -1), loc_m.reshape(B, -1),
            cls_t.to(anc.dtype))


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD's decode and per-class NMS.

    cls_prob (B, classes, A) softmax probabilities, loc_pred (B, A*4),
    anchor (1, A, 4). Returns (B, A, 6) rows [id, score, x1, y1, x2, y2]:
    ids renumbered without the background class, a row under `threshold`
    or suppressed has id -1 (and score -1), and the valid rows come first
    in score order, the invalid ones after them in theirs."""
    cls_prob = cls_prob.detach()
    loc_pred = loc_pred.detach()
    anc = anchor.detach().reshape(-1, 4)
    A = anc.shape[0]
    B = cls_prob.shape[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    ax = (anc[:, 0] + anc[:, 2]) * 0.5
    ay = (anc[:, 1] + anc[:, 3]) * 0.5
    lp = loc_pred.reshape(B, A, 4)
    fg = cls_prob.clone()
    fg[:, background_id] = -math.inf
    score = fg.amax(dim=1)                                        # (B, A)
    cls = fg.argmax(dim=1)
    cid = cls - (cls > background_id).to(cls.dtype) + 1
    cid = torch.where(score < threshold, 0, cid)
    ox = lp[..., 0] * variances[0] * aw + ax
    oy = lp[..., 1] * variances[1] * ah + ay
    ow = torch.exp(lp[..., 2] * variances[2]) * aw / 2
    oh = torch.exp(lp[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    out_id = cid.to(torch.float32) - 1.0

    key = -torch.where(out_id >= 0, score, -1.0)
    order = torch.sort(key, dim=1, stable=True).indices
    s_id = torch.gather(out_id, 1, order)
    s_score = torch.gather(score, 1, order)
    s_boxes = torch.gather(boxes, 1, order[..., None].expand(B, A, 4))
    if nms_topk > 0:
        s_id = torch.where(torch.arange(A, device=anc.device) < nms_topk,
                           s_id, -1.0)
    keep = nms_sweep(s_boxes.contiguous(),
                     None if force_suppress else s_id.contiguous(),
                     s_id >= 0, nms_threshold)
    s_id = torch.where(keep, s_id, -1.0)

    invalid = s_id < 0
    comp = torch.sort(invalid.to(torch.uint8), dim=1, stable=True).indices
    rows = torch.cat([s_id[..., None],
                      torch.where(invalid, -1.0, s_score)[..., None],
                      s_boxes], dim=-1)
    return torch.gather(rows, 1, comp[..., None].expand(B, A, 6))



# ---------------------------------------------------------------------------
# ROI Align and the bilinear resize
# ---------------------------------------------------------------------------
# the most bytes one corner's gather of `roi_align` takes at a time: the
# ROIs go in chunks of this size (four corners and the blend's temporaries
# stay under ~4 GB at Faster-RCNN's 300 ROIs x 1024 channels x 28^2)
ROI_CHUNK_BYTES = 1 << 29


def _pixel_table(data):
    """data (N, C, H, W) as (N * H * W, C) rows: pixel (n, y, x) at row
    (n * H + y) * W + x, so one index gathers a pixel's channels."""
    N, C, H, W = data.shape
    return data.permute(0, 2, 3, 1).reshape(N * H * W, C)


def _bilinear_rows(table, bidx, ys, xs, H, W):
    """The bilinear samples of each ROI's grid ys x xs with the border
    clamped, as the JAX package's `_bilinear_sample` blends them: table
    from `_pixel_table`, bidx (R,) image rows, ys (R, Sy), xs (R, Sx).
    Returns (R, Sy, Sx, C)."""
    y = ys.clamp(0.0, H - 1.0)
    x = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64).clamp(0, H - 1)
    x0 = torch.floor(x).to(torch.int64).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (y - y0)[:, :, None, None]
    wx = (x - x0)[:, None, :, None]
    rows = bidx[:, None] * H
    r0 = ((rows + y0) * W)[:, :, None]
    r1 = ((rows + y1) * W)[:, :, None]
    c0, c1 = x0[:, None, :], x1[:, None, :]
    v00, v01 = table[r0 + c0], table[r0 + c1]
    v10, v11 = table[r1 + c0], table[r1 + c1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=2):
    """ROI Align: data (N, C, H, W), rois (R, 5) rows [batch_idx, x1, y1,
    x2, y2] in image coordinates. Returns (R, C, ph, pw): each bin the mean
    of sample_ratio^2 bilinear samples (2^2 when sample_ratio <= 0), the
    border clamped. Differentiable in data and rois."""
    ph, pw = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)
    N, C, H, W = data.shape
    s = sample_ratio if sample_ratio > 0 else 2
    R = rois.shape[0]
    bidx = clamp_index(rois[:, 0].detach().to(torch.int64), N)
    x1, y1, x2, y2 = (rois[:, c] * spatial_scale for c in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w = rw / pw
    bin_h = rh / ph
    steps_y = torch.arange(ph * s, device=rois.device) + 0.5
    steps_x = torch.arange(pw * s, device=rois.device) + 0.5
    ys = y1[:, None] + steps_y * (bin_h / s)[:, None]
    xs = x1[:, None] + steps_x * (bin_w / s)[:, None]
    table = _pixel_table(data)
    per_roi = ph * s * pw * s * C * data.element_size()
    chunk = max(1, ROI_CHUNK_BYTES // max(1, per_roi))
    outs = []
    for r0 in range(0, R, chunk):
        sl = slice(r0, min(R, r0 + chunk))
        vals = _bilinear_rows(table, bidx[sl], ys[sl], xs[sl], H, W)
        vals = vals.reshape(vals.shape[0], ph, s, pw, s, C)
        outs.append(vals.mean(dim=(2, 4)).permute(0, 3, 1, 2))
    if not outs:
        dt = torch.promote_types(data.dtype, ys.dtype)
        return torch.zeros((0, C, ph, pw), dtype=dt, device=data.device)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _resize_weights(n_in, n_out, dtype, device):
    """The (n_in, n_out) weights `jax.image.scale_and_translate` builds for
    a linear resize of one axis (scale n_out / n_in, no translation), in
    its float32 arithmetic: half-pixel sample centres, the triangle kernel
    widened by 1 / scale on a shrink (antialiasing), each output's weights
    divided by their sum (0 where that sum is about 0), and 0 for a sample
    outside the input."""
    f32 = torch.float32
    scale = 1.0 if n_out == 0 else n_out / n_in
    inv = torch.tensor(1.0 / scale, dtype=f32, device=device)
    widen = torch.tensor(max(1.0 / scale, 1.0), dtype=f32, device=device)
    sample = ((torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv
              - 0.0 * inv - 0.5)
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32,
                                           device=device)[:, None]).abs()
    w = torch.clamp(1 - (dist / widen).abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(_np.finfo(_np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype)


def bilinear_resize2d(data, height, width, layout="NCHW"):
    """`jax.image.resize(data, shape, method="linear")` of the spatial axes
    of an NCHW (or NHWC) batch to height x width: an axis whose size
    changes is one product with `_resize_weights`' matrix; integer input
    resizes as float32. Differentiable in data."""
    if not data.is_floating_point():
        data = data.to(torch.float32)
    axes = (2, 3) if layout == "NCHW" else (1, 2)
    out = data
    for ax, n in zip(axes, (int(height), int(width))):
        m = data.shape[ax]
        if n == m:
            continue
        w = _resize_weights(m, n, data.dtype, data.device)
        out = torch.matmul(out.movedim(ax, -1), w).movedim(-1, ax)
    return out


# ---------------------------------------------------------------------------
# the Faster-RCNN proposal op
# ---------------------------------------------------------------------------
def _generate_base_anchors(base_size, ratios, scales):
    """The reference's anchor enumeration around a base_size x base_size
    window: each ratio (area-preserving, rounded), then each scale; (K, 4)
    float32 corner boxes, K = len(ratios) * len(scales). Host numpy on the
    configuration alone."""
    base = _np.array([0, 0, base_size - 1, base_size - 1], _np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        size = w * h
        size_r = size / r
        ws = _np.round(_np.sqrt(size_r))
        hs = _np.round(ws * r)
        for sc in scales:
            wss, hss = ws * sc, hs * sc
            out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                        cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return _np.asarray(out, _np.float32)


def proposal_sweep_ref(boxes, keep, thresh):
    """The plain greedy sweep of `proposal`, over rows already in score
    order: boxes (B, A, 4) corner boxes, keep (B, A) bool, the rows alive
    at the start. Row i, if still alive, kills every later row whose
    pixel-inclusive IoU with it is above `thresh`: widths and heights
    `(x2 - x1) + 1`, the overlap's clamped at 0, `inter / ((a_i + a_j) -
    inter)` with no guard (x / 0 is inf, 0 / 0 NaN), op by op as the JAX
    package's sweep computes it. Returns the keep mask after the sweep. One
    row a step, vectorised over the batch."""
    keep = keep.clone()
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = ((x2 - x1) + 1.0) * ((y2 - y1) + 1.0)
    cols = torch.arange(boxes.shape[1], device=boxes.device)
    for i in range(boxes.shape[1] - 1):
        s = slice(i, i + 1)
        iw = ((torch.minimum(x2[:, s], x2) - torch.maximum(x1[:, s], x1))
              + 1.0).clamp(min=0)
        ih = ((torch.minimum(y2[:, s], y2) - torch.maximum(y1[:, s], y1))
              + 1.0).clamp(min=0)
        inter = iw * ih
        iou = inter / ((area[:, s] + area) - inter)
        keep &= ~((iou > thresh) & (cols > i) & keep[:, s])
    return keep


def proposal_sweep(boxes, keep, thresh):
    """`proposal_sweep_ref`'s sweep: on the card the hand-written kernel
    (float32 boxes), on the CPU the plain version."""
    if boxes.is_cuda:
        return kernels.proposal_sweep_cuda(boxes, keep, thresh)
    return proposal_sweep_ref(boxes, keep, thresh)


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals of one image: cls_prob (1, 2K, H, W) (background
    scores, then foreground), bbox_pred (1, 4K, H, W), im_info (1, 3)
    [height, width, scale]. Decodes each anchor's box (or adds the deltas
    when `iou_loss`), clips it to the image, drops boxes under
    rpn_min_size x scale, takes the `rpn_pre_nms_top_n` best in stable
    descending score order, sweeps them (`proposal_sweep`, IoU above
    `threshold` suppressed) and returns the `rpn_post_nms_top_n` survivors
    in order as (post_n, 5) rows [0, x1, y1, x2, y2] (and their scores
    (post_n, 1) when `output_score`), a short result padded by repeating
    the best proposal. Not differentiable: the inputs are detached."""
    cls_prob = cls_prob.detach()
    bbox_pred = bbox_pred.detach()
    im_info = im_info.detach()
    dev = cls_prob.device
    K = cls_prob.shape[1] // 2
    H, W = int(cls_prob.shape[2]), int(cls_prob.shape[3])
    count = K * H * W
    pre_n = min(rpn_pre_nms_top_n if rpn_pre_nms_top_n > 0 else count,
                count)
    post_n = min(rpn_post_nms_top_n, pre_n)

    base = torch.from_numpy(_generate_base_anchors(
        feature_stride, ratios, scales)).to(dev)                  # (K, 4)
    sy = torch.arange(H, dtype=torch.float32, device=dev) * feature_stride
    sx = torch.arange(W, dtype=torch.float32, device=dev) * feature_stride
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([sxg, syg, sxg, syg], dim=-1)             # (H, W, 4)
    anchors = (base[None, None] + shift[:, :, None]).reshape(-1, 4)

    fg = cls_prob[0, K:].permute(1, 2, 0).reshape(-1)
    deltas = bbox_pred[0].reshape(K, 4, H, W).permute(2, 3, 0, 1) \
        .reshape(-1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = anchors[:, 1] + 0.5 * (ah - 1.0)
    if iou_loss:
        x1 = anchors[:, 0] + deltas[:, 0]
        y1 = anchors[:, 1] + deltas[:, 1]
        x2 = anchors[:, 2] + deltas[:, 2]
        y2 = anchors[:, 3] + deltas[:, 3]
    else:
        px = deltas[:, 0] * aw + ax
        py = deltas[:, 1] * ah + ay
        pw = torch.exp(deltas[:, 2].clamp(-10, 10)) * aw
        ph = torch.exp(deltas[:, 3].clamp(-10, 10)) * ah
        x1 = px - 0.5 * (pw - 1.0)
        y1 = py - 0.5 * (ph - 1.0)
        x2 = px + 0.5 * (pw - 1.0)
        y2 = py + 0.5 * (ph - 1.0)
    im_h, im_w, im_scale = im_info[0, 0], im_info[0, 1], im_info[0, 2]
    zero = torch.zeros((), dtype=x1.dtype, device=dev)
    x1 = torch.minimum(torch.maximum(x1, zero), im_w - 1.0)
    y1 = torch.minimum(torch.maximum(y1, zero), im_h - 1.0)
    x2 = torch.minimum(torch.maximum(x2, zero), im_w - 1.0)
    y2 = torch.minimum(torch.maximum(y2, zero), im_h - 1.0)

    min_size = rpn_min_size * im_scale
    big = ((x2 - x1 + 1.0) >= min_size) & ((y2 - y1 + 1.0) >= min_size)
    score = torch.where(big, fg, -1.0)
    take = torch.sort(-score, stable=True).indices[:pre_n]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)[take].contiguous()
    score = score[take]

    alive0 = score > -1.0
    kept = proposal_sweep(boxes[None], alive0[None].contiguous(),
                          threshold)[0]
    # a row alive at the start and suppressed reads -1; the others keep
    # their score (a row not alive at the start suppresses nothing)
    alive = torch.where(kept, score, torch.where(alive0, -1.0, score))
    comp = torch.sort((alive <= -1.0).to(torch.uint8),
                      stable=True).indices[:post_n]
    out_boxes = boxes[comp]
    out_score = alive[comp]
    bad = out_score <= -1.0
    out_boxes = torch.where(bad[:, None], out_boxes[0][None], out_boxes)
    out_score = torch.where(bad, out_score[0], out_score)
    rois = torch.cat([out_boxes.new_zeros((post_n, 1)), out_boxes], dim=-1)
    if output_score:
        return rois, out_score[:, None]
    return rois


# ---------------------------------------------------------------------------
# deformable convolution (v1) and position-sensitive ROI pooling
# ---------------------------------------------------------------------------
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_deformable_group=1):
    """Deformable convolution v1: data (B, C, H, W); offset (B, 2 G kh kw,
    Ho, Wo) ordered (group, kh, kw, [dy, dx]); weight (Co, C, kh, kw).
    Each tap samples its group's channels bilinearly at its offset
    position (0 outside the image, each corner on its own), the columns
    (B Ho Wo, kh kw C) then go through one product with the weight.
    Differentiable in data, offset, weight and bias."""
    B, C, H, W = data.shape
    kh, kw = kernel
    Co = weight.shape[0]
    G = num_deformable_group
    Ho = (H + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    dev = data.device

    oy = torch.arange(Ho, device=dev) * stride[0] - pad[0]
    ox = torch.arange(Wo, device=dev) * stride[1] - pad[1]
    ky = torch.arange(kh, device=dev) * dilate[0]
    kx = torch.arange(kw, device=dev) * dilate[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        Ho, Wo, kh, kw).to(torch.float32)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        Ho, Wo, kh, kw).to(torch.float32)

    off = offset.reshape(B, G, kh, kw, 2, Ho, Wo)
    dy = off[:, :, :, :, 0].permute(0, 1, 4, 5, 2, 3)   # (B, G, Ho, Wo, kh, kw)
    dx = off[:, :, :, :, 1].permute(0, 1, 4, 5, 2, 3)
    sy = base_y + dy
    sx = base_x + dx
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]

    Cg = C // G
    b = torch.arange(B, device=dev).view(B, 1, 1, 1, 1)

    def corner(table, yy, xx):
        """(B, Ho, Wo, kh, kw, Cg): the pixels at yy, xx (clamped into the
        image for the gather), 0 where the position is outside."""
        yi = yy.clamp(0, H - 1).to(torch.int64)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        inb = ((yy >= 0) & (yy <= H - 1) & (xx >= 0)
               & (xx <= W - 1)).to(table.dtype)
        return table[(b * H + yi) * W + xi] * inb[..., None]

    cols = []
    for g in range(G):
        table = _pixel_table(data[:, g * Cg:(g + 1) * Cg])
        yg, xg, wyg, wxg = y0[:, g], x0[:, g], wy[:, g], wx[:, g]
        v00 = corner(table, yg, xg)
        v01 = corner(table, yg, xg + 1)
        v10 = corner(table, yg + 1, xg)
        v11 = corner(table, yg + 1, xg + 1)
        cols.append(v00 * (1 - wyg) * (1 - wxg) + v01 * (1 - wyg) * wxg
                    + v10 * wyg * (1 - wxg) + v11 * wyg * wxg)
    cols = torch.cat(cols, dim=-1) if G > 1 else cols[0]
    cols2 = cols.reshape(B * Ho * Wo, kh * kw * C)
    wmat = weight.permute(2, 3, 1, 0).reshape(kh * kw * C, Co)
    # the sampling weights are float32, so 16-bit data give float32
    # columns; the product takes the wider type, as jnp's promotion does
    dt = torch.promote_types(cols2.dtype, wmat.dtype)
    out = torch.matmul(cols2.to(dt), wmat.to(dt))
    out = out.reshape(B, Ho, Wo, Co).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + bias.reshape(1, Co, 1, 1)
    return out


def psroi_pooling(data, rois, spatial_scale, output_dim, pooled_size,
                  group_size=0):
    """Position-sensitive ROI pooling (R-FCN): data (B, output_dim * G^2,
    H, W), rois (R, 5) rows [batch_idx, x1, y1, x2, y2] in image
    coordinates. Returns (R, output_dim, P, P): bin (i, j) of output
    channel c is the mean of a 4 x 4 lattice of bilinear samples of input
    channel (c G + gi) G + gj over the bin, as the JAX package samples it.
    Differentiable in data."""
    B, C, H, W = data.shape
    P = pooled_size
    G = group_size if group_size > 0 else P
    S = 4
    dev = data.device
    f32 = torch.float32
    frac = (torch.arange(S, dtype=f32, device=dev) + 0.5) / S
    b = clamp_index(rois[:, 0].detach().to(torch.int64), B)
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw = rw / P
    bh = rh / P

    iy = torch.arange(P, dtype=f32, device=dev)
    ys = y1[:, None, None] + (iy[:, None] + frac[None, :]) * bh[:, None,
                                                                 None]
    xs = x1[:, None, None] + (iy[:, None] + frac[None, :]) * bw[:, None,
                                                                 None]
    yi = ys.clamp(0, H - 1)                                       # (R, P, S)
    xi = xs.clamp(0, W - 1)
    y0 = torch.floor(yi).to(torch.int64)
    x0 = torch.floor(xi).to(torch.int64)
    y1i = (y0 + 1).clamp(max=H - 1)
    x1i = (x0 + 1).clamp(max=W - 1)
    wy = (yi - y0)[:, None, :, :, None, None]                     # (R,1,P,S,1,1)
    wx = (xi - x0)[:, None, None, None, :, :]                     # (R,1,1,1,P,S)

    g = (torch.arange(P, device=dev) * G // P).clamp(max=G - 1)
    co = torch.arange(output_dim, device=dev)
    cin = (co[:, None, None] * G + g[None, :, None]) * G + g[None, None, :]
    # flat index of (b, channel, y, x) in data: (R, O, P, S, P, S)
    plane = ((b[:, None, None, None] * C + cin[None]) * H)[
        :, :, :, None, :, None]
    flat = data.reshape(-1)

    def corner(yc, xc):
        rows = (plane + yc[:, None, :, :, None, None]) * W
        return flat[rows + xc[:, None, None, None, :, :]]

    v00 = corner(y0, x0)
    v01 = corner(y0, x1i)
    v10 = corner(y1i, x0)
    v11 = corner(y1i, x1i)
    val = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return val.mean(dim=(3, 5))
