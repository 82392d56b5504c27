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

The Faster-RCNN tail of the JAX module (`roi_align`, `bilinear_resize2d`,
`proposal`, `deformable_convolution`, `psroi_pooling`) is not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import kernels

__all__ = ["box_iou", "box_nms", "multibox_prior", "multibox_target",
           "multibox_detection", "nms_sweep", "nms_sweep_ref"]


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
