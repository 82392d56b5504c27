"""PyTorch port: the NMS kernels' bitmask algorithm (`ops/csrc/nms.cu`),
emulated on the CPU, against the plain sweep and the JAX package's NMS.

The kernels run only on the card. This file emulates their two passes in
PyTorch: `_mask_words` builds, for each image, each row alive at the start
and each 64-row word w, the 64-bit word whose bit t is set where row
64 w + t lies after the row, has its class (when ids are given) and an IoU
above the threshold (box_iou's arithmetic, op by op in float32), laid
out [w][row] as the kernel's workspace (comparisons pick the overlapping
pairs, the IoU runs on those); `_resolve` walks the 64-row blocks in
order, resolves a block's rows from their diagonal words and the bits
removed so far (the kernel's fixed point), then ORs each kept row's
words for later blocks into the removed bits. The emulation must equal `nms_sweep_ref` bit for bit, and
`box_nms` / `multibox_detection` swept by it must equal the JAX package's
on the same numpy inputs (exactly, as tests/test_torch_detection_ops.py
holds them). The wrapper's workspace, its grouping of images past the cap
and its launch count are checked with a stand-in for the built library.
"""
import types

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import contrib as jcontrib

from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import kernels

from test_torch_coverage import _cuda
from test_torch_detection_ops import (ATOL, RTOL, _detection_inputs, _j,
                                      _nms_data, _t)

torch.set_num_threads(1)

WORD = 64
U64 = (1 << 64) - 1


def _mask_words(boxes, ids, keep, thresh):
    """The mask kernel's words: (B, ceil(A / 64), A) int64, word w of row i
    at [w, i]; rows dead at the start hold 0 (the kernel writes nothing
    there, and the sweep never reads them). As the kernel builds them:
    comparisons pick the candidates (two proper boxes whose edges overlap,
    the column alive at the start), the IoU runs on those, and every other
    later column of the row's class hits iff 0 > thresh."""
    B, A = boxes.shape[:2]
    n = -(-A // WORD)
    x1, y1, x2, y2 = (boxes[..., c] for c in range(4))
    proper = (x2 > x1) & (y2 > y1)
    cand = ((x2[:, :, None] > x1[:, None]) & (x2[:, None] > x1[:, :, None])
            & (y2[:, :, None] > y1[:, None]) & (y2[:, None] > y1[:, :, None])
            & proper[:, :, None] & proper[:, None] & keep[:, None])
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None])
          - torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None])
          - torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
    inter = iw * ih
    union = area[:, :, None] + area[:, None] - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    hit = torch.where(cand, iou > thresh, torch.tensor(0.0 > thresh))
    cols = torch.arange(A)
    hit &= (cols[None, :] > cols[:, None])[None]
    if ids is not None:
        hit &= ids[:, :, None] == ids[:, None]
    hit &= keep[:, :, None]
    hit = torch.nn.functional.pad(hit, (0, n * WORD - A))
    bits = torch.bitwise_left_shift(torch.ones((), dtype=torch.int64),
                                    torch.arange(WORD))
    words = (hit.reshape(B, A, n, WORD).long() * bits).sum(-1)
    return words.permute(0, 2, 1).contiguous()


def _resolve(words, keep):
    """The sweep kernel on one image's words (n, A) and alive flags (A,):
    the keep flags after the sweep. A block's kept set is the fixed point
    of K = cand & ~OR_{k in K} diag[k], iterated from K = cand (cand: alive
    and not removed), which a 64-row block reaches within 64 rounds."""
    n, A = words.shape
    w = [[int(x) & U64 for x in row] for row in words.tolist()]
    alive = [bool(x) for x in keep.tolist()]
    removed = [0] * n
    out = [False] * A
    for rb in range(n):
        base = rb * WORD
        rows = range(base, min(A, base + WORD))
        live = sum(1 << (i - base) for i in rows if alive[i])
        cand = live & ~removed[rb]
        kept, rounds = cand, 0
        while True:
            hit = 0
            for k in range(WORD):
                if kept >> k & 1:
                    hit |= w[rb][base + k]
            rounds += 1
            if cand & ~hit == kept:
                break
            kept = cand & ~hit
        assert rounds <= WORD + 1
        ks = [k for k in range(WORD) if kept >> k & 1]
        for k in ks:
            out[base + k] = True
        for wd in range(rb + 1, n):
            for k in ks:
                removed[wd] |= w[wd][base + k]
    return torch.tensor(out, dtype=torch.bool)


def bitmask_sweep(boxes, ids, keep, thresh):
    """`nms_sweep_ref`'s contract, computed as the two kernels do."""
    words = _mask_words(boxes, ids, keep, thresh)
    return torch.stack([_resolve(words[b], keep[b])
                        for b in range(boxes.shape[0])])


def _boxes(rng, B, A, spread=0.6):
    xy = rng.rand(B, A, 2) * spread
    wh = 0.02 + rng.rand(B, A, 2) * 0.3
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


@pytest.mark.parametrize("A", [1, 2, 40, 63, 64, 65, 129, 200])
@pytest.mark.parametrize("with_ids", [False, True])
def test_bitmask_sweep_equals_the_plain_sweep(A, with_ids):
    """Across A not a multiple of 64 (1, 65, 129, 200) and at whole words,
    with and without classes, a fifth of the rows dead at the start (they
    overlap live ones, and must remove nothing)."""
    rng = np.random.RandomState(300 + A)
    B = 3
    boxes = _boxes(rng, B, A)
    ids = torch.from_numpy(rng.randint(0, 3, (B, A)).astype(np.float32)) \
        if with_ids else None
    keep = torch.from_numpy(rng.rand(B, A) > 0.2)
    for thresh in (0.7, 0.45, 0.1):
        want = tcontrib.nms_sweep_ref(boxes, ids, keep, thresh)
        got = bitmask_sweep(boxes, ids, keep, thresh)
        assert torch.equal(got, want), (A, thresh)
    if A >= 40:     # at 0.1 some rows are suppressed
        assert 0 < int(want.sum()) < int(keep.sum())


def test_bitmask_sweep_at_the_edges_of_the_iou():
    """An IoU exactly at the threshold (kept: the test is strict), zero-area
    boxes, duplicates (IoU 1), rows dead at the start that overlap live
    ones, and boxes no comparison picks whose IoU box_iou still computes:
    inverted, NaN and infinite ones."""
    rows = [[0, 0, 3, 1], [1, 0, 4, 1],        # IoU 2 / 4: exactly 0.5
            [0, 0, 3, 1.0001],                 # IoU 0.9999 with row 0
            [5, 5, 5, 5], [5, 5, 5, 5],        # zero-area duplicates
            [5, 5, 5, 6],                      # a line: zero area too
            [8, 8, 9, 9], [8, 8, 9, 9],        # duplicates: IoU 1
            [8.2, 8, 9.2, 9],                  # dead at the start
            [8.4, 8, 9.4, 9],                  # alive, overlaps the dead one
            [9, 9, 8, 8],                      # inverted: IoU 0
            [8, float("nan"), 9, 9],           # NaN: box_iou gives 0
            [float("-inf"), 8, float("inf"), 9]]   # infinite: IoU 0
    boxes = torch.tensor([rows], dtype=torch.float32)
    keep = torch.ones(1, len(rows), dtype=torch.bool)
    keep[0, 8] = False
    # a negative threshold removes disjoint pairs too (their IoU is 0)
    for thresh in (0.5, 0.0, 0.3, -0.1):
        want = tcontrib.nms_sweep_ref(boxes, None, keep, thresh)
        got = bitmask_sweep(boxes, None, keep, thresh)
        assert torch.equal(got, want), thresh
    got = bitmask_sweep(boxes, None, keep, 0.5)
    assert got[0].tolist() == [True, True, False, True, True, True, True,
                               False, False, True, True, True, True]


def test_bitmask_sweep_on_a_chain_of_overlaps():
    """Each box overlaps the next alone (IoU 0.25 at threshold 0.2), so the
    greedy keeps every other row: the longest chain a block's fixed point
    can meet, across three words."""
    A = 150
    x = torch.arange(A, dtype=torch.float32) * 0.6
    boxes = torch.stack([x, torch.zeros(A), x + 1, torch.ones(A)], -1)[None]
    keep = torch.ones(1, A, dtype=torch.bool)
    want = tcontrib.nms_sweep_ref(boxes, None, keep, 0.2)
    assert want[0].tolist() == [i % 2 == 0 for i in range(A)]
    assert torch.equal(bitmask_sweep(boxes, None, keep, 0.2), want)


def test_bitmask_words_skip_dead_rows_and_earlier_columns():
    """A word holds only later columns (row i's own block masks columns
    up to i) alive at the start, and a row dead at the start holds no
    bits."""
    rng = np.random.RandomState(310)
    boxes = _boxes(rng, 1, 150, spread=0.05)    # everything overlaps
    keep = torch.ones(1, 150, dtype=torch.bool)
    keep[0, 70] = False
    words = _mask_words(boxes, None, keep, 0.0)
    assert int(words[0, :, 70].abs().sum()) == 0
    for i in (0, 63, 64, 100, 149):
        for w in range(words.shape[1]):
            bits = int(words[0, w, i]) & U64
            cols = [WORD * w + t for t in range(WORD) if bits >> t & 1]
            assert all(i < j < 150 for j in cols)
            want = [j for j in range(WORD * w, min(150, WORD * w + WORD))
                    if j > i and j != 70]
            assert cols == want     # IoU > 0 for every pair here


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_thresh=0.3, id_index=0),
    dict(overlap_thresh=0.3, id_index=0, force_suppress=True),
    dict(overlap_thresh=0.4, topk=12, id_index=0),
    dict(overlap_thresh=0.5, valid_thresh=0.3),
], ids=["default", "per_class", "force_suppress", "topk", "valid_thresh"])
@pytest.mark.parametrize("n", [40, 65])
def test_box_nms_through_the_bitmask_matches_jax(kw, n, monkeypatch):
    data = _nms_data(seed=7, batch=2, n=n)
    monkeypatch.setattr(tcontrib, "nms_sweep", bitmask_sweep)
    got = _t(tcontrib.box_nms, data, **kw)
    np.testing.assert_array_equal(got, _j(jcontrib.box_nms, data, **kw))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_threshold=0.3, threshold=0.2),
    dict(nms_topk=30, nms_threshold=0.4),
    dict(force_suppress=True, nms_threshold=0.3, clip=False),
], ids=["default", "thresholds", "nms_topk", "force_suppress"])
def test_multibox_detection_through_the_bitmask_matches_jax(kw,
                                                            monkeypatch):
    probs, loc, anchors = _detection_inputs(seed=9)
    want = _j(jcontrib.multibox_detection, probs, loc, anchors, **kw)
    monkeypatch.setattr(tcontrib, "nms_sweep", bitmask_sweep)
    got = _t(tcontrib.multibox_detection, probs, loc, anchors, **kw)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])       # ids
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the wrapper: workspace, groups past the cap, one launch a call
# ---------------------------------------------------------------------------
class _FakeNms:
    """Records each mx_nms_sweep call's arguments in place of the built
    library."""

    def __init__(self):
        self.calls = []

    def mx_nms_sweep(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_nms(monkeypatch):
    lib = _FakeNms()
    empties = []
    empty = torch.empty

    def recording_empty(*a, device=None, **k):
        t = empty(*a, **k)
        empties.append(t)
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(kernels, "_load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kernels.reset_launch_counts()
    lib.empties = empties
    yield lib
    kernels.reset_launch_counts()


def _nms_args(B, A, with_ids=True):
    boxes = _cuda(torch.zeros((B, A, 4)))
    ids = _cuda(torch.zeros((B, A))) if with_ids else None
    keep = _cuda(torch.ones((B, A), dtype=torch.bool))
    return boxes, ids, keep


def test_nms_wrapper_allocates_the_mask_workspace(fake_nms):
    """One group under the cap: an int64 workspace of B * ceil(A / 64) * A
    words, one library call over every image, one launch counted."""
    B, A = 3, 130
    boxes, ids, keep = _nms_args(B, A)
    kernels.nms_sweep_cuda(boxes, ids, keep, 0.45)
    ws, = [t for t in fake_nms.empties if t.dtype == torch.int64]
    assert ws.shape == (B * 3 * A,)
    assert kernels.nms_mask_bytes(B, A) == B * 3 * A * 8
    (call,) = fake_nms.calls
    assert call[4] == ws.data_ptr() and call[5:7] == (B, A)
    assert call[1] == boxes.data_ptr() and call[2] == ids.data_ptr()
    assert kernels.launch_counts()["nms_sweep"] == 1
    assert kernels.launch_counts_by_dtype() == {("nms_sweep", "float32"): 1}


@pytest.mark.parametrize("cap_images,groups", [(2, [2, 2, 1]), (5, [5]),
                                               (0, [1] * 5)])
def test_nms_wrapper_takes_images_in_groups_past_the_cap(
        cap_images, groups, fake_nms, monkeypatch):
    """Past the cap the images go in groups over one workspace of a group's
    size, each group's pointers offset to its first image; a cap under one
    image runs them one at a time. Still one launch counted a call."""
    B, A = 5, 70
    per_image = kernels.nms_mask_bytes(1, A)
    monkeypatch.setattr(kernels, "NMS_MASK_CAP_BYTES",
                        cap_images * per_image + per_image // 2)
    boxes, ids, keep = _nms_args(B, A)
    out = kernels.nms_sweep_cuda(boxes, ids, keep, 0.5)
    ws, = [t for t in fake_nms.empties if t.dtype == torch.int64]
    assert ws.numel() * 8 == groups[0] * per_image
    assert [c[5] for c in fake_nms.calls] == groups
    firsts = np.cumsum([0] + groups[:-1])
    assert [c[1] for c in fake_nms.calls] == [
        boxes.data_ptr() + int(b) * A * 16 for b in firsts]
    assert [c[2] for c in fake_nms.calls] == [
        ids.data_ptr() + int(b) * A * 4 for b in firsts]
    assert [c[3] for c in fake_nms.calls] == [
        out.data_ptr() + int(b) * A for b in firsts]
    assert all(c[4] == ws.data_ptr() for c in fake_nms.calls)
    assert kernels.launch_counts()["nms_sweep"] == 1


def test_nms_wrapper_passes_no_ids_for_one_class(fake_nms):
    boxes, _, keep = _nms_args(2, 10, with_ids=False)
    kernels.nms_sweep_cuda(boxes, None, keep, 0.5)
    (call,) = fake_nms.calls
    assert call[2] is None
