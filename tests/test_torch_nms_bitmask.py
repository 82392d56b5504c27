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
its pixel-inclusive instance (the proposal op's IoU: `+ 1` on every width
and height, no guard on the division, a pair a candidate where both its
overlap's `+ 1` extents are positive, every later column under a negative
threshold) must equal `proposal_sweep_ref`; and
`box_nms` / `multibox_detection` swept by it must equal the JAX package's
on the same numpy inputs (exactly, as tests/test_torch_detection_ops.py
holds them). The wrapper's workspace, its grouping of images past the cap
and its launch count are checked with a stand-in for the built library.
"""
import os
import types

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import contrib as jcontrib

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
from incubator_mxnet_tpu_torch.ops import kernels

from test_torch_coverage import _cuda
from test_torch_detection_ops import (ATOL, RTOL, _detection_inputs, _j,
                                      _nms_data, _t)

torch.set_num_threads(1)

WORD = 64
U64 = (1 << 64) - 1


def _pair_hits(rows, cols, row_ids, col_ids, col_keep, thresh, plus_one):
    """(B, r, c) bool: where a column would set its bit in a row's word, as
    the kernel decides it, before the order of the two and the row's
    liveness: comparisons pick the candidates (two proper boxes whose edges
    overlap, the column alive at the start), the IoU runs on those, and
    every other column hits iff 0 > thresh; then the class (when ids are
    given). With `plus_one` (no ids): a candidate is a pair whose overlap's
    (x2 - x1) + 1 and (y2 - y1) + 1 are both positive, the column alive at
    the start, or every column under a negative threshold; only candidates
    hit. `rows` (B, r, 4) and `cols` (B, c, 4) boxes."""
    x1, y1, x2, y2 = (rows[..., k, None] for k in range(4))
    u1, v1, u2, v2 = (cols[:, None, :, k] for k in range(4))
    ew = torch.minimum(x2, u2) - torch.maximum(x1, u1)
    eh = torch.minimum(y2, v2) - torch.maximum(y1, v1)
    if plus_one:
        ew, eh = ew + 1.0, eh + 1.0
        cand = (ew > 0) & (eh > 0) & col_keep[:, None]
        if 0.0 > thresh:
            cand = torch.ones_like(cand)
        area_r = ((x2 - x1) + 1.0) * ((y2 - y1) + 1.0)
        area_c = ((u2 - u1) + 1.0) * ((v2 - v1) + 1.0)
        inter = ew.clamp(min=0) * eh.clamp(min=0)
        iou = inter / ((area_r + area_c) - inter)
        hit = cand & (iou > thresh)
    else:
        cand = ((x2 > u1) & (u2 > x1) & (y2 > v1) & (v2 > y1)
                & (x2 > x1) & (y2 > y1) & (u2 > u1) & (v2 > v1)
                & col_keep[:, None])
        area_r = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        area_c = (u2 - u1).clamp(min=0) * (v2 - v1).clamp(min=0)
        inter = ew.clamp(min=0) * eh.clamp(min=0)
        union = area_r + area_c - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        hit = torch.where(cand, iou > thresh, torch.tensor(0.0 > thresh))
    if row_ids is not None:
        hit &= row_ids[:, :, None] == col_ids[:, None]
    return hit


def _pack(hit):
    """(..., 64 k) bools -> (..., k) int64 words, bit t of word w the
    column 64 w + t."""
    bits = torch.bitwise_left_shift(torch.ones((), dtype=torch.int64),
                                    torch.arange(WORD))
    return (hit.reshape(*hit.shape[:-1], -1, WORD).long() * bits).sum(-1)


def _mask_words(boxes, ids, keep, thresh, plus_one=False):
    """The mask kernel's words: (B, ceil(A / 64), A) int64, word w of row i
    at [w, i]; rows dead at the start hold 0 (the kernel writes nothing
    there, and the sweep never reads them). Bit t of word w of row i is
    `_pair_hits` of row i and column j = 64 w + t, for j after i."""
    B, A = boxes.shape[:2]
    n = -(-A // WORD)
    hit = _pair_hits(boxes, boxes, ids, ids, keep, thresh, plus_one)
    cols = torch.arange(A)
    hit &= (cols[None, :] > cols[:, None])[None]
    hit &= keep[:, :, None]
    hit = torch.nn.functional.pad(hit, (0, n * WORD - A))
    return _pack(hit).permute(0, 2, 1).contiguous()


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


def bitmask_sweep(boxes, ids, keep, thresh, plus_one=False):
    """`nms_sweep_ref`'s contract (`proposal_sweep_ref`'s with
    `plus_one`), computed as the two kernels do."""
    words = _mask_words(boxes, ids, keep, thresh, plus_one)
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

    def mx_proposal_sweep(self, *args):
        self.calls.append(("proposal",) + args)
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


# ---------------------------------------------------------------------------
# the pixel-inclusive instance: proposal's sweep
# ---------------------------------------------------------------------------
def _pixel_boxes(rng, B, A, grid=40, size=10):
    """Integer pixel boxes on a small grid: many pairs overlap, touch at a
    pixel or share a pixel line; some are a pixel wide or one pixel."""
    xy = rng.randint(0, grid, (B, A, 2)).astype(np.float32)
    wh = rng.randint(0, size, (B, A, 2)).astype(np.float32)
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1))


@pytest.mark.parametrize("A", [1, 2, 63, 64, 65, 129, 200])
def test_plus_one_bitmask_sweep_equals_the_proposal_sweep(A):
    rng = np.random.RandomState(400 + A)
    B = 2
    boxes = _pixel_boxes(rng, B, A)
    keep = torch.from_numpy(rng.rand(B, A) > 0.15)
    for thresh in (0.7, 0.3, 0.0, -0.1):
        want = tcontrib.proposal_sweep_ref(boxes, keep, thresh)
        got = bitmask_sweep(boxes, None, keep, thresh, plus_one=True)
        assert torch.equal(got, want), (A, thresh)
    if A >= 63:     # at 0.3 and 0.0 the pixel IoU suppresses rows
        for thresh in (0.3, 0.0):
            want = tcontrib.proposal_sweep_ref(boxes, keep, thresh)
            assert int(want.sum()) < int(keep.sum())


def test_plus_one_bitmask_sweep_at_the_edges_of_its_iou():
    """Pairs the continuous prefilter would drop and the pixel IoU does
    not: a shared pixel line, one pixel twice, a touching corner; boxes
    inverted by under a pixel (rpn_min_size 0 keeps them: their + 1
    extent is positive); a NaN box (IoU NaN: never a hit); an infinite
    one; a union of 0 (0 / 0) under a negative threshold; an IoU exactly
    at the threshold (kept)."""
    nan, inf = float("nan"), float("inf")
    rows = [[100, 100, 100, 140], [100, 100, 100, 141],   # 41 / 42
            [7, 7, 7, 7], [7, 7, 7, 7],                   # IoU 1
            [60, 60, 64, 64], [64, 64, 68, 68],           # 1 / 49
            [30.5, 30.25, 30.0, 30.0], [30.4, 30.2, 30.1, 30.05],
            [5, nan, 9, 9], [5, 5, 9, 9],
            [-inf, 0, inf, 3],
            [50, 50, 49, 49], [50, 50, 49, 49],           # areas 0: 0 / 0
            [0, 0, 1, 0], [1, 0, 2, 0]]                   # 1 / 3
    boxes = torch.tensor([rows], dtype=torch.float32)
    keep = torch.ones(1, len(rows), dtype=torch.bool)
    for thresh in (0.7, 1 / 3, 0.02, 0.0, -0.1, -1.0):
        want = tcontrib.proposal_sweep_ref(boxes, keep, thresh)
        got = bitmask_sweep(boxes, None, keep, thresh, plus_one=True)
        assert torch.equal(got, want), thresh
    got = bitmask_sweep(boxes, None, keep, 0.7, plus_one=True)
    assert not got[0, 1] and not got[0, 3]     # the pixel IoU suppresses
    assert bool(tcontrib.nms_sweep_ref(boxes, None, keep, 0.7)[0, 1])
    got = bitmask_sweep(boxes, None, keep, 1 / 3, plus_one=True)
    assert bool(got[0, 14])                    # IoU exactly 1 / 3: kept


def test_plus_one_words_hold_only_candidates_at_a_threshold_of_0():
    """At threshold 0 a word holds the later live columns whose + 1 overlap
    is positive in both extents: sharing a pixel counts, the next pixel
    over does not."""
    boxes = torch.tensor([[[0, 0, 4, 4], [4, 4, 8, 8], [5, 0, 9, 4],
                           [9, 9, 9, 9]]], dtype=torch.float32)
    keep = torch.ones(1, 4, dtype=torch.bool)
    words = _mask_words(boxes, None, keep, 0.0, plus_one=True)
    bits = [int(words[0, 0, i]) & U64 for i in range(4)]
    assert bits == [0b0010, 0b0100, 0b0000, 0b0000]


def test_proposal_wrapper_launches_its_own_entry(fake_nms):
    """`proposal_sweep_cuda` calls the library's `mx_proposal_sweep` (no
    ids), over the nms workspace, and counts in its own counter."""
    B, A = 2, 70
    boxes, _, keep = _nms_args(B, A, with_ids=False)
    kernels.proposal_sweep_cuda(boxes, keep, 0.7)
    ws, = [t for t in fake_nms.empties if t.dtype == torch.int64]
    (call,) = fake_nms.calls
    assert call[0] == "proposal"
    assert call[2] == boxes.data_ptr() and call[4] == ws.data_ptr()
    assert call[5:7] == (B, A)
    assert abs(call[7] - 0.7) < 1e-7
    assert kernels.launch_counts()["proposal_sweep"] == 1
    assert kernels.launch_counts()["nms_sweep"] == 0
    assert kernels.launch_counts_by_dtype() == {
        ("proposal_sweep", "float32"): 1}
    with pytest.raises(MXNetError, match="float32"):
        kernels.proposal_sweep_cuda(boxes.double(), keep, 0.7)


# ---------------------------------------------------------------------------
# the mask kernel's grid: a block a tile of 64 rows and 8 of their words
# ---------------------------------------------------------------------------
# the words a tile (csrc/nms.cu: kMaskWords, a warp a word of 256 threads)
TILE = 8
# what an int64 torch.empty workspace may hold where nothing wrote
GARBAGE = 0x5A5A5A5A5A5A5A5A
# the lines of csrc/nms.cu that `_mask_grid` and `_grid_blocks` mirror
NMS_CU = os.path.join(os.path.dirname(kernels.__file__), "csrc", "nms.cu")
MIRRORED = ("constexpr int kMaskThreads = 256;",
            "constexpr int kMaskWords = kMaskThreads / 32;",
            "return dim3(B, n_words, (n_words + kMaskWords - 1) / kMaskWords);",
            "const int w0 = rb + blockIdx.z * kMaskWords;",
            "if (w0 >= n_words) return;",
            "<<<mask_grid(B, n_words),")


def _mask_grid(B, A):
    """`mask_grid` of csrc/nms.cu: (images, row blocks, runs of TILE
    words)."""
    n = -(-A // WORD)
    return B, n, -(-n // TILE)


def _grid_blocks(B, A):
    """The mask kernel's blocks in launch order (x fastest): (image, row
    block, first word), each block of `_mask_grid` whose run starts at or
    before the last word; the others return at once."""
    gx, gy, gz = _mask_grid(B, A)
    for k in range(gz):
        for rb in range(gy):
            for img in range(gx):
                if rb + TILE * k < gy:
                    yield img, rb, rb + TILE * k


def _tiled_mask_words(boxes, ids, keep, thresh, plus_one=False):
    """The mask kernel's workspace as its grid writes it, block by block
    in launch order: each block takes its tile from its index, loads its
    own rows and columns, exits if none of its rows is alive, and writes
    each live row's words of its run (on the diagonal word the columns
    after the row; every word cut at the image's last row). Returns
    (words, writes): the (B, n, A) workspace, GARBAGE where nothing wrote,
    and how many times each word was written."""
    B, A = boxes.shape[:2]
    n = -(-A // WORD)
    words = torch.full((B, n, A), GARBAGE, dtype=torch.int64)
    writes = torch.zeros((B, n, A), dtype=torch.int64)
    for img, rb, w0 in _grid_blocks(B, A):
        r = slice(WORD * rb, min(A, WORD * rb + WORD))
        live = keep[img, r]
        if not live.any():
            continue
        at = torch.arange(live.numel())
        one = lambda t, s: None if t is None else t[img:img + 1, s]  # noqa
        for w in range(w0, min(n, w0 + TILE)):
            c = slice(WORD * w, min(A, WORD * w + WORD))
            hit = _pair_hits(one(boxes, r), one(boxes, c), one(ids, r),
                             one(ids, c), one(keep, c), thresh, plus_one)[0]
            t0 = at + 1 if w == rb else torch.zeros_like(at)
            hit &= torch.arange(hit.shape[1])[None] >= t0[:, None]
            hit = torch.nn.functional.pad(hit, (0, WORD - hit.shape[1]))
            word = _pack(hit)[:, 0]
            rows = at[live] + WORD * rb
            words[img, w, rows] = word[live]
            writes[img, w, rows] += 1
    return words, writes


def test_mask_tiles_cover_the_upper_triangle_once():
    """The grid mirrored here is the one csrc/nms.cu launches (its lines
    are in the source as mirrored). For every image of up to 300 words:
    the grid's blocks that do not return at once take each (row block,
    run of 8 words from its own on) exactly once; phase 21's (1, 6000)
    gives 600 tiles, detect()'s (32, 8732) 39,744."""
    with open(NMS_CU) as f:
        source = " ".join(f.read().split())
    for line in MIRRORED:
        assert line in source, line
    for n in range(1, 301):
        got = [(rb, w0) for _, rb, w0 in _grid_blocks(1, WORD * n)]
        want = [(rb, w0) for rb in range(n) for w0 in range(rb, n, TILE)]
        assert sorted(got) == want and len(set(got)) == len(got), n
        assert len(list(_grid_blocks(3, WORD * n - 1))) == 3 * len(want)
        assert _mask_grid(3, WORD * n - 1) == (3, n, -(-n // TILE))
    assert len(list(_grid_blocks(1, 6000))) == 600
    assert len(list(_grid_blocks(32, 8732))) == 39744
    assert _mask_grid(32, 8732) == (32, 137, 18)


def _proposal_like(rng, B, A):
    """Float boxes as the proposal op hands its sweep: corners anywhere in
    a 300-pixel square, sides up to 150 pixels, so most pairs overlap."""
    xy = rng.rand(B, A, 2) * 300
    wh = rng.rand(B, A, 2) * 150
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


@pytest.mark.parametrize("kind", ["proposal", "nms", "nms_ids"])
@pytest.mark.parametrize("A", [1, 63, 64, 65, 511, 512, 513, 1100])
def test_tiled_mask_writes_each_word_once_and_sweeps_as_the_plain(A, kind):
    """The words built tile by tile in the kernel's order: every word of
    every alive row from its own row block on written exactly once, no
    other written; they equal `_mask_words` there, and resolved they give
    `proposal_sweep_ref` (pixel-inclusive) or `nms_sweep_ref` (with and
    without ids) bit for bit, the unwritten words left at garbage. Dense
    boxes at 0.7, and every later column at -0.1, put bits in nearly every
    word; one row block of the second image is wholly dead."""
    rng = np.random.RandomState(500 + A)
    B = 2
    plus_one = kind == "proposal"
    boxes = _proposal_like(rng, B, A) if plus_one else _boxes(rng, B, A,
                                                                spread=0.3)
    ids = torch.from_numpy(rng.randint(0, 3, (B, A)).astype(np.float32)) \
        if kind == "nms_ids" else None
    keep = torch.from_numpy(rng.rand(B, A) > 0.15)
    keep[1, WORD:2 * WORD] = False
    n = -(-A // WORD)
    due = ((torch.arange(n)[:, None] >= torch.arange(A)[None] // WORD)[None]
           & keep[:, None, :])
    for thresh in (0.7, -0.1):
        words, writes = _tiled_mask_words(boxes, ids, keep, thresh, plus_one)
        assert torch.equal(writes, due.long()), (A, thresh)
        want = _mask_words(boxes, ids, keep, thresh, plus_one)
        assert torch.equal(words[due], want[due]), (A, thresh)
        got = torch.stack([_resolve(words[b], keep[b]) for b in range(B)])
        plain = (tcontrib.proposal_sweep_ref(boxes, keep, thresh)
                 if plus_one else
                 tcontrib.nms_sweep_ref(boxes, ids, keep, thresh))
        assert torch.equal(got, plain), (A, thresh)
        if A >= 511:
            assert int(plain.sum()) < int(keep.sum())
        if A >= 511 and thresh < 0:
            # every whole word off the diagonal holds bits
            full = due & (torch.arange(n)[:, None] > torch.arange(A)[None]
                          // WORD)[None]
            full[:, A // WORD:] = False
            assert bool((want[full] != 0).all())
