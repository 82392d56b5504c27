"""Where the proposal op's sweep spends its time on the card: the mask
pass against the resolve pass of `ops/csrc/nms.cu`'s pixel-inclusive
route (`kernels.proposal_sweep_cuda`).

It builds the NMS library, runs `npx.proposal` at `chip_smoke.py` phase
21's inputs (Faster-RCNN R-50-C4 at test time: 28,728 anchors, 6000 rows
into the sweep, IoU 0.7), takes the sorted boxes the sweep was given,
checks the kernel against `ops.contrib.proposal_sweep_ref` bit for bit,
times a call (CUDA events, `chip_smoke.median_ms`) and splits its device
time into the two kernels with torch.profiler (`tools/torch_nms_ab.py`'s
`kernel_split`: printed only where the parts add up to within 20% of the
call's time, else null). Also at 1000, 2000 and 4000 of those rows, to
show how each pass grows with the rows. One JSON line. Run from the repo
root on a CUDA machine:

    python3 tools/torch_proposal_split.py [--reps 20]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.ops import contrib, kernels  # noqa: E402
from torch_nms_ab import kernel_split  # noqa: E402

ROWS = (1000, 2000, 4000, cs.RCNN_PRE)


def sorted_boxes(dev):
    """The (1, 6000, 4) boxes and keep mask phase 21's proposal hands the
    sweep, and its threshold."""
    cls, bbox, info = cs.rcnn_inputs(dev)
    got = []
    orig = kernels.proposal_sweep_cuda

    def capturing(boxes, keep, thresh):
        got.append((boxes, keep, thresh))
        return orig(boxes, keep, thresh)
    kernels.proposal_sweep_cuda = capturing
    try:
        mx.npx.proposal(*[mx.np.array(t) for t in (cls, bbox, info)],
                        rpn_pre_nms_top_n=cs.RCNN_PRE,
                        rpn_post_nms_top_n=cs.RCNN_POST,
                        threshold=cs.RCNN_NMS, rpn_min_size=cs.RCNN_MIN)
    finally:
        kernels.proposal_sweep_cuda = orig
    return got[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    kernels.build(("nms",))
    boxes, keep, thresh = sorted_boxes(dev)
    result = {"card": card, "rows": {}}
    for n in ROWS:
        b, k = boxes[:, :n].contiguous(), keep[:, :n].contiguous()

        def call(_i=0):
            return kernels.proposal_sweep_cuda(b, k, thresh)
        assert torch.equal(call(), contrib.proposal_sweep_ref(b, k, thresh))
        ms = cs.median_ms(call, args.reps)
        reading = {"ms": ms, "kept": int(call().sum())}
        reading.update(kernel_split(call, ms))
        result["rows"][n] = reading
        print(f"[proposal split] {card} {n} rows: {ms:.4f} ms (mask pass "
              f"{reading['mask_ms']}, resolve {reading['sweep_ms']}); "
              f"{reading['kept']} kept; bit-equal to the plain sweep",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
