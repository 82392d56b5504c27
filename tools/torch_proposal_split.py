"""Where the proposal op's sweep spends its time on the card: the mask
pass against the resolve pass of `ops/csrc/nms.cu`'s pixel-inclusive
route (`kernels.proposal_sweep_cuda`).

It builds the NMS library, runs `npx.proposal` at `chip_smoke.py` phase
21's inputs (Faster-RCNN R-50-C4 at test time: 28,728 anchors, 6000 rows
into the sweep, IoU 0.7), takes the sorted boxes the sweep was given,
checks the kernel against `ops.contrib.proposal_sweep_ref` bit for bit,
times a call (CUDA events, `chip_smoke.median_ms`) and splits its device
time into the two kernels with torch.profiler (`chip_smoke.kernel_split`:
printed only where the parts add up to within 20% of the call's time,
else null). Also at 1000, 2000 and 4000 of those rows, to show how each
pass grows with the rows. With `--against NAME=PATH` (repeatable, as in
`tools/torch_nms_ab.py`: another `nms.cu` with the current entry points,
such as the parent commit's) each version is checked and timed in turns
with the built one (in order, then in reverse, each round), and so is the
whole `npx.proposal` call (the median of 20 synchronised calls a turn,
host clock). One JSON line. Run from the repo root on a CUDA machine:

    python3 tools/torch_proposal_split.py [--reps 20] [--against NAME=PATH]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.ops import contrib, kernels  # noqa: E402
from torch_nms_ab import in_turns, library, versions  # noqa: E402

ROWS = (1000, 2000, 4000, cs.RCNN_PRE)
CALLS = 20


def proposal_args(dev):
    args = [mx.np.array(t) for t in cs.rcnn_inputs(dev)]
    kw = dict(rpn_pre_nms_top_n=cs.RCNN_PRE, rpn_post_nms_top_n=cs.RCNN_POST,
              threshold=cs.RCNN_NMS, rpn_min_size=cs.RCNN_MIN)
    return args, kw


def sorted_boxes(dev):
    """The (1, 6000, 4) boxes and keep mask phase 21's proposal hands the
    sweep, and its threshold."""
    got = []
    orig = kernels.proposal_sweep_cuda

    def capturing(boxes, keep, thresh):
        got.append((boxes, keep, thresh))
        return orig(boxes, keep, thresh)
    kernels.proposal_sweep_cuda = capturing
    try:
        args, kw = proposal_args(dev)
        mx.npx.proposal(*args, **kw)
    finally:
        kernels.proposal_sweep_cuda = orig
    return got[0]


def proposal_ms(lib, dev, calls=CALLS):
    """The median host ms of a synchronised `npx.proposal` call launching
    `lib`'s sweep, and its rois."""
    args, kw = proposal_args(dev)
    runs = []
    with library(lib):
        rois = mx.npx.proposal(*args, **kw)._t
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mx.npx.proposal(*args, **kw)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs)), rois


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another nms.cu with the proposal sweep")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    kernels.build(("nms",))
    libs = {}
    for name, (lib, bitmask) in versions(args.against).items():
        if not bitmask or (lib is not None
                           and not hasattr(lib, "mx_proposal_sweep")):
            raise SystemExit(f"{name}: its nms.cu has no proposal sweep")
        libs[name] = lib
    boxes, keep, thresh = sorted_boxes(dev)
    result = {"card": card, "rows": {}}
    for n in ROWS:
        b, k = boxes[:, :n].contiguous(), keep[:, :n].contiguous()
        want = contrib.proposal_sweep_ref(b, k, thresh)

        def sweep(lib):
            def call(_i=0):
                with library(lib):
                    return kernels.proposal_sweep_cuda(b, k, thresh)
            return call
        fns = {name: sweep(lib) for name, lib in libs.items()}
        for name, fn in fns.items():
            assert torch.equal(fn(), want), (n, name)
        times = in_turns(fns, args.rounds, args.reps)
        reading = {"kept": int(want.sum()), "runs": times}
        for name in fns:
            ms = float(np.median(times[name]))
            reading[name] = dict(ms=ms, **cs.kernel_split(fns[name], ms))
        reading.update(reading["new"])
        result["rows"][n] = reading
        print(f"[proposal split] {card} {n} rows: "
              + "; ".join(f"{name} {r['ms']:.4f} ms (mask pass "
                          f"{r['mask_ms']}, resolve {r['sweep_ms']})"
                          for name, r in ((x, reading[x]) for x in fns))
              + f"; {reading['kept']} kept; bit-equal to the plain sweep",
              flush=True)
    if len(libs) > 1:
        runs = {name: [] for name in libs}
        rois = {}
        for _ in range(args.rounds):
            for name in list(libs) + list(libs)[::-1]:
                ms, rois[name] = proposal_ms(libs[name], dev)
                runs[name].append(ms)
        assert all(torch.equal(r, rois["new"]) for r in rois.values())
        result["proposal_ms"] = {n: float(np.median(r))
                                 for n, r in runs.items()}
        result["proposal_runs"] = runs
        print(f"[proposal split] {card} npx.proposal end to end, median of "
              f"{CALLS} synchronised calls a turn, in turns: "
              + ", ".join(f"{n} {ms:.3f} ms"
                          for n, ms in result["proposal_ms"].items())
              + "; the same rois each way", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
