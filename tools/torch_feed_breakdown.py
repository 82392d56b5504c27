"""Where a fed ResNet-50 training step of the port loses time to its feed.

Runs `chip_smoke.py`'s phase 5 step (ResNet-50 v1 NHWC, batch 32 x 224^2,
bf16 AMP, `FusedTrainStep` SGD) on one card from six sources, each for 4
warm-up and 12 timed steps, in the order given and then reversed, for
`--rounds` rounds in one process (the host sets the step's pace and drifts
within a process, so each source is read many times, interleaved):

  synthetic     float32 batches made once on the card (phase 5's source)
  synthetic_nd  the same batches wrapped as NDArrays
  augment       uint8 batches made once on the card, each step through
                `npx.fused_image_augment` (the augment kernel)
  feed_cast     `io.DeviceFeed` over uint8 batches made once on the host
                (pinned ring, side stream), cast to bf16 by one torch op
  feed_augment  the same feed, each batch through `npx.fused_image_augment`
                (`chip_smoke.py` phase 15's control)
  records       `io.ImageRecordIter` over 1024 seeded JPEGs (phase 15 (c):
                shm decode workers, uint8 handoff, the augment kernel)

Then one step of each source under `torch.cuda.set_sync_debug_mode("warn")`
prints every call that made the host wait for the card, with the frames of
this repo that led to it. The last line is one JSON object with every
reading (per source the median step and its quartiles). Run from the
repo root on a CUDA machine:

    python3 tools/torch_feed_breakdown.py [--rounds 5]
"""
import argparse
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import amp, npx  # noqa: E402
from incubator_mxnet_tpu_torch import io as mxio  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402
from incubator_mxnet_tpu_torch.ndarray import _wrap  # noqa: E402
from incubator_mxnet_tpu_torch.ops import kernels  # noqa: E402

WARMUP, STEPS = 4, 12
RECORD_WORKERS = max(1, (os.cpu_count() or 1) - 2)    # as phase 15 (c)
ORDER = ["synthetic", "synthetic_nd", "augment", "feed_cast", "feed_augment",
         "records"]


def _host_u8():
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (2 * cs.BATCH, cs.IMAGE, cs.IMAGE, 3))
    y = rng.randint(0, cs.CLASSES, 2 * cs.BATCH)
    return [(x[i:i + cs.BATCH].astype(np.uint8),
             y[i:i + cs.BATCH].astype(np.int32))
            for i in range(0, 2 * cs.BATCH, cs.BATCH)]


def _augment(u8, i):
    return npx.fused_image_augment(u8, (3, i), mean=cs.IO_MEAN,
                                   std=cs.IO_STD, rand_mirror=True,
                                   out_dtype="bfloat16")


def _source(kind, dev, path):
    """An endless generator of (x, y) for the step."""
    if kind.startswith("synthetic"):
        batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
                   for b in cs.make_batches(2, cs.BATCH, seed=11)]
        i = 0
        while True:
            x, y = batches[i % 2]
            yield (_wrap(x) if kind == "synthetic_nd" else x), y
            i += 1
    if kind == "records":
        it = cs._io_iter(dev, path=path, handoff="uint8", device_augment=True,
                         dtype="bfloat16", workers=RECORD_WORKERS,
                         **cs.IO_NORM)
        try:
            for b in cs._forever(it):
                yield b.data[0], b.label[0]._t.reshape(-1).to(torch.int32)
        finally:
            it.close()
    host = _host_u8()
    if kind == "augment":
        on_card = [(_wrap(torch.from_numpy(x).to(dev)),
                    torch.from_numpy(y).to(dev)) for x, y in host]
        i = 0
        while True:
            x, y = on_card[i % 2]
            yield _augment(x, i), y
            i += 1

    def forever():
        while True:
            yield from host
    feed = mxio.DeviceFeed(forever(), device=cs.mx.Device("gpu",
                                                          dev.index or 0))
    try:
        for i, (u8, lab) in enumerate(feed):
            x = _augment(u8, i) if kind == "feed_augment" \
                else u8._t.to(torch.bfloat16)
            yield x, lab._t
    finally:
        feed.close()


def _timed(step, src):
    for _ in range(WARMUP):
        step(*next(src))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(*next(src))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def _syncs(step, src):
    """The calls of one step (and of fetching its batch) that made the host
    wait for the card: (message, the repo's frames) each, counted."""
    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                  for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(ROOT)
                  and "torch_feed_breakdown" not in f.filename]
        key = (str(message).split("\n")[0][:120], " < ".join(frames[-4:]))
        found[key] = found.get(key, 0) + 1
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old = warnings.showwarning
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(*next(src))
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    torch.cuda.synchronize()
    return [{"message": m, "frames": f, "count": n}
            for (m, f), n in found.items()]


def _summary(runs):
    out = {}
    for kind in ORDER:
        ms = np.array([r["step_ms"] for r in runs if r["source"] == kind])
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        out[kind] = {"median_ms": float(med), "q1_ms": float(q1),
                     "q3_ms": float(q3), "n": int(ms.size)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5,
                    help="each round runs every source in order, then in "
                         "reverse")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    kernels.build(["scale_shift_act", "avg_pool2d", "image_augment"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "train.rec")
    cs.write_records(path, cs.host_facts())
    amp.init("bfloat16")
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=cs.CLASSES,
                                 device=dev, seed=0)
        step = cs.new_step(net, cs.BATCH, use_fusion=True)
        runs = []
        for kind in (ORDER + ORDER[::-1]) * args.rounds:
            src = _source(kind, dev, path)
            ms = _timed(step, src)
            src.close()
            runs.append({"source": kind, "step_ms": ms})
            print(f"[{kind}] {ms:.3f} ms a step", flush=True)
        syncs = {}
        for kind in ORDER:
            src = _source(kind, dev, path)
            step(*next(src))
            syncs[kind] = _syncs(step, src)
            src.close()
            for s in syncs[kind]:
                print(f"[{kind} sync] {s['count']} x {s['message']} at "
                      f"{s['frames'] or '(no frame of this repo)'}",
                      flush=True)
            if not syncs[kind]:
                print(f"[{kind} sync] none", flush=True)
    finally:
        amp.uninit()
        tmp.cleanup()
    summary = _summary(runs)
    for kind, r in summary.items():
        print(f"[{kind}] median {r['median_ms']:.3f} ms a step (quartiles "
              f"{r['q1_ms']:.3f}-{r['q3_ms']:.3f}, {r['n']} runs)")
    print(json.dumps({"card": card, "summary": summary, "runs": runs,
                      "syncs": syncs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
