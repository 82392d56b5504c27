"""Where SSD300's `detect()` spends its time on the card.

Builds `ssd_300_vgg16(classes=20, layout="NHWC")` from seed 0 under bf16
AMP with the fusion default on, as `chip_smoke.py`'s phase 13 does, and
calls `net.detect` on one batch of 32 x 300^2 images (its `ssd_batches`,
seed 131). It reads:

- the host ms of a call (CUDA-synchronised, a median of `--calls`);
- one torch.profiler pass over PROFILE_CALLS calls: the device ms a call
  (the sum of its kernels' device time: one stream), the idle share of a
  call's host ms, the kernels by device time, the NMS kernels' device ms
  (every kernel whose symbol holds "nms"), and the host's operators by
  self CPU time, with the device-to-host copies and synchronisations;
- the NMS wrapper's own time on the call's inputs (CUDA events, the
  smoke's `median_ms`), against which the profiler's NMS reading is
  checked: `profiler_agrees` is false where the two part by more than 20%.

`--root` takes another checkout of the repo (e.g. a `git archive` of an
older commit unpacked into a directory `.gitignore` lists), whose package
and `chip_smoke.py` are then the ones imported, so two commits can be
read one process each in one call. It prints one JSON line. Run from the
repo root on a CUDA machine:

    python3 tools/torch_detect_profile.py [--root DIR] [--calls 20]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_CALLS = 3
TOP = 12
# the profiler's NMS time must lie this close to the CUDA-event time
AGREES = 0.2
# host-side operators that wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaMemcpy", "aten::item", "aten::_local_scalar_dense",
         "aten::nonzero")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.profiler import device_window

    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.gluon.model_zoo import detection
    from incubator_mxnet_tpu_torch.ops import fused, kernels

    if not torch.cuda.is_available():
        print("torch_detect_profile: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    amp.init("bfloat16")
    fused.set_fusion_default(True)
    net = detection.ssd_300_vgg16(classes=cs.SSD_CLASSES, layout="NHWC",
                                  device=dev, seed=0)
    x = cs.ssd_batches(1, seed=131, dev=dev)[0][0]
    kw = dict(nms_threshold=cs.SSD_NMS, threshold=cs.SSD_THRESH)

    captured = []
    orig = kernels.nms_sweep_cuda

    def capturing(*a):
        captured.append(a)
        return orig(*a)
    kernels.nms_sweep_cuda = capturing
    try:
        net.detect(x, **kw)
    finally:
        kernels.nms_sweep_cuda = orig
    torch.cuda.synchronize()
    for _ in range(2):
        net.detect(x, **kw)
    host = []
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.detect(x, **kw)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = float(np.median(host))

    torch.cuda.synchronize()
    with device_window(profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])) as prof:
        for _ in range(PROFILE_CALLS):
            net.detect(x, **kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in events if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(r[0] for r in dev_rows) / 1e3 / PROFILE_CALLS
    nms_prof = sum(us for us, key, _ in dev_rows
                   if "nms" in key) / 1e3 / PROFILE_CALLS
    cpu_rows = sorted(((e.self_cpu_time_total, e.key, e.count)
                       for e in events if e.device_type == DeviceType.CPU
                       and e.self_cpu_time_total > 0), reverse=True)
    syncs = {key: {"calls": count / PROFILE_CALLS,
                   "self_cpu_ms": us / 1e3 / PROFILE_CALLS}
             for us, key, count in cpu_rows
             if any(key.startswith(s) for s in SYNCS)}

    nms_ms = cs.median_ms(lambda i: kernels.nms_sweep_cuda(*captured[0]), 5)
    amp.uninit()
    out = {
        "card": cs.card_line(), "root": root, "calls": args.calls,
        "host_ms": host_ms, "host_runs_ms": host,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / host_ms,
        "nms_profiler_ms": nms_prof, "nms_event_ms": nms_ms,
        "profiler_agrees": abs(nms_prof - nms_ms) <= AGREES * nms_ms,
        "kernels": [{"ms": us / 1e3 / PROFILE_CALLS, "name": key[:100],
                     "count": count / PROFILE_CALLS}
                    for us, key, count in dev_rows[:TOP]],
        "host_ops": [{"self_cpu_ms": us / 1e3 / PROFILE_CALLS,
                      "name": key[:100], "count": count / PROFILE_CALLS}
                     for us, key, count in cpu_rows[:TOP]],
        "syncs": syncs}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
