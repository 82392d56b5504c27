"""Kernel records of a profiled window against the launches made in it.

`chip_smoke.py` phase 18 profiles two fused ResNet-50 training steps with
`mx.profiler` and asserts that the trace holds one kernel record per
counted launch of B1-B3 (scale_shift_act, the pool kernels). Kineto keeps
a kernel record only when the kernel's start, put on the host clock, falls
inside the profiled window. This script reads, over `--windows` windows of
each kind:

  port   phase 18's window (`mx.profiler`, whose device window waits
         `profiler.DEVICE_EDGE_S` at each end): records against counters;
  raw    the same steps under `torch.profiler` started and stopped with no
         wait (a synchronize at each end only);
  probe  64 small kernels launched at once after the start, once with no
         wait and once through `profiler.open_device_window` /
         `close_device_window`.

In the raw and probe windows the CUDA runtime and driver records are kept
and each launch is matched by its correlation id to its kernel record. A
launch whose record is missing is located: its place among the window's
launches, its host time from the window's first launch, and the time from
the end of the previous kernel on the card to the launch (negative when the
card was still busy). For every matched launch it reads the gap from the
launch call's start to its kernel's start on the trace's clock: the card
cannot start a kernel before its launch, so a negative least gap is how far
the kernel clock reads early.

It prints a line per window that lost a record and one JSON line. Run from
the repo root on a CUDA machine:

    python3 tools/torch_profiler_window.py --windows 40
"""
import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import amp, profiler  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402
from incubator_mxnet_tpu_torch.ops import kernels  # noqa: E402


def _records(events):
    return {n: sum(1 for e in events if e.get("cat") == "kernel"
                   and sym in e["name"])
            for n, sym in cs.TEL_SYMBOLS.items()}


def port_window(step, batches, tmp):
    """phase 18's window: mx.profiler over TEL_PROFILE_STEPS steps."""
    kernels.reset_launch_counts()
    profiler.start()
    for i in range(cs.TEL_PROFILE_STEPS):
        step(*batches[i % 2])
    profiler.stop()
    moved = kernels.launch_counts()
    path = profiler.dump(filename=os.path.join(tmp, "trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    profiler._events.clear()
    return _records(events), {n: moved[n] for n in cs.TEL_SYMBOLS}


def _match(events):
    """Launch records matched to kernel records by correlation id: the
    launches with no kernel record (located) and the least launch-to-kernel
    gap."""
    launch = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e.get("name", "") and corr is not None):
            if corr not in launch or e["ts"] < launch[corr]["ts"]:
                launch[corr] = e
    kern = {e["args"]["correlation"]: e for e in events
            if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    order = sorted(launch.values(), key=lambda e: e["ts"])
    ends = sorted(k["ts"] + k.get("dur", 0.0) for k in kern.values())
    first = order[0]["ts"] if order else 0.0
    missing, gaps = [], []
    for i, e in enumerate(order):
        k = kern.get(e["args"]["correlation"])
        if k is not None:
            gaps.append(k["ts"] - e["ts"])
            continue
        before = [t for t in ends if t <= e["ts"]]
        missing.append({"index": i, "of": len(order), "api": e["name"],
                        "from_first_us": e["ts"] - first,
                        "card_idle_us": (e["ts"] - before[-1]) if before
                        else None})
    return {"api_launches": len(order), "kernel_records": len(kern),
            "missing": missing,
            "least_gap_us": min(gaps) if gaps else None,
            "gaps_under_5us": sum(1 for g in gaps if g < 5.0)}


def _trace(prof, tmp):
    path = os.path.join(tmp, "raw.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def raw_window(step, batches, tmp):
    """The same steps under torch.profiler with no edge, launches matched
    to kernels."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for i in range(cs.TEL_PROFILE_STEPS):
        step(*batches[i % 2])
    torch.cuda.synchronize()
    prof.stop()
    moved = kernels.launch_counts()
    events = _trace(prof, tmp)
    return dict(_match(events), records=_records(events),
                launches={n: moved[n] for n in cs.TEL_SYMBOLS})


PROBE_LAUNCHES = 64


def probe_window(x, edge, tmp):
    """PROBE_LAUNCHES small kernels launched at once after the start, with
    or without the device window's edges."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    if edge:
        profiler.open_device_window(prof)
    else:
        torch.cuda.synchronize()
        prof.start()
    for _ in range(PROBE_LAUNCHES):
        x.add_(1.0)
    if edge:
        profiler.close_device_window(prof)
    else:
        torch.cuda.synchronize()
        prof.stop()
    return _match(_trace(prof, tmp))


def _summary(rs):
    least = [r["least_gap_us"] for r in rs if r["least_gap_us"] is not None]
    return {"windows_lost": sum(1 for r in rs if r["missing"]),
            "records_lost": sum(len(r["missing"]) for r in rs),
            "least_gap_us": [min(least), sorted(least)[len(least) // 2],
                             max(least)] if least else None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_window: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kernels.build(("scale_shift_act", "avg_pool2d"))
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in cs.make_batches(2, cs.BATCH, seed=11)]
    amp.init("bfloat16")
    profiler.set_config(profile_device=True)
    out = {"card": cs.card_line(), "torch": torch.__version__,
           "windows": args.windows}
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=cs.CLASSES,
                                 device=dev, seed=0)
        step = cs.new_step(net, cs.BATCH, use_fusion=True)
        for i in range(cs.TRAIN_WARMUP):
            step(*batches[i % 2])
        torch.cuda.synchronize()
        port_lost, raw, probes = [], [], {False: [], True: []}
        x = torch.zeros(1024, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            for w in range(args.windows):
                rec, moved = port_window(step, batches, tmp)
                if rec != moved:
                    port_lost.append({"window": w, "records": rec,
                                      "launches": moved})
                    print(f"port window {w}: records {rec}, launches "
                          f"{moved}", flush=True)
            for w in range(args.windows):
                r = raw_window(step, batches, tmp)
                raw.append(r)
                if r["missing"] or r["records"] != r["launches"]:
                    print(f"raw window {w}: {json.dumps(r)}", flush=True)
            for w in range(args.windows):
                for edge in (False, True):
                    r = probe_window(x, edge, tmp)
                    probes[edge].append(r)
                    if r["missing"]:
                        print(f"probe window {w} edge {edge}: "
                              f"{json.dumps(r)}", flush=True)
    finally:
        amp.uninit()
    out.update({"edge_s": profiler.DEVICE_EDGE_S,
                "port_windows_lost": len(port_lost), "port_lost": port_lost,
                "raw": dict(_summary(raw), ssa_windows_short=sum(
                    1 for r in raw if r["records"] != r["launches"])),
                "probe_no_edge": _summary(probes[False]),
                "probe_edge": _summary(probes[True])})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
