"""The NMS kernels against the one-block-an-image sweep they replaced.

A one-off comparison, kept because PERF.md's readings of the redesign come
from it: it needs a checkout of commit 76e59ef, the last one whose
`ops/csrc/nms.cu` holds the one-block sweep.

`ops/csrc/nms.cu` builds a suppression bitmask of every pair over the whole
card, then sweeps it a block an image. The sweep it replaced walked each
image's sorted rows in one block, a barrier a kept row. This script builds
that sweep from the checkout's `nms.cu` (`--parent`: `git archive 76e59ef`
unpacked into a directory `.gitignore` lists; its
`mx_nms_sweep(device, boxes, ids, keep, B, A, thresh, stream)` takes no
workspace), checks both against `ops.contrib.nms_sweep_ref` bit for bit,
and times them in one process on one card, in turns (old, new, new, old
each round), at (32, 8732) over four kinds of rows: SSD-like random boxes
with 20 classes and without, dense boxes without classes (most pairs
overlap), and a chain (each box overlaps the next alone). It splits the
new kernels' device ms into the mask pass and the sweep (torch.profiler),
and prints the split only where its parts add up to within 20% of the
CUDA-event time of the pair (else null). It prints a line a kind and one
JSON line. Run from the repo root on a CUDA machine:

    mkdir -p _scratch/parent
    git archive 76e59ef | tar -x -C _scratch/parent
    python3 tools/torch_nms_ab.py --parent _scratch/parent [--rounds 2]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import contrib, kernels  # noqa: E402

B, A, THRESH = 32, 8732, 0.45
SPLIT_REPS = 5
# the split is printed only where its parts add up to the timed pair
SPLIT_AGREES = 0.2


def build_old(parent):
    """The parent's nms.cu as a library, loaded with its own signature."""
    src = os.path.join(parent, "incubator_mxnet_tpu_torch", "ops", "csrc",
                       "nms.cu")
    os.makedirs(kernels._BUILD, exist_ok=True)
    lib_path = os.path.join(kernels._BUILD, "nms-old-sweep.so")
    subprocess.run([kernels._nvcc(), *kernels._flags(), "-o", lib_path, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.mx_nms_sweep.restype = ctypes.c_int
    lib.mx_nms_sweep.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                 + [ctypes.c_int] * 2
                                 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def old_sweep(lib, boxes, ids, keep, thresh):
    out = keep.clone()
    rc = lib.mx_nms_sweep(
        0, boxes.data_ptr(), ids.data_ptr() if ids is not None else None,
        out.data_ptr(), boxes.shape[0], boxes.shape[1], thresh,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def kernel_split(call, pair_ms):
    """Device ms a launch of the mask pass and of the sweep over SPLIT_REPS
    calls of `call()` (one call of a sweep's wrapper; torch.profiler, by
    the launches it recorded); both None unless they add up to within
    SPLIT_AGREES of `pair_ms`, the CUDA-event time of a call. Also the
    parts' sum as read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPLIT_REPS):
            call()
        torch.cuda.synchronize()
    out = {}
    for part, sym in (("mask_ms", "nms_mask_kernel"),
                      ("sweep_ms", "nms_resolve_kernel")):
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and sym in e.key]
        us = sum(e.self_device_time_total for e in evs)
        n = sum(e.count for e in evs)
        out[part] = us / 1e3 / n if us > 0 and n else None
    seen = (None if None in out.values()
            else out["mask_ms"] + out["sweep_ms"])
    out["split_sum_ms"] = seen
    if seen is None or abs(seen - pair_ms) > SPLIT_AGREES * pair_ms:
        out.update(mask_ms=None, sweep_ms=None)
    return out


def rows(kind, gen, dev):
    """(boxes, ids, keep, thresh) of one kind of rows."""
    spread, size = (0.3, 0.3) if kind == "dense" else (0.8, 0.2)
    xy = torch.rand((B, A, 2), generator=gen, device=dev) * spread
    wh = 0.02 + torch.rand((B, A, 2), generator=gen, device=dev) * size
    boxes = torch.cat([xy, xy + wh], -1).contiguous()
    ids = torch.randint(0, 20, (B, A), generator=gen, device=dev).float()
    keep = torch.rand((B, A), generator=gen, device=dev) > 0.07
    if kind == "chain":
        x = torch.arange(A, device=dev, dtype=torch.float32) * 0.6
        one = torch.stack([x, torch.zeros_like(x), x + 1,
                           torch.ones_like(x)], -1)
        return (one.expand(B, A, 4).contiguous(), None,
                torch.ones_like(keep), 0.2)
    return boxes, ids if kind == "classes" else None, keep, THRESH


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout holding the one-block sweep's nms.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    kernels.build(("nms",))
    old = build_old(args.parent)
    gen = torch.Generator(device=dev).manual_seed(18)
    result = {"card": card, "shape": [B, A], "kinds": {}}
    for kind in ("classes", "no classes", "dense", "chain"):
        boxes, ids, keep, thresh = rows(kind, gen, dev)
        want = contrib.nms_sweep_ref(boxes, ids, keep, thresh)

        def new_fn(_i):
            return kernels.nms_sweep_cuda(boxes, ids, keep, thresh)

        def old_fn(_i):
            return old_sweep(old, boxes, ids, keep, thresh)
        assert torch.equal(new_fn(0), want), kind
        assert torch.equal(old_fn(0), want), kind
        times = {"old": [], "new": []}
        for _ in range(args.rounds):
            for name in ("old", "new", "new", "old"):
                fn = old_fn if name == "old" else new_fn
                times[name].append(cs.median_ms(fn, 5))
        reading = {n: float(np.median(t)) for n, t in times.items()}
        reading.update(kernel_split(lambda: new_fn(0), reading["new"]))
        reading.update(alive=int(keep.sum()), kept=int(want.sum()),
                       runs=times)
        result["kinds"][kind] = reading
        print(f"[nms ab] {card} {kind}: old {reading['old']:.4f} ms, new "
              f"{reading['new']:.4f} ms (mask pass {reading['mask_ms']}, "
              f"sweep {reading['sweep_ms']}); {reading['kept']} of "
              f"{reading['alive']} rows kept; both bit-equal to the plain "
              f"sweep", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
