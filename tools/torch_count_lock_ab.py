#!/usr/bin/env python3
"""Host cost of the kernel launch counters, in one source tree of the port.

Prints one JSON line for the tree `--tree` names (default: this checkout):
`chip_smoke.dispatch_cost` (the host µs of an eager NDArray dispatch, the
reading of `chip_smoke.py` phase 14) and the host µs that a call of
`ops.kernels.scale_shift_act_cuda` takes to issue at a launch-bound shape
((64, 64) float32, relu), the median of REPEATS chains of CHAIN calls
each. Every such call counts itself on the launch counters, so a cost of
theirs shows here first. Needs one CUDA card and `nvcc` (it builds
`scale_shift_act.cu` into the tree's `_build/`).

    python3 tools/torch_count_lock_ab.py [--tree DIR]

Compare two trees only within one machine call, in turns: parent,
change, change, parent.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPEATS, CHAIN, WARMUP = 25, 1000, 200


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="root of the checkout to measure")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_count_lock_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.ops import kernels
    assert kernels.__file__.startswith(tree), kernels.__file__
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda", 0)
    kernels.build(("scale_shift_act",))
    x = torch.randn((64, 64), device=dev)
    scale = torch.ones(64, device=dev)
    shift = torch.zeros(64, device=dev)

    def launch():
        return kernels.scale_shift_act_cuda(x, scale, shift, None, "relu")
    for _ in range(WARMUP):
        launch()
    kernels.reset_launch_counts()
    issued = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CHAIN):
            launch()
        issued.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counted = kernels.launch_counts()["scale_shift_act"]
    assert counted == REPEATS * CHAIN, counted
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "tree": tree, "card": card,
        "launch_host_us": float(np.median(issued)) / CHAIN * 1e6,
        "launch_host_us_quartiles": [
            float(q) / CHAIN * 1e6 for q in np.percentile(issued, [25, 75])],
        "launches_counted": counted,
        "dispatch_cost": smoke.dispatch_cost(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
