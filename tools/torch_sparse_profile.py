#!/usr/bin/env python3
"""Where a step of the sparse linear example goes on the card.

Phase 23's setup of `chip_smoke.py` (`SPARSE`: 1,000,001 features, batches
of 8192 seeded synthetic rows with 15 nonzeros each), WARMUP steps of
`examples/torch_sparse_linear.py`'s `step`, then a `torch.profiler` pass
over STEPS steps, each as phase 23 runs it (the iterator's batch, the
CSR's copy to the card, the step, the loss read). Prints the ops by host
time (self), the kernels by device time, the device-busy share of the
profiled wall time, and one JSON line; writes the JSON to `--out` too.

    python3 tools/torch_sparse_profile.py [--steps 8] [--out FILE]
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP = 4


def _device_us(evt, self_only):
    """An event's device µs under the attribute this torch version has."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(evt, n):
            return float(getattr(evt, n))
    return 0.0


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sparse_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mx, cfg = smoke.mx, smoke.SPARSE
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.libsvm")
        smoke.sparse_libsvm(path)
        with mx.gpu(0):
            it = mx.io.LibSVMIter(path, (cfg["features"],),
                                  batch_size=cfg["batch"])
            w = mx.np.zeros((cfg["features"], 1))
            b = mx.np.zeros((1,))
    w.attach_grad()
    b.attach_grad()

    def one_step():
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            batch = it.next()
        x, y = batch.data[0], batch.label[0]
        x._device_parts(dev)
        loss = smoke.sparse_linear.step(x, y, w, b, cfg["lr"], cfg["lr_b"])
        return float(loss.asnumpy())

    for _ in range(WARMUP):
        one_step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = prof.key_averages()
    host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:15]
    kern = sorted((e for e in ops if _device_us(e, True) > 0),
                  key=lambda e: -_device_us(e, True))[:12]
    device_us = sum(_device_us(e, True) for e in ops)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[sparse profile] {card}: {args.steps} steps, "
          f"{wall_us / args.steps / 1e3:.3f} ms a step under the profiler, "
          f"device busy {device_us / args.steps / 1e3:.3f} ms a step "
          f"({device_us / wall_us:.1%}, idle {1 - device_us / wall_us:.1%})")
    print("[sparse profile] host (self) µs a step by op:")
    for e in host:
        print(f"  {e.key[:60]:60s} {e.self_cpu_time_total / args.steps:9.1f}"
              f" ({e.count // args.steps} calls)")
    print("[sparse profile] device µs a step by kernel:")
    for e in kern:
        print(f"  {e.key[:60]:60s} {_device_us(e, True) / args.steps:9.1f}"
              f" ({e.count // args.steps} calls)")
    out = {"card": card, "steps": args.steps,
           "ms_per_step": wall_us / args.steps / 1e3,
           "device_ms_per_step": device_us / args.steps / 1e3,
           "idle_share": 1 - device_us / wall_us,
           "host_us_per_step": {e.key: e.self_cpu_time_total / args.steps
                                for e in host},
           "device_us_per_step": {e.key: _device_us(e, True) / args.steps
                                  for e in kern}}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
