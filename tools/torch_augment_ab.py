"""Time the augment kernel against an older source of it, in turns on one
card (old, new, new, old a round), at phase 15 (b)'s shapes.

The older source must have the one-row-a-block C interface
(`mx_image_augment(in, out, device, x, y0, x0, flip, out, N, H, W, ch, cw,
mean, std, stream)`, uint8 or float32 x of 3 channels); write it from git
first, for example

    git show <commit>:incubator_mxnet_tpu_torch/ops/csrc/image_augment.cu \
        > _scratch/old_image_augment.cu
    python tools/torch_augment_ab.py --old _scratch/old_image_augment.cu

Both kernels run on the same draws and must agree bit for bit. Prints the
card's name and power limit, a line a shape, and one JSON line. Runs on
the card only, from the repo root.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused, kernels  # noqa: E402

SHAPES = [((32, 224, 224, 3), None, torch.bfloat16),
          ((32, 224, 224, 3), None, torch.float32),
          ((32, 224, 224, 3), None, torch.float16),
          ((32, 256, 256, 3), (224, 224), torch.bfloat16),
          ((256, 224, 224, 3), None, torch.bfloat16)]


def load_old(src):
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(kernels._BUILD, exist_ok=True)
    lib = os.path.join(kernels._BUILD, f"old_image_augment_{tag}.so")
    if not os.path.isfile(lib):
        subprocess.run([kernels._nvcc(), *kernels._flags(), "-o", lib, src],
                       check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    dll.mx_image_augment.restype = ctypes.c_int
    dll.mx_image_augment.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 3)
    return dll


def old_call(dll, x, y0, x0, flips, crop, out_dtype):
    n, h, w, _ = x.shape
    ch, cw = crop or (h, w)
    if (ch, cw) == (h, w):
        y0 = x0 = None
    out = torch.empty((n, ch, cw, 3), dtype=out_dtype, device=x.device)
    consts = [(ctypes.c_float * 3)(*v) for v in (chip_smoke.IO_MEAN,
                                                 chip_smoke.IO_STD)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = dll.mx_image_augment(
        kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[out_dtype], 0,
        x.data_ptr(), ptr(y0), ptr(x0), ptr(flips), out.data_ptr(), n, h, w,
        ch, cw, consts[0], consts[1],
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the older .cu source")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: the comparison runs on the card only")
    print(chip_smoke.card_line(), flush=True)
    dll = load_old(args.old)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for shape, crop, out_dtype in SHAPES:
        n, h, w, _ = shape
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                          device=dev)
        draws = fused.augment_draws((11, 5), n, (h, w), crop, True, dev)
        new = lambda i: fused._augment_apply(  # noqa: E731
            x, *draws, crop, chip_smoke.IO_MEAN, chip_smoke.IO_STD,
            out_dtype)
        old = lambda i: old_call(dll, x, *draws, crop, out_dtype)  # noqa
        equal = torch.equal(new(0), old(0))
        times = {"old": [], "new": []}
        for _ in range(args.rounds):
            for name, fn in (("old", old), ("new", new), ("new", new),
                             ("old", old)):
                times[name].append(chip_smoke.median_ms(fn, args.reps))
        ch, cw = crop or (h, w)
        bound = chip_smoke.bound_ms("image_augment", N=n, ch=ch, cw=cw,
                                    in_dtype=torch.uint8,
                                    out_dtype=out_dtype)[0]
        row = {"shape": list(shape), "crop": [ch, cw],
               "out": chip_smoke._dtype_name(out_dtype), "equal": equal,
               "old_ms": float(np.median(times["old"])),
               "new_ms": float(np.median(times["new"])),
               "old_all": times["old"], "new_all": times["new"],
               "bound_ms": bound}
        row["new_gb_per_s"] = bound * chip_smoke.HBM_BYTES_PER_S / 1e9 \
            / row["new_ms"]
        rows.append(row)
        print(f"[augment a/b] {tuple(shape)} crop {row['crop']} -> "
              f"{row['out']}: old {row['old_ms']:.4f} ms, new "
              f"{row['new_ms']:.4f} ms, bound {bound:.4f} ms, new "
              f"{row['new_gb_per_s']:.0f} GB/s, bit-equal {equal}",
              flush=True)
        assert equal, "old and new augment kernels disagree"
    print(json.dumps({"augment_ab": rows}))


if __name__ == "__main__":
    main()
