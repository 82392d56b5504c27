"""The NMS kernels against earlier versions of them, at detect()'s shape.

`ops/csrc/nms.cu` builds a suppression bitmask of every pair over the whole
card, then sweeps it a block an image. This script times it, in one process
on one card, beside each `--against NAME=PATH` (repeatable): another
`nms.cu`, built as its own library and bound by the `mx_nms_sweep` it
declares. One that takes the mask workspace (an earlier bitmask version,
such as the parent commit's) is launched through `kernels.nms_sweep_cuda`
in place of the built library; one that takes none is the sweep the
bitmask replaced, which walked each image's sorted rows in one block, a
barrier a kept row (commit 76e59ef's `nms.cu`, the last that holds it), and
is launched directly.

Every version is checked against `ops.contrib.nms_sweep_ref` bit for bit
and timed in turns (the versions in order, then in reverse, each round) at
(32, 8732) over four kinds of rows: SSD-like random boxes with 20 classes
and without, dense boxes without classes (most pairs overlap), and a chain
(each box overlaps the next alone). The bitmask versions' device ms are
split into the mask pass and the resolve pass (torch.profiler,
`chip_smoke.kernel_split`: null unless the parts add up to within 20% of
the CUDA-event time). It prints a line a kind and one JSON line. Run from
the repo root on a CUDA machine:

    mkdir -p _scratch/old _scratch/prev
    git archive 76e59ef | tar -x -C _scratch/old
    git archive HEAD~1 | tar -x -C _scratch/prev
    N=incubator_mxnet_tpu_torch/ops/csrc/nms.cu
    python3 tools/torch_nms_ab.py --against old=_scratch/old/$N \\
        --against prev=_scratch/prev/$N
"""
import argparse
import contextlib
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


def build_version(src, tag):
    """(library, bitmask): `src` (an `nms.cu`) compiled with the kernels'
    flags and bound by the `mx_nms_sweep` it declares, with the mask
    workspace (bitmask: True, bound as `kernels._load` binds the built one)
    or without (False: the one-block sweep)."""
    with open(src) as f:
        text = f.read()
    head = text[text.index('extern "C" int mx_nms_sweep('):]
    bitmask = "mask" in head[:head.index(")")]
    os.makedirs(kernels._BUILD, exist_ok=True)
    lib_path = os.path.join(kernels._BUILD, f"nms-{tag}.so")
    done = subprocess.run([kernels._nvcc(), *kernels._flags(), "-o",
                           lib_path, src], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{src}: nvcc exit {done.returncode}\n"
                         f"{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.mx_nms_sweep.restype = ctypes.c_int
    lib.mx_nms_sweep.argtypes = ([ctypes.c_int]
                                 + [ctypes.c_void_p] * (4 if bitmask else 3)
                                 + [ctypes.c_int] * 2
                                 + [ctypes.c_float, ctypes.c_void_p])
    if hasattr(lib, "mx_proposal_sweep"):
        lib.mx_proposal_sweep.restype = ctypes.c_int
        lib.mx_proposal_sweep.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_void_p])
    lib.mx_cuda_error_string.restype = ctypes.c_char_p
    lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
    return lib, bitmask


def versions(specs):
    """{name: (library or None (the built one), bitmask)}: each NAME=PATH
    of `specs`, then "new"."""
    out = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        out[name] = build_version(path, name)
    out["new"] = (None, True)
    return out


@contextlib.contextmanager
def library(lib):
    """Inside, the kernels' NMS wrappers launch `lib` (None: the built
    library)."""
    if lib is None:
        yield
        return
    kernels._load("nms")
    built = kernels._LIBS["nms"]
    kernels._LIBS["nms"] = lib
    try:
        yield
    finally:
        kernels._LIBS["nms"] = built


def in_turns(fns, rounds, reps=5):
    """{name: [median_ms, ...]}: each of `fns` (name -> fn(i)) timed in
    order, then in reverse, `rounds` times."""
    times = {n: [] for n in fns}
    for _ in range(rounds):
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cs.median_ms(fns[name], reps))
    return times


def sweep_fn(version, boxes, ids, keep, thresh):
    """fn(i): one sweep of `version` over the rows."""
    lib, bitmask = version

    def fn(_i=0):
        if bitmask:
            with library(lib):
                return kernels.nms_sweep_cuda(boxes, ids, keep, thresh)
        out = keep.clone()
        rc = lib.mx_nms_sweep(
            0, boxes.data_ptr(), ids.data_ptr() if ids is not None else None,
            out.data_ptr(), boxes.shape[0], boxes.shape[1], thresh,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    return fn


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
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=PATH", help="another nms.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    kernels.build(("nms",))
    libs = versions(args.against)
    gen = torch.Generator(device=dev).manual_seed(18)
    result = {"card": card, "shape": [B, A], "kinds": {}}
    for kind in ("classes", "no classes", "dense", "chain"):
        boxes, ids, keep, thresh = rows(kind, gen, dev)
        want = contrib.nms_sweep_ref(boxes, ids, keep, thresh)
        fns = {n: sweep_fn(v, boxes, ids, keep, thresh)
               for n, v in libs.items()}
        for name, fn in fns.items():
            assert torch.equal(fn(), want), (kind, name)
        times = in_turns(fns, args.rounds)
        reading = {n: float(np.median(t)) for n, t in times.items()}
        reading["splits"] = {n: cs.kernel_split(fns[n], reading[n])
                             for n, (_, bitmask) in libs.items() if bitmask}
        reading.update(reading["splits"]["new"])
        reading.update(alive=int(keep.sum()), kept=int(want.sum()),
                       runs=times)
        result["kinds"][kind] = reading
        print(f"[nms ab] {card} {kind}: "
              + ", ".join(f"{n} {reading[n]:.4f} ms" for n in fns)
              + " (mask pass / resolve: "
              + ", ".join(f"{n} {s['mask_ms']} / {s['sweep_ms']}"
                          for n, s in reading["splits"].items())
              + f"); {reading['kept']} of {reading['alive']} rows kept; "
              f"all bit-equal to the plain sweep", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
