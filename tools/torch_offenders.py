"""torch_offenders — roofline attribution of a training step of the
PyTorch port (`incubator_mxnet_tpu_torch`).

Builds a model-zoo ResNet v1 (NHWC, 1000 classes, random weights from a
seed), a `FusedTrainStep` with SGD (momentum 0.9) and a batch made with
numpy from a seed, and ranks the step's launch units through
`inspect.inspect_step`: each hand-written kernel launch and each aten op,
with its flops, bytes, arithmetic intensity, compute- or memory-bound
class and least time against the card's roofline (`inspect.roofline`),
grouped by kernel class. On a card (`--device cuda`) the step is also
profiled with torch.profiler and each unit carries its device time and
roofline share (bf16 AMP, one warm-up call, two profiled calls); on the
CPU (float32) the ranking is the cost model's.

    python tools/torch_offenders.py --model resnet50 --batch 32 --json out.json
    python tools/torch_offenders.py --device cpu --model resnet18 --batch 2 --json -
    python tools/torch_offenders.py --model resnet50 --markdown report.md

Knobs: MXNET_INSPECT_TOP_K, MXNET_INSPECT_CALIB. The JAX package's
`tools/offenders.py` reads an optimized HLO module instead; the port lowers
none, so there is no `--hlo-file` mode.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_step(model, batch, device, amp_dtype=None, seed=0):
    """(FusedTrainStep, x, y) for `model` ("resnet18", "resnet50", ...) at
    `batch` x 224^2 on `device`."""
    import torch
    from incubator_mxnet_tpu_torch import amp, gluon, optimizer
    from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    if amp_dtype:
        amp.init(amp_dtype)
    net = getattr(vision, f"{model}_v1")(layout="NHWC", classes=1000,
                                         device=device, seed=seed)
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy(rng.randn(batch, 224, 224, 3).astype(np.float32)) \
        .to(device)
    y = torch.from_numpy(rng.randint(0, 1000, batch).astype(np.int32)) \
        .to(device)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = optimizer.create("sgd", learning_rate=0.05, momentum=0.9,
                           rescale_grad=1.0 / batch)
    step = FusedTrainStep(net, lambda n, a, b: loss_fn(n(a), b).sum(), opt)
    return step, x, y


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_offenders", description=__doc__)
    ap.add_argument("--model", default="resnet18",
                    choices=("resnet18", "resnet50"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; profiled) or cpu (the cost "
                         "model only)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="units and classes listed (default "
                         "MXNET_INSPECT_TOP_K)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    help="write the report JSON (a path, or '-' / the bare "
                         "flag for stdout)")
    ap.add_argument("--markdown", nargs="?", const="-", default=None,
                    help="write the markdown report (a path or stdout)")
    args = ap.parse_args(argv)

    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import inspect as mxinspect
    from incubator_mxnet_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    # bf16 AMP on the card, as the flagship step runs; float32 on the CPU
    step, x, y = build_step(args.model, args.batch, device,
                            "bfloat16" if on_card else None)
    try:
        report = mxinspect.inspect_step(
            step, x, y, name=f"{args.model}_train_bs{args.batch}",
            top_k=args.top_k, measured=on_card, steps=2)
    finally:
        if on_card:
            amp.uninit()
    if args.markdown:
        text = mxinspect.render_markdown(report)
        if args.markdown == "-":
            print(text)
        else:
            with open(args.markdown, "w") as f:
                f.write(text + "\n")
            print(f"wrote {args.markdown}", file=sys.stderr)
    if args.json:
        if args.json == "-":
            print(json.dumps(report, indent=1, sort_keys=True, default=str))
        else:
            mxinspect.dump_json(report, args.json)
            print(f"wrote {args.json}", file=sys.stderr)
    if not args.json and not args.markdown:
        print(mxinspect.render_markdown(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
