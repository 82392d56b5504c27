#!/usr/bin/env python
"""Convert a reference-format .params checkpoint into the offline npz zoo,
with the PyTorch port (the counterpart of `tools/convert_model.py`, with
the same flags and output).

The port's model store is offline too: a checkpoint is converted locally
once, then `gluon.model_zoo.vision.<model>(pretrained=True, root=...)`
loads it.

    python tools/torch_convert_model.py resnet18_v1.params ~/.mxnet/models/resnet18_v1.npz
    python tools/torch_convert_model.py net.params out.npz --rename old=new --rename a=b
    python tools/torch_convert_model.py zoo.params out.npz --auto-map resnet50_v1

--auto-map <model>: derive the rename table by aligning the checkpoint's
parameters with the port's model of the same architecture in
construction order, checking every pair's shape
(`model_store.auto_name_map`); explicit --rename entries win.

A host-side tool: it hides every card before torch is imported, so it
runs on the CPU wherever it is started.
"""
import os
import sys

os.environ["CUDA_VISIBLE_DEVICES"] = ""
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_convert_model", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("params_file")
    ap.add_argument("npz_file")
    ap.add_argument("--rename", action="append", default=[],
                    help="old=new parameter renames (repeatable)")
    ap.add_argument("--auto-map", default=None, metavar="MODEL",
                    help="derive renames by order+shape alignment against "
                         "a model-zoo architecture (e.g. resnet50_v1)")
    args = ap.parse_args(argv)
    from incubator_mxnet_tpu_torch.gluon.model_zoo.model_store import (
        auto_name_map, convert_params_to_npz)
    name_map = dict(r.split("=", 1) for r in args.rename)
    if args.auto_map:
        auto = auto_name_map(args.params_file, args.auto_map)
        auto.update(name_map)
        name_map = auto
        print(f"auto-map: aligned {len(auto)} parameters")
    out = convert_params_to_npz(args.params_file, args.npz_file,
                                name_map or None)
    import numpy as np
    with np.load(out) as f:
        print(f"wrote {out}: {len(f.files)} arrays")


if __name__ == "__main__":
    main()
