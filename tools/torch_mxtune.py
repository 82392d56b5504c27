#!/usr/bin/env python
"""torch_mxtune — the deployment-profile autotuner CLI of the PyTorch port
(`tools/mxtune.py`'s counterpart, over `incubator_mxnet_tpu_torch.tune`).

Sweep the declared knob catalog for a (model, hardware) deployment on the
card, report the winners against the hand-tuned baselines, and persist
the profile under the profile directory so the next replica boots tuned.
Every trial is a scrubbed-env subprocess on `--device` (default `cuda`).

    # what would run, without running it
    python tools/torch_mxtune.py --phases serve_decode --dry-run

    # sweep two phases on the card with a 16-trial budget, write the
    # profile
    python tools/torch_mxtune.py --model model_spec.json \
        --phases serve_decode,train_fused --budget 16 \
        --write-profile --json tune_report.json

    # rehearse on the CPU
    python tools/torch_mxtune.py --device cpu --phases dispatch \
        --budget 1 --json -

`--model` is a JSON file whose contents identify the deployment (a
DecoderConfig dict, an export manifest, ...); its canonical hash is the
profile's model fingerprint. Without it the profile is keyed to the
empty model meta (tuning host-generic knobs like io/dispatch).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _markdown(res, prof):
    lines = ["# torch_mxtune report", ""]
    if prof is not None:
        lines += [f"profile `{prof.profile_hash}` — model "
                  f"`{prof.model_fp}`, hardware `{prof.hw_fp}`", ""]
    lines += ["| phase | hand score | best score | speedup | trials "
              "| failed |", "|---|---|---|---|---|---|"]
    for p, d in sorted(res["phases"].items()):
        base = (d.get("baseline") or {}).get("score")
        best = (d.get("best") or {}).get("score")
        unit = (d.get("best") or {}).get("unit") or ""
        failed = sum(1 for t in d["trials"] if not t["ok"])
        lines.append(
            f"| {p} | {base} | {best} {unit} | "
            f"{d.get('speedup_vs_hand')} | {len(d['trials'])} | "
            f"{failed} |")
    lines += ["", "## winning knobs", ""]
    for k, v in sorted(res["knobs"].items()):
        lines.append(f"- `{k}` = `{v!r}`")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_mxtune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", help="JSON file identifying the model "
                    "(fingerprint source)")
    ap.add_argument("--phases", help="comma-separated bench phases "
                    "(default: every phase the catalog declares)")
    ap.add_argument("--budget", type=int, default=None,
                    help="total trial budget (default MXNET_TUNE_BUDGET "
                    "or 24)")
    ap.add_argument("--scale", default="full",
                    choices=("quick", "full"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the trials run: cuda (the card, default) "
                    "or cpu")
    ap.add_argument("--json", help="write the full sweep result here "
                    "('-' = standard output)")
    ap.add_argument("--markdown", help="write a markdown report here")
    ap.add_argument("--write-profile", nargs="?", const="", default=None,
                    metavar="DIR", help="persist the winning profile "
                    "(optionally into DIR; default: the profile dir)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the deterministic trial schedule and "
                    "exit without measuring")
    args = ap.parse_args(argv)

    from incubator_mxnet_tpu_torch import tune

    model_meta = {}
    if args.model:
        with open(args.model) as f:
            model_meta = json.load(f)
    phases = (args.phases.split(",") if args.phases
              else [p for p in tune.phases() if p in tune.HAND_TUNED])

    if args.dry_run:
        for p in phases:
            sched = tune.plan(p, budget=args.budget)
            print(f"phase {p}: {len(sched)} trials")
            for i, asn in enumerate(sched):
                tag = "hand-tuned baseline" if i == 0 else ""
                print(f"  [{i:3d}] {json.dumps(asn, sort_keys=True)} "
                      f"{tag}")
        return 0

    res = tune.sweep(phases=phases, budget=args.budget, seed=args.seed,
                     scale=args.scale, device=args.device)
    prof = None
    if res["knobs"]:
        prof = tune.build_profile(
            res, model_meta=model_meta,
            hw_meta=tune.hardware_fingerprint(args.device))
    for p, d in sorted(res["phases"].items()):
        print(f"phase {p}: hand={(d['baseline'] or {}).get('score')} "
              f"best={(d['best'] or {}).get('score')} "
              f"speedup={d.get('speedup_vs_hand')} "
              f"({len(d['trials'])} trials, "
              f"{sum(1 for t in d['trials'] if not t['ok'])} failed)")
    if args.json:
        payload = dict(res)
        if prof is not None:
            payload["profile"] = prof.to_dict()
        if args.json == "-":
            print(json.dumps(payload, sort_keys=True))
        else:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            print(f"wrote {args.json}")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(_markdown(res, prof))
        print(f"wrote {args.markdown}")
    if args.write_profile is not None:
        if prof is None:
            print("no successful trials — nothing to persist",
                  file=sys.stderr)
            return 1
        path = prof.save(directory=args.write_profile or None)
        print(f"profile {prof.profile_hash} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
