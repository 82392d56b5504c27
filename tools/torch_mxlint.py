#!/usr/bin/env python
"""torch_mxlint — the lock-discipline and registry-consistency passes over
the PyTorch port, `incubator_mxnet_tpu_torch/` (the counterpart of
`tools/mxlint.py`; `incubator_mxnet_tpu_torch/analysis/` has the rules).

    python tools/torch_mxlint.py                   # full port, readable
    python tools/torch_mxlint.py --json            # machine-readable
    python tools/torch_mxlint.py --changed         # files changed vs git
    python tools/torch_mxlint.py --quick           # thread-heavy modules
    python tools/torch_mxlint.py --write-baseline  # accept current findings
    python tools/torch_mxlint.py --no-baseline     # show baselined ones too

Exit status: 0 when no un-baselined findings, 1 otherwise (2 on usage
errors). The tier-1 suite runs the full pass via tests/test_torch_lint.py,
so a new violation fails the build.

No torch import is needed at analysis time: the analyzer parses source
only, so it runs in a bare interpreter.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _import_analysis():
    """Import incubator_mxnet_tpu_torch.analysis WITHOUT executing the
    parent package __init__ (which imports torch — seconds the analyzer
    never needs). The analysis subpackage is stdlib-only by design."""
    if "incubator_mxnet_tpu_torch" not in sys.modules:
        parent = types.ModuleType("incubator_mxnet_tpu_torch")
        parent.__path__ = [os.path.join(REPO, "incubator_mxnet_tpu_torch")]
        sys.modules["incubator_mxnet_tpu_torch"] = parent
    return importlib.import_module("incubator_mxnet_tpu_torch.analysis")


analysis = _import_analysis()

# --quick: the thread-heavy / cache-heavy modules whose invariants drift
# fastest, plus registry-consistency (always whole-repo). Smoke-level scope
# for CI wrappers that want a sub-second signal.
QUICK_FILES = [
    "incubator_mxnet_tpu_torch/serve/batcher.py",
    "incubator_mxnet_tpu_torch/serve/metrics.py",
    "incubator_mxnet_tpu_torch/serve/continuous.py",
    "incubator_mxnet_tpu_torch/io/device_feed.py",
    "incubator_mxnet_tpu_torch/io/__init__.py",
    "incubator_mxnet_tpu_torch/ops/registry.py",
    "incubator_mxnet_tpu_torch/ops/kernels.py",
]


def changed_files(root):
    """Package .py files changed vs HEAD (staged, unstaged, untracked)."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    files = []
    for line in out.splitlines():
        path = line[3:].split(" -> ")[-1].strip().strip('"')
        if path.endswith(".py") and path.startswith(
                analysis.core.PACKAGE_DIRS):
            files.append(path)
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_mxlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON on stdout")
    ap.add_argument("--changed", action="store_true",
                    help="trace/lock passes only on files changed vs git")
    ap.add_argument("--quick", action="store_true",
                    help="thread-heavy module subset (fast smoke)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass families "
                         f"({','.join(analysis.PASS_FAMILIES)})")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON path (default tools/"
                         "torch_mxlint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline")
    ap.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    passes = None
    if args.passes:
        passes = [p.strip() for p in args.passes.split(",")]
        unknown = [p for p in passes if p not in analysis.PASS_FAMILIES]
        if unknown:
            ap.error(f"unknown pass families {unknown}; "
                     f"known: {list(analysis.PASS_FAMILIES)}")

    files = None
    if args.quick:
        files = QUICK_FILES
    elif args.changed:
        files = changed_files(args.root)
        if files is None:
            print("torch_mxlint: --changed needs git; falling back to a "
                  "full run", file=sys.stderr)

    if args.write_baseline and files is not None:
        # a partial scope cannot prove entries stale; fail before analyzing
        ap.error("--write-baseline needs the full scope "
                 "(drop --quick/--changed)")

    bl_path = args.baseline or os.path.join(args.root,
                                            analysis.DEFAULT_BASELINE)
    baseline = analysis.Baseline() if args.no_baseline \
        else analysis.Baseline.load(bl_path)

    new, baselined, stale = analysis.run_all(
        root=args.root, files=files, passes=passes, baseline=baseline)

    if args.write_baseline:
        # the entries kept keep their reasons; a new one gets its message
        analysis.Baseline(baseline.entries, bl_path).write(new + baselined)
        print(f"torch_mxlint: wrote {len(new) + len(baselined)} finding(s) "
              f"to {os.path.relpath(bl_path, args.root)}")
        return 0

    if args.json:
        payload = {
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "stale_baseline": stale,
            "counts": {"new": len(new), "baselined": len(baselined),
                       "stale_baseline": len(stale)},
            "passes": sorted(passes or analysis.PASS_FAMILIES),
            "scope": "quick" if args.quick
                     else ("changed" if args.changed else "full"),
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
        if stale:
            print(f"torch_mxlint: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (finding fixed — "
                  f"remove from baseline):", file=sys.stderr)
            for ident in stale:
                print(f"  {ident}", file=sys.stderr)
        tail = f"{len(new)} finding(s)"
        if baselined:
            tail += f", {len(baselined)} baselined"
        print(f"torch_mxlint: {tail}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
