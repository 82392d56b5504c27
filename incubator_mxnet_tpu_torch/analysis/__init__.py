"""mx.analysis of the PyTorch port — the static-analysis passes over the
port's own source (stdlib `ast` only; nothing here imports torch).

Counterpart of `incubator_mxnet_tpu/analysis/`, with two of its five pass
families:

  lock_discipline       shared-state mutation outside the owning lock,
                        lock-acquisition-order cycles
  registry_consistency  MXNET_* knobs vs docs/ENV_VARS.md, fault.POINTS
                        vs inject sites vs docs/RESILIENCE.md and the test
                        drills, stats keys and families vs tests,
                        telemetry metrics and census owners vs
                        docs/OBSERVABILITY.md, tune knobs vs
                        docs/TUNING.md; what the port leaves out of those
                        docs is named, with its reason, in `absent.py`

The other three families of the JAX package — `trace_safety`,
`donation_safety` and `retrace_hazard` — are a deliberate difference, not
a port: they key on `jax.jit`, `lax` and donated jitted programs, and the
port traces nothing. Run over the port they find one false positive
(`trace-closure-mutation` on `_rnn_fused.take` in
`numpy_extension/__init__.py`, a package with no jit). The port checks
donation at run time instead, through `sanitize.maybe_wrap_donated`.

Finding idents are the JAX package's (`rule:path:scope:symbol`), and the
suppressions the same (`# mxlint: disable=RULE -- why`).
CLI: `python tools/torch_mxlint.py [--changed] [--json]`; baseline:
`tools/torch_mxlint_baseline.json`; tier-1 gate: `tests/test_torch_lint.py`.
"""
from __future__ import annotations

import os

from . import lock_discipline, registry_consistency
from .core import Baseline, Finding, Module, load_modules, repo_root

__all__ = ["run_all", "PASS_FAMILIES", "ALL_RULES", "Baseline", "Finding",
           "Module", "load_modules", "repo_root", "DEFAULT_BASELINE"]

PASS_FAMILIES = {
    "lock-discipline": lock_discipline,
    "registry-consistency": registry_consistency,
}

ALL_RULES = tuple(r for m in PASS_FAMILIES.values() for r in m.RULES)

DEFAULT_BASELINE = os.path.join("tools", "torch_mxlint_baseline.json")


def run_all(root=None, files=None, passes=None, baseline=None):
    """Run the selected pass families; returns (new, baselined, stale).

    `files` restricts the lock pass to those repo-relative files;
    registry-consistency always sees the whole package (its invariants are
    cross-file, and it is cheap). `baseline` is a Baseline instance or a
    path; findings whose stable ident it lists are partitioned out.
    """
    root = root or repo_root()
    selected = {k: v for k, v in PASS_FAMILIES.items()
                if passes is None or k in passes}

    all_modules = load_modules(root)
    if files is not None:
        wanted = {os.path.normpath(f) for f in files}
        scoped = [m for m in all_modules
                  if os.path.normpath(m.relpath) in wanted]
    else:
        scoped = all_modules

    findings = []
    for name, mod in selected.items():
        if name == "registry-consistency":
            findings.extend(mod.run(all_modules, root))
        else:
            findings.extend(mod.run(scoped))

    # central suppression filter (passes already check line suppressions
    # where they have the Module in hand; this catches the rest uniformly)
    by_path = {m.relpath: m for m in all_modules}
    kept = []
    for f in findings:
        m = by_path.get(f.path)
        if m is not None and m.suppressed(f.rule, f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))

    if baseline is None:
        baseline = Baseline()
    elif isinstance(baseline, str):
        baseline = Baseline.load(baseline)
    new, baselined, stale = baseline.split(kept)
    if files is not None:
        # a partial scope cannot prove a baseline entry stale: findings in
        # unscanned files are simply absent, not fixed
        stale = []
    return new, baselined, stale
