"""The port's static-analysis passes gate tier-1, as mxlint gates the JAX
package (tests/test_lint.py).

  1. the port is clean: `run_all` over `incubator_mxnet_tpu_torch/` with
     `tools/torch_mxlint_baseline.json` yields no new finding and no stale
     entry, and every baseline entry and absent-table entry carries its
     reason;
  2. the seeded fixtures of tests/lint_fixtures/ are caught by the port's
     passes exactly as by the JAX package's (the same idents), and the
     baseline, suppression and ident contracts hold;
  3. the command line `tools/torch_mxlint.py` exits 1 on a planted
     violation;
  4. the launch counters of ops/kernels.py, which chip_smoke.py holds
     exactly, lose no update under eight threads.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import threading

import pytest
import torch

from incubator_mxnet_tpu import analysis as janalysis
from incubator_mxnet_tpu.analysis import lock_discipline as jlock
from incubator_mxnet_tpu.analysis import registry_consistency as jreg
from incubator_mxnet_tpu_torch import analysis
from incubator_mxnet_tpu_torch.analysis import (absent, lock_discipline,
                                                registry_consistency)
from incubator_mxnet_tpu_torch.analysis.core import Baseline, Module
from incubator_mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
BASELINE = os.path.join(REPO, analysis.DEFAULT_BASELINE)
ANALYSIS_DIR = os.path.join(REPO, "incubator_mxnet_tpu_torch", "analysis")
ABSENT_TABLES = ("ABSENT_ENV", "ABSENT_POINTS", "ABSENT_METRICS",
                 "ABSENT_OWNERS")


def _fixture_module(name, module_cls=Module):
    path = os.path.join(FIXTURES, name)
    with open(path) as f:
        src = f.read()
    return module_cls(path, os.path.join("tests", "lint_fixtures", name),
                      src)


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


def _idents(findings):
    return sorted((f.rule, f.path, f.scope, f.symbol, f.line)
                  for f in findings)


# ---------------------------------------------------------------------------
# 1. the port is clean under its baseline
# ---------------------------------------------------------------------------
def test_port_is_clean_under_baseline():
    new, baselined, stale = analysis.run_all(root=REPO, baseline=BASELINE)
    assert not new, "new findings in the port:\n" + "\n".join(
        f"  {f.path}:{f.line}: [{f.rule}] {f.message}" for f in new)
    assert not stale, ("baseline entries whose finding no longer exists — "
                       "delete them from tools/torch_mxlint_baseline.json:"
                       "\n" + "\n".join(f"  {s}" for s in stale))
    assert len(baselined) < 30


def test_every_baseline_entry_has_a_reason():
    with open(BASELINE) as f:
        entries = json.load(f)["findings"]
    assert entries
    for ident, reason in entries.items():
        assert ident.startswith(("lock-", "env-", "fault-", "stats-",
                                 "telemetry-", "mem-", "tune-", "absent-"))
        assert isinstance(reason, str) and len(reason.strip()) > 20, ident


def test_every_absent_entry_has_a_reason_and_accounts_for_a_finding():
    """Each absent entry names a reason, and run without the table the
    pass reports exactly the findings the table accounts for."""
    for name in ABSENT_TABLES:
        table = getattr(absent, name)
        assert table, name
        for entry, reason in table.items():
            assert isinstance(reason, str) and len(reason.strip()) > 20, \
                (name, entry)
    mods = [m for m in analysis.load_modules(REPO)
            if not m.relpath.endswith(os.path.join("analysis",
                                                   "absent.py"))]
    raw = registry_consistency.run(mods, REPO)
    rules = {"ABSENT_ENV": "env-doc-stale",
             "ABSENT_POINTS": "fault-point-unwired",
             "ABSENT_METRICS": "telemetry-doc-stale",
             "ABSENT_OWNERS": "mem-owner-doc-stale"}
    for name, rule in rules.items():
        found = {f.symbol for f in raw if f.rule == rule}
        assert found == set(getattr(absent, name)), name


def test_absent_entry_the_port_serves_is_stale():
    """A listed knob the port reads, and a listed name no doc row names,
    are both reported as stale entries."""
    mods = analysis.load_modules(REPO)
    served = Module("x.py", "incubator_mxnet_tpu_torch/x.py",
                    'import os\nos.environ.get("MXNET_COORDINATOR")\n')
    table = next(m for m in mods if m.relpath.endswith("absent.py"))
    src = table.source.replace('ABSENT_OWNERS = {',
                               'ABSENT_OWNERS = {\n    "no_such_owner": "x",')
    assert src != table.source
    patched = Module(table.path, table.relpath, src)
    others = [m for m in mods if m is not table]
    stale = {f.symbol for f in registry_consistency.run(
        others + [patched, served], REPO)
        if f.rule == "absent-entry-stale"}
    assert stale == {"MXNET_COORDINATOR", "no_such_owner"}


def test_port_idioms_are_read():
    """`_STATS = REGISTRY.stats_group("dispatch", ...)` registers the
    dispatch family, and `_mem_register(out, "device_feed")` registers
    the census owner: neither is reported stale against the docs."""
    mods = analysis.load_modules(REPO)
    dicts = {(d[0], d[2]): d for d in registry_consistency._stats_dicts(mods)}
    key = ("_STATS", os.path.join("incubator_mxnet_tpu_torch", "ops",
                                  "registry.py"))
    assert dicts[key][4] == "dispatch"
    assert set(dicts[key][1]) == {"dispatch", "eager_fallback"}
    owners = registry_consistency._mem_owner_sites(mods)
    assert owners["device_feed"][0].endswith("device_feed.py")
    # the JAX package's copy misses both, so it reports both as stale
    jmods = [janalysis.Module(m.path, m.relpath, m.source) for m in mods]
    jstale = {f.symbol for f in jreg.run(jmods, REPO)
              if f.rule in ("telemetry-doc-stale", "mem-owner-doc-stale")}
    assert {"dispatch.dispatch", "dispatch.eager_fallback",
            "device_feed"} <= jstale


def test_every_rule_name_is_registered():
    for fam in analysis.PASS_FAMILIES.values():
        for rule in fam.RULES:
            assert rule in analysis.ALL_RULES
    assert len(set(analysis.ALL_RULES)) == len(analysis.ALL_RULES)
    assert set(analysis.PASS_FAMILIES) == {"lock-discipline",
                                           "registry-consistency"}


def test_analysis_imports_no_jax_and_nothing_of_the_jax_package():
    for fn in sorted(os.listdir(ANALYSIS_DIR)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ANALYSIS_DIR, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "incubator_mxnet_tpu",
                                   "torch"), (fn, n)


# ---------------------------------------------------------------------------
# 2. the seeded fixtures, caught as the JAX package's passes catch them
# ---------------------------------------------------------------------------
def test_lock_discipline_fixture_findings():
    mod = _fixture_module("bad_locks.py")
    found = lock_discipline.run([mod])
    by = _by_rule(found)

    shared = {(f.scope, f.symbol) for f in by["lock-shared-mutation"]}
    assert ("Worker._run", "self._results") in shared
    assert ("Worker.reset", "self._results") in shared
    assert ("Worker.bump", "self._count") in shared
    assert ("Worker._run", "WORK_STATS") in shared
    assert ("Worker.reset", "self._count") not in shared
    assert ("Worker.drop", "WORK_STATS") not in shared
    assert ("Worker.drop", "self._results") not in shared
    assert not any(s.endswith(".__init__") for s, _ in shared)

    cycles = by.get("lock-order-cycle", [])
    assert len(cycles) == 1
    assert "_LOCK_A" in cycles[0].message and "_LOCK_B" in cycles[0].message

    jmod = _fixture_module("bad_locks.py", janalysis.Module)
    assert _idents(found) == _idents(jlock.run([jmod]))


def test_lock_discipline_no_cycle_without_opposite_order():
    mod = _fixture_module("bad_locks.py")
    src = mod.source[:mod.source.index("def path_ba")]
    clipped = Module(mod.path, mod.relpath, src)
    by = _by_rule(lock_discipline.run([clipped]))
    assert "lock-order-cycle" not in by
    assert by["lock-shared-mutation"]


def test_registry_consistency_fixture_findings():
    root = os.path.join(FIXTURES, "registry_repo")
    mods = analysis.load_modules(root, files=["pkg/mod.py"])
    found = registry_consistency.run(mods, root)
    by = _by_rule(found)

    assert {f.symbol for f in by["env-undocumented"]} == \
        {"MXNET_FIXTURE_SECRET"}
    assert {f.symbol for f in by["env-doc-stale"]} == {"MXNET_FIXTURE_GONE"}
    assert {f.symbol for f in by["fault-point-unwired"]} == {"beta.load"}
    assert {f.symbol for f in by["fault-point-undocumented"]} == \
        {"beta.load", "gamma.run"}
    assert {f.symbol for f in by["fault-point-unregistered"]} == \
        {"delta.crash"}
    assert {f.symbol for f in by["fault-doc-stale"]} == {"old.gone"}
    assert {f.symbol for f in by["fault-point-untested"]} == {"beta.load"}
    assert {f.symbol for f in by["fault-test-unknown-point"]} == \
        {"zeta.ghost"}
    assert {f.symbol for f in by["stats-key-untested"]} == {"misses"}
    assert {f.symbol for f in by["stats-family-untested"]} == {"cold"}
    assert {f.symbol for f in by["telemetry-metric-undocumented"]} == \
        {"tele.lonely"}
    assert {f.symbol for f in by["telemetry-doc-stale"]} == {"tele.ghost"}
    assert {f.symbol for f in by["telemetry-metric-untested"]} == \
        {"tele.obj_untested"}
    assert {f.symbol for f in by["mem-owner-undocumented"]} == \
        {"fixture_owner_secret"}
    assert {f.symbol for f in by["mem-owner-doc-stale"]} == \
        {"fixture_owner_ghost"}
    assert {f.symbol for f in by["tune-knob-undocumented"]} == \
        {"fix.secret"}
    assert {f.symbol for f in by["tune-doc-stale"]} == {"fix.ghost"}
    assert {f.symbol for f in by["tune-env-undeclared"]} == \
        {"MXNET_FIXTURE_SECRET"}
    assert "absent-entry-stale" not in by

    jmods = janalysis.load_modules(root, files=["pkg/mod.py"])
    assert _idents(found) == _idents(jreg.run(jmods, root))


def test_stats_group_adoption_still_yields_stats_keys():
    root = os.path.join(FIXTURES, "registry_repo")
    mods = analysis.load_modules(root, files=["pkg/mod.py"])
    by_name = {d[0]: d for d in registry_consistency._stats_dicts(mods)}
    assert set(by_name["TELE_STATS"][1]) == {"good", "lonely"}
    assert by_name["TELE_STATS"][4] == "tele"
    assert by_name["PIPE_STATS"][4] is None


def test_baseline_partitions_and_detects_stale():
    mod = _fixture_module("bad_locks.py")
    findings = lock_discipline.run([mod])
    target = next(f for f in findings if f.scope == "Worker.bump")
    bl = Baseline({target.ident: "intentional for the test",
                   "lock-shared-mutation:gone.py:X.y:self._z": "stale"})
    new, baselined, stale = bl.split(findings)
    assert target not in new and target in baselined
    assert stale == ["lock-shared-mutation:gone.py:X.y:self._z"]
    assert len(new) == len(findings) - 1


def test_baseline_ident_is_line_number_free():
    mod = _fixture_module("bad_locks.py")
    findings = lock_discipline.run([mod])
    for f in findings:
        assert str(f.line) not in f.ident.split(":")
    shifted = Module(mod.path, mod.relpath, "# shim\n# shim\n" + mod.source)
    assert {x.ident for x in findings} == \
        {x.ident for x in lock_discipline.run([shifted])}
    assert {x.line for x in findings} != \
        {x.line for x in lock_discipline.run([shifted])}


def test_partial_scope_never_reports_stale_baseline():
    new, baselined, stale = analysis.run_all(
        root=REPO, files=["incubator_mxnet_tpu_torch/serve/metrics.py"],
        baseline=BASELINE)
    assert not new
    assert stale == []
    r = _run_cli("--quick", "--write-baseline")
    assert r.returncode == 2


def test_suppression_must_start_the_comment():
    """Prose that merely mentions the syntax is not a suppression."""
    mod = _fixture_module("bad_locks.py")
    src = mod.source.replace(
        "self._results.append(2)  # mxlint: disable=lock-shared-mutation",
        "self._results.append(2)  # TODO: mxlint: disable=lock-shared-mutation")
    assert src != mod.source
    prosey = Module(mod.path, mod.relpath, src)
    shared = {(f.scope, f.symbol) for f in lock_discipline.run([prosey])}
    assert ("Worker.drop", "self._results") in shared


def test_file_level_suppression():
    mod = _fixture_module("bad_locks.py")
    src = "# mxlint: disable-file=lock-shared-mutation\n" + mod.source
    silenced = Module(mod.path, mod.relpath, src)
    by = _by_rule(lock_discipline.run([silenced]))
    assert "lock-shared-mutation" not in by
    assert "lock-order-cycle" in by        # other rules unaffected


# ---------------------------------------------------------------------------
# 3. the command line
# ---------------------------------------------------------------------------
def _run_cli(*args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_mxlint.py"),
         *args], capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_full_run_is_clean():
    r = _run_cli("--json")
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    data = json.loads(r.stdout)
    assert data["counts"]["new"] == 0
    assert data["counts"]["stale_baseline"] == 0
    assert data["scope"] == "full"
    assert set(data["passes"]) == set(analysis.PASS_FAMILIES)
    r = _run_cli("--changed", "--json")
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert json.loads(r.stdout)["scope"] == "changed"


def test_cli_write_baseline_keeps_the_reasons(tmp_path):
    """--write-baseline rewrites the file from the findings, and an entry
    it keeps keeps its reason (not the finding's message)."""
    path = tmp_path / "baseline.json"
    shutil.copy(BASELINE, path)
    r = _run_cli("--write-baseline", "--baseline", str(path))
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    with open(BASELINE) as f:
        want = json.load(f)["findings"]
    assert json.loads(path.read_text())["findings"] == want


def test_cli_exit_one_on_violation(tmp_path):
    """A copy of the port and its docs with one planted off-lock counter
    bump: exactly that finding is new, and the exit status is 1."""
    shutil.copytree(os.path.join(REPO, "incubator_mxnet_tpu_torch"),
                    tmp_path / "incubator_mxnet_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                  "*.so"))
    shutil.copytree(os.path.join(REPO, "docs"), tmp_path / "docs")
    args = ("--root", str(tmp_path), "--baseline", BASELINE, "--json")
    r = _run_cli(*args)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"

    path = tmp_path / "incubator_mxnet_tpu_torch" / "ops" / "kernels.py"
    src = path.read_text()
    path.write_text(src + "\n\ndef _planted(name):\n"
                    "    _BY_DTYPE[(name, 'float32')] += 1\n")
    r = _run_cli(*args)
    assert r.returncode == 1, f"stdout={r.stdout}\nstderr={r.stderr}"
    data = json.loads(r.stdout)
    assert data["counts"]["new"] == 1
    f = data["findings"][0]
    assert (f["rule"], f["scope"], f["symbol"]) == \
        ("lock-shared-mutation", "_planted", "_BY_DTYPE")


# ---------------------------------------------------------------------------
# 4. the launch counters under threads
# ---------------------------------------------------------------------------
def test_launch_counters_are_exact_under_threads():
    """8 threads each count 100,000 launches: no update is lost, in the
    per-dtype record or the scalar counter."""
    kernels.reset_launch_counts()
    n, per = 8, 100_000
    start = threading.Barrier(n)

    def work():
        start.wait()
        for _ in range(per):
            kernels._count_dtype("scale_shift_act", "torch.float32")
            kernels._count_launch("scale_shift_act")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as possible
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(prev)
    try:
        assert kernels.launch_counts_by_dtype() == \
            {("scale_shift_act", "float32"): n * per}
        assert kernels.launch_counts()["scale_shift_act"] == n * per
    finally:
        kernels.reset_launch_counts()
    assert sum(kernels.launch_counts().values()) == 0
    assert kernels.launch_counts_by_dtype() == {}


@pytest.mark.parametrize("site", [
    "serve/continuous.py", "telemetry/trace.py", "profiler.py"])
def test_inline_suppressions_carry_the_jax_packages_reason(site):
    """The port suppresses the patterns the JAX package suppresses, each
    with its reason after the rule (`-- why`)."""
    with open(os.path.join(REPO, "incubator_mxnet_tpu_torch", site)) as f:
        lines = f.read().splitlines()
    hits = [i for i, ln in enumerate(lines)
            if "# mxlint: disable=lock-shared-mutation" in ln]
    assert hits, site
    for i in hits:
        why = lines[i].split("mxlint: disable=")[1].partition(" -- ")[2]
        assert len(why.strip()) > 10, (site, lines[i])
