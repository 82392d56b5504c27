"""Registry-consistency pass: every knob/fault-point/stats-key surface the
package exposes must stay in sync with its registry, docs, and tests.

Counterpart of `incubator_mxnet_tpu/analysis/registry_consistency.py`,
over the port's source against the same docs (docs/ENV_VARS.md,
docs/RESILIENCE.md, docs/OBSERVABILITY.md, docs/TUNING.md) and tests/.
Two differences:

  * it reads the port's idioms too: a stats group adopted under a bare
    `_STATS` name (`_STATS = REGISTRY.stats_group("dispatch", {...})`),
    and a census owner passed positionally to a `*mem*register` helper
    (`_mem_register(t, "device_feed")`);
  * what the port deliberately leaves out of those docs is named in its
    own table, `analysis/absent.py` (`ABSENT_ENV`, `ABSENT_POINTS`,
    `ABSENT_METRICS`, `ABSENT_OWNERS`, each entry with its queue or
    reason). A listed entry accounts for the env-doc-stale,
    fault-point-unwired, telemetry-doc-stale or mem-owner-doc-stale
    finding of its name. An entry that the port now serves, or that
    accounts for no finding, is itself a finding:

    absent-entry-stale  an absent-table entry the port now reads, wires
                        or registers, or that no doc row still names —
                        delete the entry

Three symbol families, six rules:

  MXNET_* environment variables — read sites are `get_env(...)`,
  `_register_env(...)`, `os.environ.get/[...]`, `os.getenv`; the doc
  surface is the table in docs/ENV_VARS.md.

    env-undocumented    a variable is read in the package but absent from
                        the doc table (users cannot discover the knob)
    env-doc-stale       a doc-table variable is no longer read anywhere
                        (the doc promises a knob that does nothing)

  fault injection points — the registry is `POINTS` (a module-level dict
  literal named POINTS); wired sites are string literals passed to
  `inject(...)` / `_fault_inject(...)` / `_fetch_with_restarts(_, "pt")`;
  the doc surface is the injection-point table in docs/RESILIENCE.md.

    fault-point-unwired       registered in POINTS, no inject call site
    fault-point-unregistered  injected under a name POINTS doesn't know
    fault-point-undocumented  registered but missing from RESILIENCE.md
    fault-doc-stale           a RESILIENCE.md table point not in POINTS

  fault COVERAGE — registration and wiring are necessary but
  not sufficient: a point nobody drills is a fire alarm nobody has ever
  pressed. Both directions against the tests/ tree:

    fault-point-untested      a POINTS entry never named by any test
                              literal (a quoted `"pt"` / `"pt:hit:kind"`
                              MXNET_FAULT_SPEC string or inject call) —
                              the drill is dead
    fault-test-unknown-point  an MXNET_FAULT_SPEC-shaped literal in a
                              test (`"name.sub:N:kind"`) naming a point
                              POINTS doesn't register — the spec is
                              silently inert, the test drills nothing.
                              Bare `inject("x")` literals in tests are
                              NOT checked: tests legitimately register
                              ad-hoc demo points at runtime

  profiler stats keys — module-level dict literals named `*_STATS`
  (DISPATCH_STATS / SERVE_STATS / FEED_STATS / KV_STATS), whether assigned
  bare or wrapped in a `stats_group("family", {...})` adoption call, are
  the `profiler.*_stats()` / telemetry-group key surface.

    stats-key-untested  a stats key never appears in any tests/*.py —
                        nothing would notice the counter going dead

    stats-family-untested  a `stats_group("family", ...)` adoption whose
                           FAMILY name never appears (quoted, or as a
                           quoted `family.` dotted prefix) in any test —
                           per-key coverage can pass while the group's
                           telemetry surface (snapshot()/prometheus
                           export under `family.*`) goes dark unnoticed

  memory census owners (mx.inspect.memory) — owner strings are the
  attribution surface a live-buffer census groups by, and like stats
  keys they rot: a renamed subsystem with a stale doc row (or an
  undocumented owner) makes an OOM dump unreadable. Code surface:
  literal `owner="..."` keywords of `register(...)` calls and the first
  arg of `mem.tag("...")` / `memory.tag("...")` context entries (flat
  `[a-z0-9_]+` tokens by contract — dots would collide with the metric
  namespace). Doc surface: the "Census owners" table in
  docs/OBSERVABILITY.md (section-scoped so owner tokens never collide
  with the metric catalog's dotted names).

    mem-owner-undocumented  an owner string used in code is missing
                            from the Census owners table
    mem-owner-doc-stale     a Census owners row names an owner no code
                            registers — stale docs fail the build

  telemetry metric names — the registered surface is (a) every
  `stats_group("family", {keys...})` adoption, contributing
  `family.key` names, and (b) every literal-named object metric:
  `REGISTRY.counter("a.b")` / `telemetry.histogram("a.b")` / bare
  `counter|gauge|histogram("a.b", ...)` calls with a dotted lowercase
  string first arg. The doc surface is the metric-catalog table in
  docs/OBSERVABILITY.md.

    telemetry-metric-undocumented  a registered metric name missing from
                                   the OBSERVABILITY.md catalog
    telemetry-doc-stale            a catalog row naming a metric that is
                                   not registered anywhere
    telemetry-metric-untested      an OBJECT metric's dotted name never
                                   appears in tests (group keys are
                                   already covered per-key by
                                   stats-key-untested)

  tune knobs (mx.tune) — the registry is `KNOBS` (a module-level dict
  literal, like POINTS); the exemption set is `NON_TUNABLE_ENV` (a set
  literal beside it); the doc surface is the "Knob catalog" table in
  docs/TUNING.md (section-scoped, like Census owners).

    tune-knob-undocumented  a KNOBS entry missing from the TUNING.md
                            knob-catalog table
    tune-doc-stale          a TUNING.md catalog row naming a knob not
                            in KNOBS
    tune-env-undeclared     an MXNET_* var read in a knob-WIRED module
                            (a module some knob's `wire` field names)
                            that is neither a declared knob env nor in
                            NON_TUNABLE_ENV — an undeclared tunable the
                            sweep can't see and profiles can't pin

All comparisons are literal-based on purpose: a knob that only exists
behind computed strings is unauditable and should be rewritten, not
special-cased.
"""
from __future__ import annotations

import ast
import os
import re

from .core import Finding, call_name, str_const

__all__ = ["run"]

RULES = ("env-undocumented", "env-doc-stale", "fault-point-unwired",
         "fault-point-unregistered", "fault-point-undocumented",
         "fault-doc-stale", "fault-point-untested",
         "fault-test-unknown-point", "stats-key-untested",
         "stats-family-untested",
         "telemetry-metric-undocumented", "telemetry-doc-stale",
         "telemetry-metric-untested",
         "mem-owner-undocumented", "mem-owner-doc-stale",
         "tune-knob-undocumented", "tune-doc-stale",
         "tune-env-undeclared", "absent-entry-stale")

_ENV_RE = re.compile(r"MXNET_[A-Z0-9_]+")
_STATS_NAME_RE = re.compile(r"^_?(?:[A-Z][A-Z0-9_]*_)?STATS$")
_ENV_READERS = {"get_env", "_register_env", "getenv"}
_INJECT_CALLEES = {"inject", "_fault_inject"}
_POINT_TABLE_RE = re.compile(r"^\|\s*`([a-z0-9_.]+)`(?:\s*/\s*`([a-z0-9_.]+)`)*")


def _env_read_name(node):
    """The literal MXNET_* var a single AST node reads, or None."""
    name = None
    if isinstance(node, ast.Call):
        cname = call_name(node)
        last = cname.split(".")[-1] if cname else None
        if last in _ENV_READERS and node.args:
            name = str_const(node.args[0])
        elif cname and cname.endswith("environ.get") and node.args:
            name = str_const(node.args[0])
    elif isinstance(node, ast.Subscript):
        # os.environ["X"] (read or write — both are knob surface)
        base = node.value
        if isinstance(base, ast.Attribute) and base.attr == "environ":
            name = str_const(node.slice)
    if name and name.startswith("MXNET_"):
        return name
    return None


def _env_reads(modules):
    """{var: (relpath, line)} for every literal MXNET_* read site."""
    reads = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            name = _env_read_name(node)
            if name and name not in reads:
                reads[name] = (mod.relpath, node.lineno)
    return reads


def _doc_env_vars(doc_path):
    """{var: line} for MXNET_* vars in the ENV_VARS.md table."""
    doc = {}
    if not os.path.exists(doc_path):
        return doc
    with open(doc_path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            if not line.lstrip().startswith("|"):
                continue
            first_cell = line.split("|")[1] if "|" in line[1:] else ""
            for m in _ENV_RE.finditer(first_cell):
                doc.setdefault(m.group(0), i)
    return doc


def _points_registry(modules):
    """(points {name: line}, module relpath) from `POINTS = {...}`."""
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Dict):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
                if "POINTS" in names:
                    pts = {}
                    for k in node.value.keys:
                        s = str_const(k)
                        if s:
                            pts[s] = k.lineno
                    return pts, mod.relpath
    return {}, None


def _inject_sites(modules):
    """{point: (relpath, line)} for literal injection call sites."""
    sites = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            last = cname.split(".")[-1] if cname else None
            lit = None
            if last in _INJECT_CALLEES and node.args:
                lit = str_const(node.args[0])
            elif last == "_fetch_with_restarts" and len(node.args) >= 2:
                lit = str_const(node.args[1])
            if lit and lit not in sites:
                sites[lit] = (mod.relpath, node.lineno)
    return sites


def _doc_points(doc_path):
    """(all_text, {point: line} from the injection-point table rows)."""
    table = {}
    text = ""
    if not os.path.exists(doc_path):
        return text, table
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    for i, line in enumerate(text.splitlines(), 1):
        m = _POINT_TABLE_RE.match(line.strip())
        if m:
            for pt in re.findall(r"`([a-z0-9_.]+)`",
                                 line.split("|")[1]):
                if "." in pt:
                    table.setdefault(pt, i)
    return text, table


_METRIC_CTORS = {"counter", "gauge", "histogram"}
_METRIC_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_OWNER_NAME_RE = re.compile(r"^[a-z0-9_]+$")


def _mem_owner_sites(modules):
    """{owner: (relpath, line)} for literal census-owner strings: the
    `owner=` keyword of any `register(...)`/`mem.register(...)` call,
    the second positional arg of a `*mem*register(t, "owner")` helper,
    and the first arg of `mem.tag(...)`/`memory.tag(...)` (the receiver
    must mention "mem" — a bare `tag(...)` elsewhere is not an owner)."""
    owners = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            if not cname:
                continue
            parts = cname.split(".")
            lit = None
            if parts[-1] == "register":
                for kw in node.keywords:
                    if kw.arg == "owner":
                        lit = str_const(kw.value)
            elif parts[-1].endswith("register") and "mem" in parts[-1] \
                    and len(node.args) >= 2:
                lit = str_const(node.args[1])
            elif parts[-1] == "tag" and len(parts) >= 2 \
                    and "mem" in parts[-2] and node.args:
                lit = str_const(node.args[0])
            if lit and _OWNER_NAME_RE.match(lit) and lit not in owners:
                owners[lit] = (mod.relpath, node.lineno)
    return owners


def _doc_mem_owners(doc_path):
    """{owner: line} from the "Census owners" table in OBSERVABILITY.md —
    SECTION-scoped (rows between the heading containing "Census owners"
    and the next heading), so flat owner tokens can never be confused
    with the dotted metric catalog."""
    doc = {}
    if not os.path.exists(doc_path):
        return doc
    in_section = False
    with open(doc_path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            stripped = line.strip()
            if stripped.startswith("#"):
                in_section = "census owners" in stripped.lower()
                continue
            if not in_section or not stripped.startswith("|"):
                continue
            first_cell = stripped.split("|")[1] if "|" in stripped[1:] \
                else ""
            for m in re.finditer(r"`([a-z0-9_]+)`", first_cell):
                if _OWNER_NAME_RE.match(m.group(1)):
                    doc.setdefault(m.group(1), i)
    return doc


def _stats_value_dict(value):
    """The key-declaring Dict of a *_STATS assignment: a bare dict literal,
    or the dict argument of a `stats_group("family", {...})` adoption call.
    Returns (dict_node, family_or_None)."""
    if isinstance(value, ast.Dict):
        return value, None
    if isinstance(value, ast.Call):
        cname = call_name(value)
        last = cname.split(".")[-1] if cname else None
        if last and last.lstrip("_") == "stats_group":
            family = str_const(value.args[0]) if value.args else None
            for a in value.args:
                if isinstance(a, ast.Dict):
                    return a, family
    return None, None


def _stats_dicts(modules):
    """[(dict_name, {key: line}, relpath, line, family)] for *_STATS
    literals — bare dicts and stats_group-adopted dicts alike."""
    out = []
    for mod in modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            dct, family = _stats_value_dict(node.value)
            if dct is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) \
                        and _STATS_NAME_RE.match(t.id):
                    keys = {}
                    for k in dct.keys:
                        s = str_const(k)
                        if s:
                            keys[s] = k.lineno
                    out.append((t.id, keys, mod.relpath, node.lineno,
                                family))
    return out


def _object_metrics(modules):
    """{dotted_name: (relpath, line)} for literal-named object-metric
    registrations: counter/gauge/histogram calls (any receiver — the
    constructors only exist on the telemetry registry) whose first arg is
    a dotted lowercase string literal."""
    metrics = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            cname = call_name(node)
            last = cname.split(".")[-1] if cname else None
            if last not in _METRIC_CTORS:
                continue
            lit = str_const(node.args[0])
            if lit and _METRIC_NAME_RE.match(lit) \
                    and lit not in metrics:
                metrics[lit] = (mod.relpath, node.lineno)
    return metrics


def _doc_metrics(doc_path):
    """{metric_name: line} for dotted names in the OBSERVABILITY.md metric
    catalog (backticked dotted names in the first cell of table rows)."""
    doc = {}
    if not os.path.exists(doc_path):
        return doc
    with open(doc_path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            stripped = line.strip()
            if not stripped.startswith("|"):
                continue
            first_cell = stripped.split("|")[1] if "|" in stripped[1:] \
                else ""
            for m in re.finditer(r"`([a-z0-9_.]+)`", first_cell):
                if _METRIC_NAME_RE.match(m.group(1)):
                    doc.setdefault(m.group(1), i)
    return doc


def _knob_catalog(modules):
    """(knobs {name: {"env", "wire", "line"}}, non_tunable set, relpath)
    from the `KNOBS = {...}` and `NON_TUNABLE_ENV = {...}` literals
    (mx.tune.space). Computed entries are invisible by design — the
    catalog is a literal contract, like POINTS."""
    knobs, non_tunable, relpath = {}, set(), None
    for mod in modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if "KNOBS" in names and isinstance(node.value, ast.Dict):
                relpath = mod.relpath
                for k, v in zip(node.value.keys, node.value.values):
                    name = str_const(k)
                    if not name or not isinstance(v, ast.Dict):
                        continue
                    spec = {"env": None, "wire": None, "line": k.lineno}
                    for sk, sv in zip(v.keys, v.values):
                        field = str_const(sk)
                        if field in ("env", "wire"):
                            spec[field] = str_const(sv)
                    knobs[name] = spec
            elif "NON_TUNABLE_ENV" in names \
                    and isinstance(node.value, ast.Set):
                for el in node.value.elts:
                    s = str_const(el)
                    if s:
                        non_tunable.add(s)
    return knobs, non_tunable, relpath


def _doc_knob_table(doc_path):
    """{knob: line} from the "Knob catalog" table in TUNING.md —
    SECTION-scoped (rows between the heading containing "knob catalog"
    and the next heading), so dotted knob names never collide with env
    vars or metric names mentioned elsewhere in the doc."""
    doc = {}
    if not os.path.exists(doc_path):
        return doc
    in_section = False
    with open(doc_path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            stripped = line.strip()
            if stripped.startswith("#"):
                in_section = "knob catalog" in stripped.lower()
                continue
            if not in_section or not stripped.startswith("|"):
                continue
            first_cell = stripped.split("|")[1] if "|" in stripped[1:] \
                else ""
            for m in re.finditer(r"`([a-z0-9_.]+)`", first_cell):
                if _METRIC_NAME_RE.match(m.group(1)):
                    doc.setdefault(m.group(1), i)
    return doc


def _wired_env_reads(modules, wires):
    """[(var, relpath, line)] — every literal MXNET_* read inside a
    knob-WIRED module (one whose relpath ends with some knob's `wire`
    value), first site per (module, var)."""
    out = []
    for mod in modules:
        if not any(mod.relpath.endswith(w) for w in wires):
            continue
        seen = set()
        for node in ast.walk(mod.tree):
            name = _env_read_name(node)
            if name and name not in seen:
                seen.add(name)
                out.append((name, mod.relpath, node.lineno))
    return out


def _tests_files(tests_dir, root):
    """[(root-relative path, source)] for every tests/*.py (fixtures
    excluded — they are parsed specimens, not coverage)."""
    out = []
    if os.path.isdir(tests_dir):
        for dirpath, dirnames, filenames in os.walk(tests_dir):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", "lint_fixtures")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = os.path.join(dirpath, fn)
                    with open(p, encoding="utf-8") as f:
                        out.append((os.path.relpath(p, root), f.read()))
    return out


def _tests_text(tests_dir, root=None):
    return "\n".join(t for _, t in
                     _tests_files(tests_dir, root or tests_dir))


# an MXNET_FAULT_SPEC-shaped literal: `"name.sub:HITS:kind` — the quote
# anchors it to string literals, the :digits: tail to real specs
_SPEC_LIT_RE = re.compile(
    r"""["']([a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+):\d+:[a-z]""")


# the absent tables (analysis/absent.py), by kind: the rule whose finding
# an entry accounts for
_ABSENT_TABLES = {"ABSENT_ENV": "env-doc-stale",
                  "ABSENT_POINTS": "fault-point-unwired",
                  "ABSENT_METRICS": "telemetry-doc-stale",
                  "ABSENT_OWNERS": "mem-owner-doc-stale"}


def _absent_tables(modules):
    """{table name: {entry: line}} and the module's relpath, from the
    module-level dict literals named in `_ABSENT_TABLES` (only keys are
    read: the reasons are for people)."""
    tables, relpath = {}, None
    for mod in modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Dict):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in _ABSENT_TABLES:
                    relpath = mod.relpath
                    tables[t.id] = {str_const(k): k.lineno
                                    for k in node.value.keys
                                    if str_const(k)}
    return tables, relpath


def _apply_absent(findings, tables, relpath, served):
    """`findings` less those an absent entry accounts for, plus an
    absent-entry-stale finding for each entry the port serves
    (`served[table]`) or that accounts for nothing."""
    used, kept = set(), []
    for f in findings:
        hit = next((name for name, rule in _ABSENT_TABLES.items()
                    if f.rule == rule and f.symbol in tables.get(name, ())),
                   None)
        if hit is None:
            kept.append(f)
        else:
            used.add((hit, f.symbol))
    for name, entries in sorted(tables.items()):
        for entry, line in sorted(entries.items()):
            if entry in served[name]:
                why = "the port now reads, wires or registers it"
            elif (name, entry) not in used:
                why = (f"it accounts for no "
                       f"{_ABSENT_TABLES[name]} finding")
            else:
                continue
            kept.append(Finding(
                "absent-entry-stale", relpath, line,
                f"`{entry}` is listed in {name} but {why} — delete the "
                f"entry", scope=name, symbol=entry))
    return kept


def _quoted_in(name, text):
    """`name` appears in `text` at the start of a string literal —
    matching both exact quoting and `"name:1:error"` spec forms /
    `"name.key"` dotted forms."""
    return f'"{name}' in text or f"'{name}" in text


def run(modules, root,
        env_doc="docs/ENV_VARS.md", resilience_doc="docs/RESILIENCE.md",
        obs_doc="docs/OBSERVABILITY.md", tuning_doc="docs/TUNING.md",
        tests_dir="tests"):
    findings = []
    env_doc_path = os.path.join(root, env_doc)
    res_doc_path = os.path.join(root, resilience_doc)
    obs_doc_path = os.path.join(root, obs_doc)
    tune_doc_path = os.path.join(root, tuning_doc)
    tests_path = os.path.join(root, tests_dir)

    # ---- env vars ------------------------------------------------------
    reads = _env_reads(modules)
    documented = _doc_env_vars(env_doc_path)
    for var, (path, line) in sorted(reads.items()):
        if var not in documented:
            findings.append(Finding(
                "env-undocumented", path, line,
                f"`{var}` is read here but not documented in {env_doc}",
                scope="env", symbol=var))
    for var, line in sorted(documented.items()):
        if var not in reads:
            findings.append(Finding(
                "env-doc-stale", env_doc, line,
                f"`{var}` is documented in {env_doc} but never read in "
                f"the package — delete the entry or wire the knob",
                scope="env", symbol=var))

    # ---- fault points --------------------------------------------------
    points, points_path = _points_registry(modules)
    sites = _inject_sites(modules)
    res_text, res_table = _doc_points(res_doc_path)
    for pt, line in sorted(points.items()):
        if pt not in sites:
            findings.append(Finding(
                "fault-point-unwired", points_path or "", line,
                f"fault point `{pt}` is registered in POINTS but no "
                f"inject() call site exists — it can never fire",
                scope="POINTS", symbol=pt))
        if res_text and pt not in res_text:
            findings.append(Finding(
                "fault-point-undocumented", points_path or "", line,
                f"fault point `{pt}` is registered but missing from "
                f"{resilience_doc}", scope="POINTS", symbol=pt))
    for pt, (path, line) in sorted(sites.items()):
        if points and pt not in points:
            findings.append(Finding(
                "fault-point-unregistered", path, line,
                f"inject site uses point `{pt}` which is not registered "
                f"in POINTS — specs naming it are silently dead to "
                f"introspection", scope="inject", symbol=pt))
    for pt, line in sorted(res_table.items()):
        if points and pt not in points:
            findings.append(Finding(
                "fault-doc-stale", resilience_doc, line,
                f"{resilience_doc} documents injection point `{pt}` "
                f"which is not in POINTS", scope="doc", symbol=pt))

    # ---- fault coverage: POINTS <-> test literals, both directions -----
    test_files = _tests_files(tests_path, root)
    tests_text = "\n".join(t for _, t in test_files)
    if tests_text and points:
        for pt, line in sorted(points.items()):
            if _quoted_in(pt, tests_text):
                continue
            findings.append(Finding(
                "fault-point-untested", points_path or "", line,
                f"fault point `{pt}` is never named by any test literal "
                f"(no MXNET_FAULT_SPEC spec or quoted point in tests/) — "
                f"the drill has never been run; add an injection test",
                scope="POINTS", symbol=pt))
        seen_unknown = set()
        for relpath, text in test_files:
            for i, ln in enumerate(text.splitlines(), 1):
                for m in _SPEC_LIT_RE.finditer(ln):
                    pt = m.group(1)
                    if pt in points or (relpath, pt) in seen_unknown:
                        continue
                    seen_unknown.add((relpath, pt))
                    findings.append(Finding(
                        "fault-test-unknown-point", relpath, i,
                        f"test fault spec names point `{pt}` which is "
                        f"not registered in POINTS — the spec is "
                        f"silently inert and the test drills nothing",
                        scope="tests", symbol=pt))

    # ---- stats keys ----------------------------------------------------
    stats = _stats_dicts(modules)
    if tests_text:
        for dname, keys, relpath, dline, _family in stats:
            for key, line in sorted(keys.items()):
                if f'"{key}"' in tests_text or f"'{key}'" in tests_text:
                    continue
                findings.append(Finding(
                    "stats-key-untested", relpath, line,
                    f"stats key `{dname}[{key!r}]` never appears in any "
                    f"test — nothing notices if the counter goes dead",
                    scope=dname, symbol=key))
        seen_fams = set()
        for dname, keys, relpath, dline, family in stats:
            if not family or family in seen_fams:
                continue
            seen_fams.add(family)
            # a family is covered only by its DOTTED telemetry names
            # ("family.key"): a bare substring like "prefix_hit_rate"
            # exercises a different surface, not the stats group export
            if _quoted_in(family + ".", tests_text):
                continue
            findings.append(Finding(
                "stats-family-untested", relpath, dline,
                f"stats group family `{family}` ({dname}) never appears "
                f"as a quoted literal in any test — its telemetry "
                f"surface (`{family}.*` in snapshot()/prometheus "
                f"export) can go dark unnoticed",
                scope=dname, symbol=family))

    # ---- telemetry metric names ---------------------------------------
    # registered surface: stats_group families ({family}.{key}) + literal
    # object metrics; doc surface: the OBSERVABILITY.md metric catalog
    registered = {}
    for dname, keys, relpath, dline, family in stats:
        if family:
            for key, line in keys.items():
                registered.setdefault(f"{family}.{key}", (relpath, line))
    objects = _object_metrics(modules)
    registered.update(
        {k: v for k, v in objects.items() if k not in registered})
    doc_metrics = _doc_metrics(obs_doc_path)
    if registered:
        for name, (relpath, line) in sorted(registered.items()):
            if name not in doc_metrics:
                findings.append(Finding(
                    "telemetry-metric-undocumented", relpath, line,
                    f"telemetry metric `{name}` is registered here but "
                    f"missing from the {obs_doc} catalog",
                    scope="telemetry", symbol=name))
        for name, line in sorted(doc_metrics.items()):
            if name not in registered:
                findings.append(Finding(
                    "telemetry-doc-stale", obs_doc, line,
                    f"{obs_doc} catalogs metric `{name}` which is not "
                    f"registered anywhere — delete the row or register "
                    f"the metric", scope="doc", symbol=name))
    if tests_text:
        for name, (relpath, line) in sorted(objects.items()):
            if f'"{name}"' in tests_text or f"'{name}'" in tests_text:
                continue
            findings.append(Finding(
                "telemetry-metric-untested", relpath, line,
                f"telemetry metric `{name}` never appears (as a dotted "
                f"literal) in any test — nothing notices it going dead",
                scope="telemetry", symbol=name))

    # ---- memory census owners (mx.inspect.memory) ---------------------
    owner_sites = _mem_owner_sites(modules)
    doc_owners = _doc_mem_owners(obs_doc_path)
    if owner_sites or doc_owners:
        for owner, (relpath, line) in sorted(owner_sites.items()):
            if owner not in doc_owners:
                findings.append(Finding(
                    "mem-owner-undocumented", relpath, line,
                    f"census owner `{owner}` is registered here but "
                    f"missing from the {obs_doc} Census owners table — "
                    f"an OOM dump naming it would be unreadable",
                    scope="mem-owner", symbol=owner))
        for owner, line in sorted(doc_owners.items()):
            if owner not in owner_sites:
                findings.append(Finding(
                    "mem-owner-doc-stale", obs_doc, line,
                    f"{obs_doc} Census owners table lists `{owner}` "
                    f"which no code registers — delete the row or "
                    f"restore the registration",
                    scope="doc", symbol=owner))

    # ---- tune knob catalog (mx.tune) -----------------------------------
    # guard on a KNOBS literal existing so fixture repos (and pre-tune
    # trees) produce no tune findings at all
    knobs, non_tunable, knobs_path = _knob_catalog(modules)
    if knobs:
        doc_knobs = _doc_knob_table(tune_doc_path)
        for name, spec in sorted(knobs.items()):
            if name not in doc_knobs:
                findings.append(Finding(
                    "tune-knob-undocumented", knobs_path or "",
                    spec["line"],
                    f"tune knob `{name}` is declared in KNOBS but "
                    f"missing from the {tuning_doc} knob-catalog table",
                    scope="KNOBS", symbol=name))
        for name, line in sorted(doc_knobs.items()):
            if name not in knobs:
                findings.append(Finding(
                    "tune-doc-stale", tuning_doc, line,
                    f"{tuning_doc} catalogs knob `{name}` which is not "
                    f"declared in KNOBS — delete the row or declare "
                    f"the knob", scope="doc", symbol=name))
        declared_env = {s["env"] for s in knobs.values() if s["env"]}
        wires = {s["wire"] for s in knobs.values() if s["wire"]}
        for var, relpath, line in sorted(
                _wired_env_reads(modules, wires)):
            if var in declared_env or var in non_tunable:
                continue
            findings.append(Finding(
                "tune-env-undeclared", relpath, line,
                f"`{var}` is read in knob-wired module {relpath} but is "
                f"neither a declared knob env nor in NON_TUNABLE_ENV — "
                f"an undeclared tunable the sweep cannot see; declare "
                f"it in KNOBS or exempt it",
                scope="tune-env", symbol=var))

    # ---- the port's absent tables -------------------------------------
    tables, absent_path = _absent_tables(modules)
    if tables:
        findings = _apply_absent(findings, tables, absent_path, {
            "ABSENT_ENV": set(reads), "ABSENT_POINTS": set(sites),
            "ABSENT_METRICS": set(registered),
            "ABSENT_OWNERS": set(owner_sites)})
    return findings
