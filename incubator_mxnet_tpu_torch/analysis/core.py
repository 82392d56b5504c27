"""Shared infrastructure of the port's static-analysis passes.

Counterpart of `incubator_mxnet_tpu/analysis/core.py`, over the port's
own source. The analyzer reads the package's AST (stdlib `ast` only: no
third-party lint dependency, no `torch` import), so it sees exactly what
ships. Three pieces live here, used by every pass family:

  * `Finding` — one diagnostic, with a *stable identity* (`ident`) built
    from rule + file + enclosing scope + symbol, NOT the line number, so a
    committed baseline survives unrelated edits to the same file.
  * suppressions — `# mxlint: disable=RULE[,RULE2]` on the offending line
    (or the line above it), and `# mxlint: disable-file=RULE` anywhere in
    the first 10 lines of a file. Rules are matched by exact name or the
    `*` wildcard.
  * `Baseline` — a committed JSON map of finding-ident -> note for
    intentional patterns that are not worth an inline comment (e.g. a
    lock-free handoff ordered by Thread.join). `--write-baseline`
    regenerates it; a baselined finding that disappears is reported as
    stale so the file shrinks monotonically.
"""
from __future__ import annotations

import ast
import json
import os
import re
import tokenize

__all__ = [
    "Finding", "Module", "load_modules", "Baseline",
    "parse_suppressions", "PACKAGE_DIRS", "repo_root",
]

# Directories (relative to the repo root) whose .py files are analyzed.
PACKAGE_DIRS = ("incubator_mxnet_tpu_torch",)

# anchored at the comment start: prose that merely mentions the syntax
# ("# TODO: add mxlint: disable=... here") must not suppress anything
_SUPPRESS_RE = re.compile(r"^#+\s*mxlint:\s*disable=([A-Za-z0-9_,*\- ]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"^#+\s*mxlint:\s*disable-file=([A-Za-z0-9_,*\- ]+)")


def repo_root(start=None):
    """Locate the repository root (the directory holding the package)."""
    d = os.path.abspath(start or os.path.dirname(
        os.path.dirname(os.path.dirname(__file__))))
    return d


class Finding:
    """One diagnostic emitted by a pass.

    `symbol` is the stable anchor (attribute name, env-var name, fault
    point, ...) and `scope` the enclosing class/function qualname; both go
    into `ident` instead of the line number so baselines don't rot when
    lines shift.
    """

    __slots__ = ("rule", "path", "line", "scope", "symbol", "message")

    def __init__(self, rule, path, line, message, scope="", symbol=""):
        self.rule = rule
        self.path = path
        self.line = int(line)
        self.scope = scope
        self.symbol = symbol
        self.message = message

    @property
    def ident(self):
        return f"{self.rule}:{self.path}:{self.scope}:{self.symbol}"

    def to_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "scope": self.scope, "symbol": self.symbol,
                "message": self.message, "ident": self.ident}

    def __repr__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Module:
    """A parsed source file: AST + per-line suppression table."""

    def __init__(self, path, relpath, source):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.line_suppress, self.file_suppress = parse_suppressions(source)

    def suppressed(self, rule, line):
        """True when `rule` is disabled at `line` (same line, the line
        above, or file-wide)."""
        if rule in self.file_suppress or "*" in self.file_suppress:
            return True
        for ln in (line, line - 1):
            rules = self.line_suppress.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        return False


def _rule_names(raw):
    """Rule list from a disable= payload; trailing prose after whitespace
    (e.g. `disable=RULE -- why`) is ignored per comma-separated entry."""
    names = set()
    for piece in raw.split(","):
        piece = piece.strip()
        if piece:
            names.add(piece.split()[0])
    return names


def parse_suppressions(source):
    """Extract `# mxlint: disable=...` comments.

    Returns (line -> set(rules), file-wide set(rules)). Comments are read
    via tokenize so strings that merely *mention* the syntax don't count.
    """
    line_rules = {}
    file_rules = set()
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_FILE_RE.match(tok.string)
            if m and tok.start[0] <= 10:
                file_rules.update(_rule_names(m.group(1)))
                continue
            m = _SUPPRESS_RE.match(tok.string)
            if m:
                line_rules.setdefault(tok.start[0],
                                      set()).update(_rule_names(m.group(1)))
    except (tokenize.TokenError, IndentationError):
        pass
    return line_rules, file_rules


def load_modules(root, files=None):
    """Parse every analyzed .py file under `root` (or just `files`,
    repo-relative). Returns a list of Modules; unparseable files raise —
    a syntax error in the package is itself a finding-worthy failure."""
    mods = []
    if files is not None:
        paths = [os.path.join(root, f) for f in files]
    else:
        paths = []
        for d in PACKAGE_DIRS:
            base = os.path.join(root, d)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [x for x in dirnames if x != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        paths.append(os.path.join(dirpath, fn))
    for p in paths:
        if not p.endswith(".py") or not os.path.exists(p):
            continue
        rel = os.path.relpath(p, root)
        with open(p, "r", encoding="utf-8") as f:
            src = f.read()
        mods.append(Module(p, rel, src))
    return mods


class Baseline:
    """Committed map of intentional findings: ident -> note."""

    def __init__(self, entries=None, path=None):
        self.entries = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path):
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            return cls(data.get("findings", {}), path=path)
        return cls(path=path)

    def write(self, findings, path=None):
        path = path or self.path
        payload = {
            "_comment": "torch_mxlint baseline: intentional findings "
                        "keyed by stable ident (rule:path:scope:symbol), "
                        "each with its reason. Regenerate with `python "
                        "tools/torch_mxlint.py --write-baseline`; entries "
                        "should only ever be removed.",
            "findings": {f.ident: self.entries.get(f.ident, f.message)
                         for f in findings},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    def split(self, findings):
        """Partition findings into (new, baselined); also returns the
        stale baseline idents no longer produced."""
        new, old = [], []
        seen = set()
        for f in findings:
            if f.ident in self.entries:
                old.append(f)
                seen.add(f.ident)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, old, stale


# ---------------------------------------------------------------------------
# small AST helpers shared by the passes
# ---------------------------------------------------------------------------
def call_name(node):
    """Dotted name of a Call's callee: 'os.getenv', 'self._worker'."""
    return dotted(node.func)


def dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_scope(node):
    """Yield nodes of `node`'s body without descending into nested
    function/class definitions."""
    todo = list(ast.iter_child_nodes(node))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(n))
