"""Lock-discipline pass: shared-state mutation outside the owning lock,
and lock-acquisition-order cycles.

Counterpart of `incubator_mxnet_tpu/analysis/lock_discipline.py`, with
the same rules and idents, over the port's source.

Scope — the pass analyzes two kinds of class:

  * thread-spawning classes: any class that creates a `threading.Thread`
    (target = a bound method or a nested def). The thread-side code set is
    the closure of the target over `self.method()` calls; every other
    method is consumer-side.
  * lock-owning classes: any class that assigns a `threading.Lock` /
    `RLock` / `Condition` to a `self.*` attribute.

Rules:

  lock-shared-mutation   a `self._*` attribute (or a module-level
      `_UPPER_CASE` stats global) is mutated outside any known lock
      context, where the attribute is also touched from the other side of
      a thread boundary (thread-side vs consumer-side). `__init__` is
      exempt (no concurrency before construction completes). For
      module-level stats globals the rule applies in any module that owns
      a lock or spawns threads: a dict `+=` is a read-modify-write and
      loses updates under contention, GIL or not.
  lock-order-cycle       the directed graph lock-A -> lock-B (B acquired
      while A is held, directly or through a same-module call) contains a
      cycle: two threads taking the locks in opposite orders deadlock.

Intentional lock-free patterns (e.g. a handoff ordered by Thread.join)
belong in the committed baseline or under an inline
`# mxlint: disable=lock-shared-mutation` with a short justification.
"""
from __future__ import annotations

import ast
import re

from .core import Finding, call_name, dotted

__all__ = ["run"]

RULES = ("lock-shared-mutation", "lock-order-cycle")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_MUTATORS = {"append", "add", "update", "extend", "insert", "remove",
             "discard", "pop", "popitem", "popleft", "appendleft", "clear",
             "setdefault", "sort", "reverse"}
_STATS_GLOBAL_RE = re.compile(r"^_?[A-Z][A-Z0-9_]*$")


def _is_lock_ctor(node):
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return name is not None and name.split(".")[-1] in _LOCK_CTORS


def _module_locks(tree):
    """Module-level names bound to threading lock objects."""
    locks = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    locks.add(t.id)
    return locks


def _module_stats_globals(tree):
    """Module-level `_UPPER_CASE` names (the stats-dict convention) —
    including aliases like `_STATS = other.DICT` and telemetry-registry
    adoptions like `X_STATS = stats_group("x", {...})` (the adopted group
    IS the mutable dict; off-lock mutation rules apply unchanged)."""
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and _STATS_GLOBAL_RE.match(t.id):
                    if isinstance(node.value, (ast.Dict, ast.List,
                                               ast.Attribute, ast.Name,
                                               ast.Call)):
                        names.add(t.id)
    return names


class _ClassInfo:
    def __init__(self, node):
        self.node = node
        self.name = node.name
        self.methods = {}            # name -> FunctionDef
        self.lock_attrs = set()      # self.<attr> holding a lock
        self.thread_targets = []     # (method name | nested def node, owner)
        for child in node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[child.name] = child


def _self_attr(node):
    """'attr' when node is `self.attr`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _scan_class(cls_node):
    info = _ClassInfo(cls_node)
    for m in info.methods.values():
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        info.lock_attrs.add(a)
            elif isinstance(node, ast.Call):
                cname = call_name(node)
                if cname and cname.split(".")[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        a = _self_attr(kw.value)
                        if a:
                            info.thread_targets.append((a, m))
                        elif isinstance(kw.value, ast.Name):
                            info.thread_targets.append((kw.value.id, m))
    return info


def _thread_side(info):
    """Function nodes executed on the spawned thread: the targets plus the
    closure over `self.method()` calls (and their nested defs)."""
    side = []
    seen = set()
    todo = []
    for target, owner in info.thread_targets:
        if target in info.methods:
            todo.append(info.methods[target])
        else:
            # nested def inside the spawning method
            for node in ast.walk(owner):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node.name == target:
                    todo.append(node)
    while todo:
        fn = todo.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        side.append(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                a = _self_attr(node.func)
                if a and a in info.methods and \
                        id(info.methods[a]) not in seen:
                    todo.append(info.methods[a])
    return side


def _lock_expr_id(node, relpath, cls_name, module_locks):
    """Stable identity of a lock expression, or None when not a lock."""
    a = _self_attr(node)
    if a is not None:
        return f"{relpath}:{cls_name}.{a}" if cls_name else None
    if isinstance(node, ast.Name) and node.id in module_locks:
        return f"{relpath}:{node.id}"
    return None


class _Access:
    __slots__ = ("attr", "node", "line", "mutation", "locked", "fn_name")

    def __init__(self, attr, node, mutation, locked, fn_name):
        self.attr = attr
        self.node = node
        self.line = node.lineno
        self.mutation = mutation
        self.locked = locked
        self.fn_name = fn_name


def _scan_accesses(fn, lock_attrs, module_locks, relpath, cls_name,
                   stats_globals, qual):
    """Walk one function, tracking held locks, recording self-attr and
    stats-global accesses. Returns (accesses, global_mutations, edges,
    acquired) where edges are (outer_lock, inner_lock_or_call) pairs."""
    accesses = []
    gmuts = []
    edges = []
    acquired = set()

    def lock_of(expr):
        lid = _lock_expr_id(expr, relpath, cls_name, module_locks)
        if lid is None and isinstance(expr, ast.Call):
            # with lock.acquire()? uncommon; treat `x.acquire()` callee
            base = expr.func
            if isinstance(base, ast.Attribute) and base.attr == "acquire":
                return _lock_expr_id(base.value, relpath, cls_name,
                                     module_locks)
        return lid

    def visit(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        if isinstance(node, ast.With):
            inner = list(held)
            for item in node.items:
                lid = lock_of(item.context_expr)
                if lid is not None:
                    acquired.add(lid)
                    for h in inner:
                        edges.append((h, lid))
                    inner = inner + [lid]
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                _record_target(t, held, node)
        if isinstance(node, ast.Call):
            _record_call(node, held)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            visit(child, held)

    def _record_target(t, held, stmt):
        # self.attr = / self.attr[k] = / self.attr.x =
        node = t
        if isinstance(node, ast.Subscript):
            base = node.value
            a = _self_attr(base)
            if a is not None:
                accesses.append(_Access(a, t, True, bool(held), qual))
                return
            if isinstance(base, ast.Name) and base.id in stats_globals:
                gmuts.append(_Access(base.id, t, True, bool(held), qual))
                return
        a = _self_attr(node)
        if a is not None and a not in lock_attrs:
            accesses.append(_Access(a, t, True, bool(held), qual))

    def _record_call(node, held):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            base = node.func.value
            a = _self_attr(base)
            if a is not None:
                accesses.append(_Access(a, node, True, bool(held), qual))
            elif isinstance(base, ast.Name) and base.id in stats_globals:
                gmuts.append(_Access(base.id, node, True, bool(held), qual))

    # reads: every self.attr load (coarse, flow-free)
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            a = _self_attr(node)
            if a is not None and a not in lock_attrs:
                accesses.append(_Access(a, node, False, False, qual))

    for stmt in fn.body:
        visit(stmt, [])
    return accesses, gmuts, edges, acquired


def _find_cycle(edges):
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(graph) | {b for bs in graph.values() for b in bs}}
    path = []

    def dfs(n):
        color[n] = GRAY
        path.append(n)
        for m in graph.get(n, ()):
            if color[m] == GRAY:
                return path[path.index(m):] + [m]
            if color[m] == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in list(color):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def run(modules):
    findings = []
    all_edges = []
    edge_sites = {}

    for mod in modules:
        module_locks = _module_locks(mod.tree)
        stats_globals = _module_stats_globals(mod.tree)
        classes = [n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.ClassDef)]
        infos = [_scan_class(c) for c in classes]
        has_concurrency = bool(module_locks) or any(
            i.thread_targets or i.lock_attrs for i in infos)
        if not has_concurrency:
            continue

        # per-function lock-nesting edges + per-function acquired sets
        fn_acquired = {}
        fn_edges = []
        fn_calls_under_lock = []
        mod_fns = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod_fns.setdefault(n.name, n)

        for info in infos:
            cls = info.name
            thread_fns = _thread_side(info)
            thread_ids = {id(f) for f in thread_fns}

            sides = {}   # attr -> {"thread": [...], "consumer": [...]}
            global_muts = []

            def collect(fn, side_label, qual):
                acc, gmuts, edges, acq = _scan_accesses(
                    fn, info.lock_attrs, module_locks, mod.relpath, cls,
                    stats_globals, qual)
                fn_acquired[qual] = acq
                for e in edges:
                    fn_edges.append((e, mod, fn.lineno))
                for a in acc:
                    sides.setdefault(a.attr, {"thread": [], "consumer": []})
                    sides[a.attr][side_label].append(a)
                global_muts.extend(gmuts)
                # calls under lock to same-module functions (one level)
                _calls_under(fn, module_locks, mod, cls, qual,
                             fn_calls_under_lock)

            for name, m in info.methods.items():
                if id(m) in thread_ids:
                    continue
                collect(m, "consumer", f"{cls}.{name}")
            for f in thread_fns:
                collect(f, "thread", f"{cls}.{f.name}")

            # rule: shared mutation off-lock across the thread boundary
            if info.thread_targets:
                for attr, byside in sorted(sides.items()):
                    t_acc = byside["thread"]
                    c_acc = byside["consumer"]
                    if not t_acc or not c_acc:
                        continue
                    for a in t_acc + c_acc:
                        if not a.mutation or a.locked:
                            continue
                        if a.fn_name.endswith(".__init__"):
                            continue
                        side = "thread" if a in t_acc else "consumer"
                        other = "consumer" if side == "thread" else "thread"
                        if mod.suppressed("lock-shared-mutation", a.line):
                            continue
                        findings.append(Finding(
                            "lock-shared-mutation", mod.relpath, a.line,
                            f"`self.{attr}` mutated on the {side} side of "
                            f"{cls}'s thread boundary without holding a "
                            f"lock, but also touched {other}-side — guard "
                            f"it with the class lock or baseline the "
                            f"handoff",
                            scope=a.fn_name, symbol=f"self.{attr}"))

            # rule: stats-global mutated off-lock in a concurrent module
            for g in global_muts:
                if g.locked or g.fn_name.endswith(".__init__"):
                    continue
                if mod.suppressed("lock-shared-mutation", g.line):
                    continue
                findings.append(Finding(
                    "lock-shared-mutation", mod.relpath, g.line,
                    f"module stats global `{g.attr}` mutated without its "
                    f"lock in a module with concurrency — dict `+=` is a "
                    f"read-modify-write and loses updates under "
                    f"contention",
                    scope=g.fn_name, symbol=g.attr))

        # module-level functions mutating stats globals off-lock
        for n in mod.tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                acc, gmuts, edges, acq = _scan_accesses(
                    n, set(), module_locks, mod.relpath, None,
                    stats_globals, n.name)
                fn_acquired[n.name] = acq
                for e in edges:
                    fn_edges.append((e, mod, n.lineno))
                _calls_under(n, module_locks, mod, None, n.name,
                             fn_calls_under_lock)
                for g in gmuts:
                    if g.locked:
                        continue
                    if mod.suppressed("lock-shared-mutation", g.line):
                        continue
                    findings.append(Finding(
                        "lock-shared-mutation", mod.relpath, g.line,
                        f"module stats global `{g.attr}` mutated without "
                        f"its lock in a module with concurrency",
                        scope=g.fn_name, symbol=g.attr))

        # one-level interprocedural edges: call under lock -> callee locks
        for held, callee, site_mod, line in fn_calls_under_lock:
            for lid in fn_acquired.get(callee, ()):
                if lid != held:
                    fn_edges.append(((held, lid), site_mod, line))

        for (a, b), m, line in fn_edges:
            all_edges.append((a, b))
            edge_sites.setdefault((a, b), (m.relpath, line))

    cyc = _find_cycle(all_edges)
    if cyc:
        first = edge_sites.get((cyc[0], cyc[1]), ("", 0))
        findings.append(Finding(
            "lock-order-cycle", first[0], first[1],
            "lock acquisition order cycle: " + " -> ".join(cyc) +
            " (two threads taking these locks in opposite orders deadlock)",
            scope="", symbol="->".join(sorted(set(cyc)))))
    return findings


def _calls_under(fn, module_locks, mod, cls_name, qual, out):
    """Record (held_lock, callee_name) for bare-name calls made while a
    known lock is held (one-level interprocedural ordering)."""

    def visit(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        if isinstance(node, ast.With):
            inner = list(held)
            for item in node.items:
                lid = _lock_expr_id(item.context_expr, mod.relpath,
                                    cls_name, module_locks)
                if lid is not None:
                    inner = inner + [lid]
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Call) and held:
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            else:
                a = _self_attr(node.func)
                if a is not None and cls_name:
                    name = f"{cls_name}.{a}"
            if name:
                for h in held:
                    out.append((h, name, mod, node.lineno))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, [])
