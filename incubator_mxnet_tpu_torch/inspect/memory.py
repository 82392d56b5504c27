"""mx.inspect.memory of the PyTorch port: memory observability.

Counterpart of `incubator_mxnet_tpu/inspect/memory.py`, over the CUDA
caching allocator and the tensors the port's subsystems register:

  * **Attributed census.** Subsystems `register(tensor_or_tree,
    owner="feed")` their long-lived buffers (the device feed's staging,
    the record iterator's batches, the KV slabs, a trainer's state), or
    wrap a region in `with tag("my_subsystem"):` so inner `register`
    calls inherit the owner. `census()` groups the bytes by owner, with
    an honest `untagged` remainder: on the card the allocator's
    `allocated_bytes.all.current` less the registered bytes, on the CPU
    the host tensors the garbage collector can see less the registered
    ones. Attribution is by registration, never inference. Bytes are
    storage bytes, each storage counted once (views share theirs).
    `census_diff(a, b)` is the leak detector's primitive, and
    `leakcheck(fn, rounds=N)` fails when untagged bytes grow on every
    round.

  * **OOM forensics.** `is_oom_error` recognises `torch.OutOfMemoryError`
    ("CUDA out of memory"), `MemoryError` and the JAX package's markers;
    `on_oom(error)` records it in the flight recorder and writes one JSON
    black box (the census, `torch.cuda.memory_stats()`, the card's free
    and total bytes, the flight-recorder ring) before the caller
    re-raises. The drivers (`run_resilient`, `serve.Server`, the
    continuous engine) call it through `telemetry.mem_on_oom`, and
    `install_oom_hook()` chains `sys.excepthook` so an uncaught OOM
    leaves the dump too.

  * **Memory plans.** The JAX package reads the buffer assignment of
    compiled XLA programs (`memory_plan`, `plan_from_compiled`,
    `assert_donation`, `collective_memory_plans`). The port compiles no
    program yet: those raise, naming the queue that brings one (ROADMAP
    A2/A3 for captured steps and exported buckets, A10 for collectives).

Owner names are flat `[a-z0-9_]+` tokens, as in the JAX package.
Knobs: `MXNET_MEM_SAMPLE_INTERVAL`, `MXNET_MEM_OOM_DUMP`,
`MXNET_MEM_CENSUS_DEPTH`.
"""
from __future__ import annotations

import contextvars
import gc
import json
import os
import re
import sys
import threading
import weakref
from collections import OrderedDict

import torch

from ..base import MXNetError, get_env
from ..telemetry import REGISTRY
from ..telemetry import trace as _trace

__all__ = [
    "memory_plan", "plan_from_compiled", "assert_donation",
    "collective_memory_plans", "active_plans", "note_plan",
    "tag", "register", "current_tag", "registered_count", "census",
    "census_diff", "leakcheck", "live_bytes", "MemoryLeakError",
    "is_oom_error", "on_oom", "oom_report", "dump_oom",
    "install_oom_hook",
]

# The knobs (the JAX package's names and defaults), read with their type
# and default at each use: MXNET_MEM_SAMPLE_INTERVAL (MemoryMonitor's
# interval, 0.05 s), MXNET_MEM_OOM_DUMP (unset or 1: dumps on, into
# MXNET_FLIGHTREC_DIR or the cwd; 0: off; else the dump directory),
# MXNET_MEM_CENSUS_DEPTH (shapes listed per owner, 5). They are not
# registered in `env_flags()`: the JAX package registers them only once its
# inspect package is imported, and the port's table stays a subset of the
# JAX package's on import.

# -- metrics (the JAX package's names) --------------------------------------
MEM_PLANS = REGISTRY.counter(
    "mem.plans", help="compiled-program memory plans computed")
MEM_CENSUS_RUNS = REGISTRY.counter(
    "mem.census_runs", help="live-buffer census passes")
MEM_TAGGED = REGISTRY.gauge(
    "mem.tagged_bytes", help="live device bytes attributed to a named "
    "owner in the most recent census")
MEM_UNTAGGED = REGISTRY.gauge(
    "mem.untagged_bytes", help="live device bytes with no registered "
    "owner in the most recent census")
MEM_OOM_DUMPS = REGISTRY.counter(
    "mem.oom_dumps", help="OOM black-box dump files written")


# ---------------------------------------------------------------------------
# memory plans: no compiled program in the port yet
# ---------------------------------------------------------------------------
_plans_lock = threading.Lock()
_ACTIVE_PLANS = OrderedDict()
_ACTIVE_PLANS_CAP = 32


def note_plan(name, plan):
    """Record `plan` in the active-plan table the OOM dump reports."""
    with _plans_lock:
        _ACTIVE_PLANS.pop(name, None)
        _ACTIVE_PLANS[name] = plan
        while len(_ACTIVE_PLANS) > _ACTIVE_PLANS_CAP:
            _ACTIVE_PLANS.popitem(last=False)


def active_plans():
    """{name: plan} of the plans noted in this process."""
    with _plans_lock:
        return dict(_ACTIVE_PLANS)


def _no_program(what):
    raise MXNetError(
        f"{what} reads the buffer assignment of a compiled XLA program; "
        f"the port compiles none yet (CUDA-graph capture of the steps and "
        f"the exported bucket programs are ROADMAP A2/A3)")


def plan_from_compiled(compiled, name="program"):
    """Raises: see the module docstring (ROADMAP A2/A3)."""
    _no_program("plan_from_compiled")


def memory_plan(obj, *args, name=None):
    """Raises: see the module docstring (ROADMAP A2/A3)."""
    _no_program("memory_plan")


def assert_donation(plan, params_bytes, slack=0.02):
    """Raises: see the module docstring (ROADMAP A2/A3)."""
    _no_program("assert_donation")


def collective_memory_plans():
    """Raises: the bucketed collectives are ROADMAP A10 in the port."""
    raise MXNetError("collective_memory_plans reads the kvstore's bucketed "
                     "collective programs; the port has no kvstore yet "
                     "(ROADMAP A10)")


# ---------------------------------------------------------------------------
# ownership registry + census
# ---------------------------------------------------------------------------
_OWNER_RE = re.compile(r"^[a-z0-9_]+$")
_reg_lock = threading.Lock()
_owned = {}          # id(tensor) -> (weakref, owner)
_tag_ctx = contextvars.ContextVar("mx_mem_tag", default=None)


class MemoryLeakError(MXNetError):
    """leakcheck() observed monotonically growing untagged live bytes."""


def _check_owner(owner):
    if not isinstance(owner, str) or not _OWNER_RE.match(owner):
        raise MXNetError(
            f"memory owner must be a flat [a-z0-9_]+ token (dots would "
            f"collide with the metric namespace), got {owner!r}")
    return owner


class tag:
    """`with mem.tag("my_subsystem"):` — ambient owner for `register`
    calls in the block (thread/context-local; nesting shadows)."""

    __slots__ = ("owner", "_token")

    def __init__(self, owner):
        self.owner = _check_owner(owner)
        self._token = None

    def __enter__(self):
        self._token = _tag_ctx.set(self.owner)
        return self

    def __exit__(self, *exc):
        _tag_ctx.reset(self._token)
        return False


def current_tag():
    """The ambient owner set by an enclosing `tag(...)`, or None."""
    return _tag_ctx.get()


def _register_leaf(t, owner):
    key = id(t)

    def _gone(ref, key=key):
        # only delete our entry: a recycled id may already belong to a
        # newer registration by the time this callback fires
        with _reg_lock:
            ent = _owned.get(key)
            if ent is not None and ent[0] is ref:
                del _owned[key]

    ref = weakref.ref(t, _gone)
    with _reg_lock:
        _owned[key] = (ref, owner)


def register(tree, owner=None):
    """Attribute `tree`'s tensors (tensors, NDArrays, Parameters, and
    dicts, lists and tuples of them) to `owner`, or to the ambient
    `tag(...)` owner. Idempotent and cheap: a weak reference per tensor;
    a dead tensor drops its entry, and registering again under a new
    owner overwrites. Returns `tree`. Odd leaves are skipped: attribution
    must not be able to break the subsystem it observes."""
    owner = _check_owner(owner if owner is not None
                         else (_tag_ctx.get() or _no_owner()))
    _walk_register(tree, owner)
    return tree


def _no_owner():
    raise MXNetError("register() needs owner= (or an enclosing "
                     "`with mem.tag(...):` block)")


def _walk_register(node, owner):
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        _register_leaf(node, owner)
        return
    if isinstance(node, dict) or hasattr(node, "items"):
        for v in node.values():
            _walk_register(v, owner)
        return
    if isinstance(node, (list, tuple)):
        for v in node:
            _walk_register(v, owner)
        return
    raw = getattr(node, "_t", None)          # an NDArray's tensor
    if isinstance(raw, torch.Tensor):
        _register_leaf(raw, owner)
        return
    data = getattr(node, "_data", None)      # a Parameter's tensor
    if isinstance(data, torch.Tensor):
        _register_leaf(data, owner)


def registered_count():
    """Live registry entries (a test and diagnostic aid)."""
    with _reg_lock:
        return len(_owned)


def _device(device):
    if device is None:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else torch.device("cpu"))
    dev = getattr(device, "torch_device", device)
    dev = dev if isinstance(dev, torch.device) else torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(t, dev):
    d = t.device
    return d.type == dev.type and (dev.type != "cuda" or d.index == dev.index)


def _storage(t):
    """(storage pointer, storage bytes) of a tensor: views share theirs."""
    s = t.untyped_storage()
    return s.data_ptr(), s.nbytes()


def _host_tensors():
    """Every CPU tensor the garbage collector can see."""
    return [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.device.type == "cpu"]


def live_bytes(device=None):
    """Bytes held on `device` (default the card, else the CPU): the
    allocator's `allocated_bytes.all.current` on the card; on the CPU the
    storages of the host tensors the garbage collector can see."""
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_stats(dev).get(
            "allocated_bytes.all.current", 0))
    seen = {}
    for t in _host_tensors():
        ptr, nb = _storage(t)
        seen[ptr] = nb
    return sum(seen.values())


def census(depth=None, device=None):
    """Group the bytes held on `device` (default the card, else the CPU)
    by registered owner.

    Returns a json-safe report::

        {"owners": {name: {"count", "bytes", "shapes": {repr: count}}},
         "total_bytes", "tagged_bytes", "untagged_bytes",
         "tagged_fraction", "n_arrays", "device"}

    Only registered tensors get a name; `untagged` is the rest of
    `live_bytes(device)`. `depth` bounds the distinct shapes listed per
    owner (`MXNET_MEM_CENSUS_DEPTH`; counts and bytes cover all)."""
    dev = _device(device)
    if depth is None:
        depth = get_env("MXNET_MEM_CENSUS_DEPTH", 5, typ=int)
    with _reg_lock:
        entries = list(_owned.values())
    owners = {}
    counted = set()
    tagged = n = 0
    for ref, owner in entries:
        t = ref()
        if t is None or not _on(t, dev):
            continue
        ptr, nb = _storage(t)
        if ptr in counted:
            continue
        counted.add(ptr)
        n += 1
        tagged += nb
        g = owners.setdefault(owner, {"count": 0, "bytes": 0, "shapes": {}})
        g["count"] += 1
        g["bytes"] += nb
        srep = f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
        if srep in g["shapes"] or len(g["shapes"]) < depth:
            g["shapes"][srep] = g["shapes"].get(srep, 0) + 1
    if dev.type == "cuda":
        total = max(live_bytes(dev), tagged)
        n_untagged = None
    else:
        rest = {}
        for t in _host_tensors():
            ptr, nb = _storage(t)
            if ptr not in counted:
                rest[ptr] = nb
        total = tagged + sum(rest.values())
        n_untagged = len(rest)
    untagged = total - tagged
    if untagged or n_untagged:
        owners["untagged"] = {"count": n_untagged or 0, "bytes": untagged,
                              "shapes": {}}
    ordered = OrderedDict(sorted(owners.items(),
                                 key=lambda kv: -kv[1]["bytes"]))
    MEM_CENSUS_RUNS.inc()
    MEM_TAGGED.set(tagged)
    MEM_UNTAGGED.set(untagged)
    return {"owners": ordered, "total_bytes": total,
            "tagged_bytes": tagged, "untagged_bytes": untagged,
            "tagged_fraction": round(tagged / total, 6) if total else 0.0,
            "n_arrays": n + (n_untagged or 0), "device": str(dev)}


def census_diff(before, after):
    """Per-owner growth between two census() reports: the leak
    detector's primitive. Positive `bytes` = grew."""
    owners = {}
    names = set(before["owners"]) | set(after["owners"])
    for name in sorted(names):
        a = before["owners"].get(name, {"count": 0, "bytes": 0})
        b = after["owners"].get(name, {"count": 0, "bytes": 0})
        db, dc = b["bytes"] - a["bytes"], b["count"] - a["count"]
        if db or dc:
            owners[name] = {"bytes": db, "count": dc}
    return {"owners": owners,
            "total_bytes": after["total_bytes"] - before["total_bytes"],
            "untagged_bytes": (after["untagged_bytes"]
                               - before["untagged_bytes"])}


def leakcheck(fn, rounds=4, raise_on_leak=True, min_growth_bytes=4096,
              device=None):
    """Run `fn()` `rounds` times and fail when untagged bytes on `device`
    grow on every round: the signature of a per-round leak (a dropped
    reference cycle, an accumulating cache, a buffer pinned per call).
    One warm-up call runs first and is not counted (first-call
    allocation is expected growth).

    Returns the report; with `raise_on_leak` (default) a leak raises
    `MemoryLeakError` carrying it. `min_growth_bytes` filters allocator
    jitter: total growth below it never fails."""
    if rounds < 2:
        raise MXNetError("leakcheck needs rounds >= 2")
    fn()                                     # warm-up: first-call allocs
    series_untagged, series_total = [], []
    baseline = census(device=device)
    for _ in range(rounds):
        fn()
        c = census(device=device)
        series_untagged.append(c["untagged_bytes"])
        series_total.append(c["total_bytes"])
    growth = series_untagged[-1] - baseline["untagged_bytes"]
    monotone = all(b > a for a, b in zip(series_untagged,
                                         series_untagged[1:]))
    leak = bool(monotone and growth >= min_growth_bytes)
    report = {"rounds": rounds, "leak": leak,
              "untagged_bytes": series_untagged,
              "total_bytes": series_total,
              "baseline_untagged_bytes": baseline["untagged_bytes"],
              "growth_bytes": int(growth),
              "growth_mb": round(growth / 2**20, 3),
              "per_round_bytes": int(growth / rounds)}
    if leak and raise_on_leak:
        err = MemoryLeakError(
            f"untagged live bytes grew monotonically across {rounds} "
            f"rounds (+{growth} bytes, ~{report['per_round_bytes']} "
            f"bytes/round) — something allocates per call and never "
            f"frees")
        err.report = report
        raise err
    return report


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------
# the JAX package's markers; "out of memory" also matches PyTorch's
# "CUDA out of memory. Tried to allocate ..."
_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory", "allocation failure")


def is_oom_error(error):
    """Does this exception look like a device or host OOM? True for
    `torch.OutOfMemoryError`, `MemoryError`, and a message with one of
    the JAX package's markers (XLA's RESOURCE_EXHAUSTED family, "out of
    memory", "allocation failure")."""
    if error is None:
        return False
    if isinstance(error, (MemoryError, torch.OutOfMemoryError)):
        return True
    msg = f"{type(error).__name__}: {error}".lower()
    return any(m in msg for m in _OOM_MARKERS)


def _oom_dump_dir():
    v = get_env("MXNET_MEM_OOM_DUMP", typ=str)
    if v and v not in ("0", "1"):
        return v
    d = _trace.FLIGHTREC._spool_dir()
    return d or "."


def _oom_dump_enabled():
    return get_env("MXNET_MEM_OOM_DUMP", typ=str) != "0"


def oom_report(error=None):
    """The black-box payload: the census, the active plans, the memory
    sample, the card's free / total bytes and `torch.cuda.memory_stats()`,
    and the flight-recorder ring. Each piece degrades on its own (a dump
    on the crash path must never raise)."""
    from .. import profiler as _profiler
    rep = {"pid": os.getpid(),
           "error": None if error is None else
           f"{type(error).__name__}: {error}"}
    try:
        rep["census"] = census()
    except Exception as e:
        rep["census_error"] = f"{type(e).__name__}: {e}"
    rep["plans"] = active_plans()
    try:
        sample, source = _profiler.read_memory_sample()
        rep["bytes_in_use"] = sample
        rep["memory_source"] = source
    except Exception:
        pass
    try:
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            rep["device_memory"] = {"free": int(free), "total": int(total),
                                    "known": True}
            rep["memory_stats"] = dict(torch.cuda.memory_stats())
    except Exception as e:
        rep["memory_stats_error"] = f"{type(e).__name__}: {e}"
    try:
        rep["flightrec"] = _trace.flightrec_events()
    except Exception:
        pass
    return rep


def dump_oom(error=None, path=None, reason="oom"):
    """Write the OOM black box as one JSON file; returns the path or None
    (crash-path code: never raises). Default location:
    `<dir>/oomdump-<pid>.json` under MXNET_MEM_OOM_DUMP / the flight
    recorder's dir / the cwd; the newest dump wins (atomic replace)."""
    try:
        rep = oom_report(error)
        rep["reason"] = reason
        if path is None:
            d = _oom_dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"oomdump-{os.getpid()}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rep, f, default=str)
        os.replace(tmp, path)
        MEM_OOM_DUMPS.inc()
        return path
    except Exception:
        return None


def on_oom(error, where=""):
    """The OOM handler the drivers call before re-raising: if `error` is
    an OOM (and dumps are on), record it in the flight recorder and write
    the black box. Returns the dump path, or None when the error is not
    an OOM or dumping is off. Never raises."""
    try:
        if not is_oom_error(error) or not _oom_dump_enabled():
            return None
        _trace.flightrec_record("oom", where or "oom",
                                error=str(error)[:400])
        _trace.flightrec_maybe_dump("oom")
        return dump_oom(error=error, reason=where or "oom")
    except Exception:
        return None


_hook_lock = threading.Lock()
_hook_installed = [False]


def install_oom_hook():
    """Idempotent: chain `sys.excepthook` so an uncaught OOM writes the
    black box on the way down. Armed by `run_resilient`, `Server` and the
    continuous engine next to the flight recorder's crash hooks."""
    with _hook_lock:
        if _hook_installed[0]:
            return
        _hook_installed[0] = True
    prev = sys.excepthook

    def _hook(tp, val, tb):
        try:
            on_oom(val, where="uncaught")
        except Exception:
            pass
        prev(tp, val, tb)

    sys.excepthook = _hook

