"""mx.inspect.report of the PyTorch port: offender attribution over
`torch.profiler`.

Counterpart of `incubator_mxnet_tpu/inspect/report.py`. The JAX package
ranks the fusions of a compiled XLA program; the port compiles none, so
`inspect_step(obj, *args)` runs the step and ranks what it launched:

  units            one launch site each: a launch of one of the port's
                   hand-written kernels (its cost from
                   `roofline.kernel_cost` at the launch's real shapes,
                   noted by the wrapper while an inspection runs), or one
                   aten op (flops by `torch.utils.flop_counter`'s formulas,
                   bytes its inputs plus its outputs), with the device time
                   of the kernels it launched. On the card an aten op that
                   launched nothing is no unit.
  offender_groups  units folded by class: `class_name` of the CUDA symbol
                   that took most of a unit's device time (template
                   arguments, `void`, the anonymous namespace and tile or
                   shape suffixes stripped), so the 53 launches of the
                   apply kernel in a ResNet-50 step are one class; the aten
                   op's name off the card.

Measured mode (`measured=True` or MXNET_INSPECT_MEASURED=1, on a card):
after a warm-up, `steps` calls run under `torch.profiler` (CPU and CUDA
activity). Each unit runs inside a profiler span (`mx_unit:<i>` around an
aten op, `mx_kernel:<j>` around a hand-written launch), and each device
record (kernel, memcpy, memset) goes to the span that holds its launch on
the host; records outside every span form one `unattributed` unit, whose
share is reported. The calls are folded into one: the n-th launch of an
op at one signature in each call is one launch site, with its mean device
time a call (`_units`). Each unit and group then carries its device ms and
its roofline share: its cold bound (`roofline.unit_bound`: every byte to
or from device memory; a hand-written kernel's is `kernel_cost`'s) over
the time it took. Off the card, or with measured mode off, the calls
still run (the units are what they launch) and the ranking is the cost
model's, `measured: false` with the reason.

A unit may run faster than its cold bound where the L2 served some of its
inputs or still held some of its outputs when it ended. Its floor
(`roofline.floor_bound`) is the least time even then: all its bytes
through the L2 at the L2's rate (measured on the card), and over device
memory all but what the L2 could hold at its start and at its end. The
report lists the units read over their cold bound under `l2_resident`,
each with both shares.

The report has the JAX package's keys less `cost_analysis` and
`model_vs_xla_flops` (there is no XLA cost analysis); its `memory` is
`inspect.memory.census()`'s report, since no compiled program has a
memory plan. `lower_any`, `inspect_compiled` and `inspect_hlo_text` raise.
"""
from __future__ import annotations

import bisect
import json
import re
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..base import MXNetError, _register_env, get_env
from ..telemetry import REGISTRY, span
from . import roofline as _roofline

__all__ = ["inspect_step", "inspect_compiled", "inspect_hlo_text",
           "render_markdown", "lower_any", "class_name", "dump_json",
           "INSPECT_RUNS", "INSPECT_UNITS"]

_register_env("MXNET_INSPECT_TOP_K", int, 10,
              "Offender-report depth: units and classes listed by "
              "inspect_step and tools/torch_offenders.py (totals always "
              "cover every unit)")
_register_env("MXNET_INSPECT_MEASURED", bool, False,
              "1 = inspect_step profiles its calls with torch.profiler on "
              "a card and attributes device time to each unit; off the "
              "card the report stays the cost model's (measured: false)")
_register_env("MXNET_INSPECT_CALIB", str, None,
              "Path to a roofline calibration JSON overriding the "
              "spec table of inspect.roofline")

INSPECT_RUNS = REGISTRY.counter(
    "inspect.runs", help="offender-attribution analyses performed")
INSPECT_UNITS = REGISTRY.counter(
    "inspect.units", help="kernel units (fusions/dots/convs) analyzed")
_TOP1 = REGISTRY.gauge(
    "inspect.top1_share", help="est. time share of the worst fusion in "
    "the most recent inspection")
_MEM_BYTES = REGISTRY.gauge(
    "inspect.memory_bound_byte_share", help="byte share in memory-bound "
    "units in the most recent inspection")
_MFU_CEIL = REGISTRY.gauge(
    "inspect.mfu_ceiling", help="roofline MFU ceiling of the most recent "
    "inspected program")

_NO_PROGRAM = ("the PyTorch port lowers no program: {what} has no "
               "counterpart; use inspect_step(step, *args), which runs the "
               "step and ranks what it launched")


def lower_any(obj, *args):
    raise MXNetError(_NO_PROGRAM.format(what="lower_any"))


def inspect_compiled(compiled, name="step", top_k=None, calib=None,
                     measured=None, execute=None):
    raise MXNetError(_NO_PROGRAM.format(what="inspect_compiled"))


def inspect_hlo_text(text, name="module", top_k=None, calib=None):
    raise MXNetError(_NO_PROGRAM.format(what="inspect_hlo_text (HLO)"))


# ---------------------------------------------------------------------------
# recording the aten ops of a call
# ---------------------------------------------------------------------------
# allocations that read nothing and write nothing yet
_NO_WORK = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "resize_"))


def _recorded(func, args, kwargs):
    """Whether a call is a unit of its own: an aten op (views and bare
    allocations left out), or one of the port's custom ops (`mxtorch::`)
    on host tensors. On the card a custom op's kernel launch notes itself
    (`ops.kernels._CAPTURE`), and the ops inside a custom op are never
    seen, so it passes through."""
    ns = getattr(func, "namespace", None)
    if ns == "aten":
        packet = getattr(func, "_overloadpacket", None)
        return not (getattr(func, "is_view", False)
                    or getattr(packet, "__name__", "") in _NO_WORK)
    return ns == "mxtorch" and not any(
        t.is_cuda for t in _roofline._tensors((args, kwargs)))


class _Recorder(TorchDispatchMode):
    """Notes every unit called inside it (`_recorded`) with its
    `roofline.aten_cost`; with `spans`, runs each inside a profiler span
    `mx_unit:<index>`. Dispatch modes ride along into autograd's backward
    threads."""

    def __init__(self, spans=False):
        super().__init__()
        self.records = []
        self.spans = spans
        self.call = 0
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _recorded(func, args, kwargs):
            return func(*args, **kwargs)
        with self._lock:
            idx = len(self.records)
            self.records.append(None)
        if self.spans:
            with torch.profiler.record_function(f"mx_unit:{idx}"):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        cost = _roofline.aten_cost(func, args, kwargs, out)
        self.records[idx] = {
            "op": func.name(), "overload": str(func), "call": self.call,
            "sig": tuple((tuple(a.shape), str(a.dtype))
                         for a in _roofline._tensors((args, kwargs))),
            "cost": cost}
        return out


# ---------------------------------------------------------------------------
# device records -> units
# ---------------------------------------------------------------------------
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_SPAN_RE = re.compile(r"^mx_(unit|kernel):(\d+)$")


def _attribute(events):
    """Device records of a chrome trace (`torch.profiler`'s export) by the
    span that holds their launch: returns ({("unit"|"kernel", index):
    [(symbol, device us), ...]}, [(symbol, us) of records outside every
    span]). A record's launch is the runtime call with its `correlation`;
    the span is the innermost `mx_unit:` / `mx_kernel:` host range on the
    launching thread that contains the call."""
    spans, launches, device = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            device.append((args.get("correlation"), name,
                           float(e.get("dur", 0.0))))
        elif cat in _LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (
                    (e.get("pid"), e.get("tid")), float(e["ts"]))
        elif not cat.startswith("gpu_"):
            m = _SPAN_RE.match(name)
            if m:
                ts = float(e["ts"])
                spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (ts, ts + float(e.get("dur", 0.0)), m.group(1),
                     int(m.group(2))))
    starts = {}
    for key, lst in spans.items():
        lst.sort()
        starts[key] = [s[0] for s in lst]
    owned, loose = {}, []
    for corr, name, dur in device:
        hit = None
        launch = launches.get(corr)
        if launch is not None:
            thread, ts = launch
            lst = spans.get(thread, ())
            i = bisect.bisect_right(starts.get(thread, ()), ts) - 1
            # the innermost range holding the call starts last: walk back
            # over the few ranges that could still contain it
            for j in range(i, max(i - 8, -1), -1):
                s0, s1, kind, idx = lst[j]
                if s0 <= ts <= s1:
                    hit = (kind, idx)
                    break
        if hit is None:
            loose.append((name, dur))
        else:
            owned.setdefault(hit, []).append((name, dur))
    return owned, loose


def _trace_events(prof):
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mx_inspect_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


# ---------------------------------------------------------------------------
# what to run
# ---------------------------------------------------------------------------
def _first_tensor_device(tree):
    for t in _roofline._tensors(tree):
        return t.device
    return None


def _runner(obj, args, device):
    """(zero-argument call of one step, its device, its default name)."""
    from ..device import resolve_device
    from ..gluon.contrib.estimator import Estimator
    from ..gluon.contrib.fused import FusedInferStep, FusedTrainStep
    from ..deploy import ExportedModel
    unwrap = [getattr(a, "_t", a) for a in args]
    if isinstance(obj, Estimator):
        batch = unwrap[0] if len(unwrap) == 1 else unwrap
        if not isinstance(batch, (list, tuple)) or len(batch) < 2:
            raise MXNetError("inspect_step(estimator, x, y) or "
                             "inspect_step(estimator, batch): a batch of "
                             "data and labels")
        x, y = batch[0], batch[1]
        est = obj

        def run():
            from .. import autograd
            with autograd.record():
                loss = est.loss(est.net(x), y).mean()
            loss.backward()
            est.trainer.step(x.shape[0])
        params = list(est.net.collect_params().values())
        dev = params[0].data().device if params and \
            params[0]._data is not None else _first_tensor_device(unwrap)
        return run, dev, "estimator_step"
    if isinstance(obj, ExportedModel):
        inputs = list(args) or [
            torch.zeros(s, dtype=getattr(torch, d), device=obj.device)
            for s, d in obj.input_specs]
        return (lambda: obj.run(*inputs)), obj.device, "exported_model"
    if isinstance(obj, (FusedTrainStep, FusedInferStep)):
        dev = obj._device
        if isinstance(obj, FusedInferStep) and not args:
            return (lambda: obj()), dev, type(obj).__name__
        return (lambda: obj(*args)), dev, type(obj).__name__
    if callable(obj):
        dev = _first_tensor_device(unwrap)
        if dev is None:
            dev = resolve_device(device)
        return (lambda: obj(*args)), dev, getattr(obj, "__name__",
                                                  type(obj).__name__)
    raise MXNetError(
        f"don't know how to inspect {type(obj).__name__}: pass a "
        "FusedTrainStep, FusedInferStep, deploy.ExportedModel, an Estimator "
        "with a batch, or a callable with its arguments")


def _sync(dev):
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _window(run, dev, steps, measured):
    """Run `steps` calls with the recorder and the kernels' capture on
    (under torch.profiler when `measured`). Returns (aten records, capture
    [(name, shape, call)], trace events or None, wall ms a call, launch
    counter deltas)."""
    from ..ops import kernels
    from .. import profiler as _mxprof
    if measured and _mxprof._state["torch_prof"] is not None:
        raise MXNetError("inspect_step: mx.profiler is running "
                         "torch.profiler; stop it before a measured "
                         "inspection")
    from torch.utils.flop_counter import flop_registry  # noqa: F401
    rec = _Recorder(spans=measured)
    cap, bounds = [], []
    prof = None
    before = kernels.launch_counts()
    _sync(dev)
    if measured:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _mxprof.open_device_window(prof)
    kernels._CAPTURE = cap
    t0 = time.perf_counter()
    try:
        with rec:
            for i in range(steps):
                rec.call = i
                run()
                bounds.append(len(cap))
        _sync(dev)
    finally:
        wall = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
        kernels._CAPTURE = None
        if prof is not None:
            _mxprof.close_device_window(prof)
    after = kernels.launch_counts()
    calls, k = [], 0
    for i, entry in enumerate(cap):
        while k < len(bounds) and i >= bounds[k]:
            k += 1
        calls.append(entry + (k,))
    events = _trace_events(prof) if prof is not None else None
    deltas = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    return rec.records, calls, events, wall, deltas


def _shape_json(shape):
    out = {}
    for k, v in shape.items():
        if isinstance(v, torch.dtype):
            v = str(v).replace("torch.", "")
        elif isinstance(v, torch.Tensor):
            v = v.tolist()
        out[k] = v
    return out


def _sig(kind, idx, records, calls):
    """What makes two launches in two calls one launch site: the op (or
    kernel) and the shapes and types it took."""
    if kind == "unit":
        return ("unit", records[idx]["overload"], records[idx]["sig"])
    name, shape = calls[idx][:2]
    return ("kernel", name, tuple(sorted(
        (k, str(v)) for k, v in shape.items() if k != "lengths")))


def _per_call(records, calls, steps):
    """Each call's units: ("unit", record index) for each op in order,
    then ("kernel", capture index) for each hand-written kernel's launch in
    order."""
    per_call = [[] for _ in range(steps)]
    for i, r in enumerate(records):
        if r is not None:
            per_call[r["call"]].append(("unit", i))
    for j, entry in enumerate(calls):
        per_call[min(entry[-1], steps - 1)].append(("kernel", j))
    return per_call


def _units(records, calls, owned, steps, measured):
    """The window's units folded over its calls: the n-th launch of one
    op at one signature in each call is one launch site. (Calls need not
    launch the same list: autograd copies a gradient into its buffer, or
    hands the buffer over, as reference counts fall.) A site's cost counts
    in the share of calls that launched it, its device time is the mean a
    call. Returns the units, the ops' then the kernels'."""
    per_call = _per_call(records, calls, steps)
    sites = {}
    for seq in per_call:
        seen = {}
        for kind, idx in seq:
            sig = _sig(kind, idx, records, calls)
            seen[sig] = seen.get(sig, 0) + 1
            sites.setdefault((sig, seen[sig]), []).append((kind, idx))
    units = []
    for keys in sites.values():
        kind, idx = keys[0]
        if kind == "unit":
            r = records[idx]
            cost = dict(r["cost"])
            base = {"name": f"{r['op']}#{idx}", "opcode": r["op"],
                    "op_name": r["overload"]}
        else:
            name, shape = calls[idx][:2]
            shape = dict(shape)
            if "lengths" in shape and hasattr(shape["lengths"], "tolist"):
                shape["lengths"] = shape["lengths"].tolist()
            cost = _roofline.kernel_cost(name, **shape)
            cost.setdefault("in_bytes", None)
            cost.setdefault("out_bytes", None)
            base = {"name": f"{name}#{idx}", "opcode": "mx_kernel",
                    "op_name": name, "kernel": name,
                    "shape": _shape_json(shape)}
        recs = [owned.get(k, []) for k in keys]
        if measured and kind == "unit" and not any(recs):
            continue       # launched nothing on the card
        share = len(keys) / steps
        for k in ("flops", "bytes", "in_bytes", "out_bytes"):
            if cost.get(k) is not None:
                cost[k] = cost[k] * share
        symbols = {}
        for rs in recs:
            for s, d in rs:
                symbols[s] = symbols.get(s, 0.0) + d
        base.update(cost=cost, calls=len(keys),
                    device_us=sum(d for rs in recs for _, d in rs) / steps,
                    records=sum(len(rs) for rs in recs) / steps,
                    symbols=sorted(symbols, key=symbols.get, reverse=True))
        units.append(base)
    return units


_TILE_RE = re.compile(r"_(?:tilesize)?\d+x\d+.*$")
_INSTANCE_RE = re.compile(r"\.(clone|remat|\d+)")


def _strip(text, open_, close):
    out, depth = [], 0
    for ch in text:
        if ch == open_:
            depth += 1
        elif ch == close and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def class_name(name):
    """De-instanced class of a kernel or unit name: a CUDA symbol loses
    `void`, the anonymous namespace, its parameter list, its template
    arguments and a tile or shape suffix (`_128x64...`,
    `_tilesize128x128x64...`), and, as in the JAX package, `.N`, `.clone`
    and `.remat` instance suffixes go, so every instance of one kernel
    reads as one class (`void (anonymous namespace)::
    scale_shift_act_kernel<__nv_bfloat16, 1, true>(...)` ->
    `scale_shift_act_kernel`)."""
    s = name.strip()
    s = re.sub(r"^void\s+", "", s)
    s = s.replace("(anonymous namespace)::", "")
    s = _strip(_strip(s, "(", ")"), "<", ">")
    s = _TILE_RE.sub("", s)
    s = _INSTANCE_RE.sub("", s)
    return s.strip()


def _records(units, calib, total_dev_us):
    out = []
    ridge0 = calib["ridge_flop_per_byte"]
    for u in units:
        cost = u["cost"]
        est, by, t_f, t_b = _roofline.unit_bound(cost, calib)
        floor, floor_by = _roofline.floor_bound(cost, calib)
        flops, nbytes = cost["flops"], cost["bytes"]
        intensity = flops / nbytes if nbytes else float("inf")
        ridge = (_roofline.peak_for(calib, cost.get("compute"))
                 / float(calib["peak_bytes_per_sec"])) or ridge0
        dev_ms = u["device_us"] / 1e3
        r = {
            "name": u["name"], "opcode": u["opcode"],
            "op_name": u["op_name"], "flops": flops, "bytes": nbytes,
            "in_bytes": cost.get("in_bytes"),
            "out_bytes": cost.get("out_bytes"), "transcendentals": 0.0,
            "compute": cost.get("compute"),
            "intensity": (round(intensity, 4)
                          if intensity != float("inf") else None),
            "bound": _roofline.classify(intensity, ridge),
            "bound_by": by, "est_time_s": est, "est_time_flops_s": t_f,
            "est_time_bytes_s": t_b,
            "floor_time_s": floor, "floor_by": floor_by,
            "device_ms": dev_ms,
            "roofline_share": (round(est * 1e3 / dev_ms, 6)
                               if dev_ms > 0 else None),
            "floor_share": (round(floor * 1e3 / dev_ms, 6)
                            if dev_ms > 0 else None),
            "device_share": (round(u["device_us"] / total_dev_us, 6)
                             if total_dev_us else None),
            "kernels": u["symbols"][:4],
            "device_records": u["records"], "calls": u["calls"],
            "class": class_name(u["symbols"][0] if u["symbols"] else
                                (u.get("kernel") or u["opcode"])),
        }
        if cost.get("bytes_only"):
            r["bytes_only"] = True
        if "kernel" in u:
            r["kernel"] = u["kernel"]
            r["shape"] = u["shape"]
        out.append(r)
    total = sum(r["est_time_s"] for r in out) or 1.0
    for r in out:
        r["time_share"] = round(r["est_time_s"] / total, 6)
    out.sort(key=lambda r: r["est_time_s"], reverse=True)
    return out


def _group_records(records, calib):
    """Aggregate unit records into ranked classes."""
    groups = {}
    for r in records:
        g = groups.get(r["class"])
        if g is None:
            g = groups[r["class"]] = {
                "class": r["class"], "opcode": r["opcode"], "count": 0,
                "flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
                "est_time_s": 0.0, "floor_time_s": 0.0, "device_ms": 0.0,
                "example": r["name"],
                "example_op_name": r["op_name"],
                "compute": r["compute"]}
        g["count"] += 1
        g["flops"] += r["flops"]
        g["bytes"] += r["bytes"]
        g["est_time_s"] += r["est_time_s"]
        g["floor_time_s"] += r["floor_time_s"]
        g["device_ms"] += r["device_ms"]
    out = list(groups.values())
    total = sum(g["est_time_s"] for g in out) or 1.0
    for g in out:
        intensity = g["flops"] / g["bytes"] if g["bytes"] else float("inf")
        ridge = (_roofline.peak_for(calib, g["compute"])
                 / float(calib["peak_bytes_per_sec"]))
        g["intensity"] = (round(intensity, 4)
                          if intensity != float("inf") else None)
        g["bound"] = _roofline.classify(intensity, ridge)
        g["time_share"] = round(g["est_time_s"] / total, 6)
        g["roofline_share"] = (round(g["est_time_s"] * 1e3 / g["device_ms"],
                                     6) if g["device_ms"] > 0 else None)
        g["floor_share"] = (round(g["floor_time_s"] * 1e3 / g["device_ms"],
                                  6) if g["device_ms"] > 0 else None)
    out.sort(key=lambda g: g["est_time_s"], reverse=True)
    return out


def _totals(records, ridge, unattributed_us):
    dev_ms = sum(r["device_ms"] for r in records)
    un_ms = unattributed_us / 1e3
    nbytes = sum(r["bytes"] for r in records)
    return {
        "units": len(records),
        "flops": sum(r["flops"] for r in records),
        "bytes": nbytes,
        "est_time_s": sum(r["est_time_s"] for r in records),
        "floor_time_s": sum(r["floor_time_s"] for r in records),
        "memory_bound_units": sum(1 for r in records
                                  if r["bound"] == "memory"),
        "memory_bound_byte_share": round(
            sum(r["bytes"] for r in records if r["bound"] == "memory")
            / max(nbytes, 1.0), 6),
        "ridge_flop_per_byte": round(ridge, 3),
        "device_ms": dev_ms,
        "unattributed_ms": un_ms,
        "unattributed_share": (round(un_ms / (dev_ms + un_ms), 6)
                               if dev_ms + un_ms > 0 else None),
    }


def _mfu_ceiling(totals, calib):
    t = totals["est_time_s"]
    if not t or not totals["flops"]:
        return 0.0
    return round(totals["flops"] / t / float(calib["peak_flops"]), 6)


def _byte_coverage(groups, k, totals):
    if not totals["bytes"]:
        return 0.0
    return round(sum(g["bytes"] for g in groups[:k]) / totals["bytes"], 6)


# the L2's rate measured on each card in this process (`roofline.
# measure_l2_rate`), for calibrations that leave it None
_L2_RATES = {}
_L2_LOCK = threading.Lock()


def _with_l2(calib, dev):
    """`calib` with the L2's size and rate: its own, else the platform
    row's; a rate still unknown is measured on the card (once a process)
    or the host row's off it."""
    platform = "gpu" if dev.type == "cuda" else "cpu"
    row = _roofline.DEFAULT_CALIBRATIONS[platform]
    calib = dict(calib)
    for key in ("l2_bytes", "l2_bytes_per_sec"):
        if not calib.get(key):
            calib[key] = row[key]
    if calib["l2_bytes_per_sec"]:
        return calib
    key = dev.index or 0
    with _L2_LOCK:
        if key not in _L2_RATES:
            _L2_RATES[key] = _roofline.measure_l2_rate(dev)
        rate = _L2_RATES[key]
    return dict(calib, l2_bytes_per_sec=rate,
                l2_source="measured (roofline.measure_l2_rate)")


def _l2_resident(recs, top_k):
    """The units read over their cold bound (faster than device memory
    could feed them: the L2 served or held some of their bytes), each with
    its cold and floor shares."""
    over = sorted((r for r in recs if (r["roofline_share"] or 0) > 1.0),
                  key=lambda r: -r["roofline_share"])
    keys = ("name", "class", "bytes", "device_ms", "roofline_share",
            "floor_share", "floor_by")
    return {"over_cold_bound": len(over),
            "units": [{k: r[k] for k in keys} for r in over[:top_k]]}


def inspect_step(obj, *args, name=None, top_k=None, calib=None,
                 measured=None, steps=3, device=None):
    """Offender report for one step (see the module docstring). `obj`: a
    `FusedTrainStep` / `FusedInferStep` (called with `args`), a
    `deploy.ExportedModel` (run on `args`, or on zeros of its input specs),
    an `Estimator` with a batch (`args` = x, y: one record / backward /
    `trainer.step`, as `fit` runs a batch), or any callable with its
    arguments. The calls really run: one first, to warm up, then `steps`
    inside the window (a training step trains). json.dumps-safe."""
    if top_k is None:
        top_k = get_env("MXNET_INSPECT_TOP_K", 10, typ=int)
    if measured is None:
        measured = get_env("MXNET_INSPECT_MEASURED", False, typ=bool)
    run, dev, default_name = _runner(obj, args, device)
    dev = torch.device(dev) if dev is not None else torch.device("cpu")
    on_card = dev.type == "cuda"
    if calib is None:
        calib = _roofline.load_calibration(
            platform="gpu" if on_card else "cpu")
    calib = _with_l2(calib, dev)
    steps = max(1, int(steps))
    run()
    profiled = bool(measured) and on_card
    records, calls, events, wall_ms, deltas = _window(run, dev, steps,
                                                      profiled)
    with span("inspect.analyze", target=name or default_name):
        owned, loose = _attribute(events) if profiled else ({}, [])
        units = _units(records, calls, owned, steps, profiled)
        loose_us = sum(d for _, d in loose) / steps
        total_dev_us = sum(u["device_us"] for u in units) + loose_us
        recs = _records(units, calib, total_dev_us)
        groups = _group_records(recs, calib)
        totals = _totals(recs, calib["ridge_flop_per_byte"], loose_us)
        from . import memory as _memory
        census = _memory.census(device=dev)
    kernel_records = {}
    for (kind, idx), rs in owned.items():
        if kind == "kernel":
            kname = calls[idx][0]
            kernel_records[kname] = kernel_records.get(kname, 0) + len(rs)
    loose_classes = {}
    for s, d in loose:
        c = class_name(s)
        loose_classes[c] = loose_classes.get(c, 0.0) + d / steps / 1e3
    report = {
        "name": name or default_name,
        "platform": "gpu" if on_card else "cpu",
        "n_units": totals["units"],
        "top_k": top_k,
        "ranking": "est_time",
        "bytes_estimated": totals["bytes"] > 0,
        "calibration": {
            "peak_flops": calib["peak_flops"],
            "peak_bytes_per_sec": calib["peak_bytes_per_sec"],
            "ridge_flop_per_byte": calib["ridge_flop_per_byte"],
            "source": calib.get("source", "unknown"),
            "name": calib.get("name"),
            "peak_flops_by_type": calib.get("peak_flops_by_type"),
            "l2_bytes": calib["l2_bytes"],
            "l2_bytes_per_sec": calib["l2_bytes_per_sec"],
            "l2_source": calib.get("l2_source", calib.get("source")),
        },
        "totals": totals,
        "memory": census,
        "offenders": recs[:top_k],
        "units": recs,
        "n_groups": len(groups),
        "offender_groups": groups[:top_k],
        "offender_top1_share": groups[0]["time_share"] if groups else 0.0,
        "memory_bound_byte_share": totals["memory_bound_byte_share"],
        "est_step_mfu_ceiling": _mfu_ceiling(totals, calib),
        "top10_byte_coverage": _byte_coverage(groups, 10, totals),
        "topk_byte_coverage": _byte_coverage(groups, top_k, totals),
        "topk_time_coverage": round(
            sum(g["time_share"] for g in groups[:top_k]), 6),
        "l2_resident": _l2_resident(recs, top_k),
        "measured": profiled,
        "measured_wall_ms": round(wall_ms, 3),
        "window": {"calls": steps,
                   "launch_counts": deltas,
                   "kernel_records": kernel_records,
                   "kernel_units": sum(1 for r in recs
                                       if r["opcode"] == "mx_kernel")},
        "unattributed": {"name": "unattributed",
                         "device_ms": loose_us / 1e3,
                         "share": totals["unattributed_share"],
                         "records": len(loose),
                         "classes": dict(sorted(
                             loose_classes.items(), key=lambda kv: -kv[1])[
                                 :10])},
        "device": str(dev),
    }
    if not profiled:
        report["measured_unavailable_reason"] = (
            "no CUDA device" if not on_card else
            "measured mode off (measured=False, MXNET_INSPECT_MEASURED=0)")
    INSPECT_RUNS.inc()
    INSPECT_UNITS.inc(totals["units"])
    _TOP1.set(report["offender_top1_share"])
    _MEM_BYTES.set(report["memory_bound_byte_share"])
    _MFU_CEIL.set(report["est_step_mfu_ceiling"])
    return report


def _share(v):
    return "-" if v is None else f"{v * 100:.1f}%"


def render_markdown(report):
    """Human-readable offender table (what `tools/torch_offenders.py`
    prints): the JAX package's sections, each table with the measured
    device ms and roofline share beside the model's columns."""
    lines = []
    cal = report["calibration"]
    lines.append(f"# Offender attribution — {report['name']} "
                 f"({report['platform']})")
    lines.append("")
    lines.append(
        f"Roofline: peak {cal['peak_flops'] / 1e12:.1f} TFLOP/s, "
        f"{cal['peak_bytes_per_sec'] / 1e9:.1f} GB/s "
        f"(ridge {cal['ridge_flop_per_byte']:.1f} FLOP/B, "
        f"calibration: {cal['source']})")
    t = report["totals"]
    lines.append(
        f"Program: {t['units']} kernel units, "
        f"{t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.2f} MB moved, "
        f"{t['memory_bound_units']} memory-bound units "
        f"({report['memory_bound_byte_share'] * 100:.1f}% of bytes)")
    lines.append(
        f"MFU ceiling for this fusion structure: "
        f"{report['est_step_mfu_ceiling']:.3f}  |  top-1 class share: "
        f"{report['offender_top1_share'] * 100:.1f}%  |  measured: "
        f"{report['measured']}")
    if report["measured"]:
        lines.append(
            f"Device time a call: {t['device_ms']:.3f} ms in units, "
            f"{t['unattributed_ms']:.3f} ms unattributed "
            f"({_share(t['unattributed_share'])})")
        top = max((u["floor_share"] or 0.0 for u in report["units"]),
                  default=None)
        lines.append(
            f"L2: {report['l2_resident']['over_cold_bound']} units ran "
            f"faster than device memory could feed them (the L2 served or "
            f"held some of their bytes); against their floor (every byte "
            f"through the L2 at {cal['l2_bytes_per_sec'] / 1e12:.2f} TB/s) "
            f"the highest share is {_share(top)}")
    else:
        lines.append(f"Not measured: "
                     f"{report.get('measured_unavailable_reason', '')}")
    lines.append("")
    lines.append(f"## Offender classes ({report['n_groups']} total)")
    lines.append("")
    lines.append("| # | fusion class | op | n | bound | GFLOP | MB | "
                 "FLOP/B | time share | device ms | roofline share |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for i, g in enumerate(report["offender_groups"], 1):
        inten = ("inf" if g["intensity"] is None
                 else f"{g['intensity']:.1f}")
        lines.append(
            f"| {i} | `{g['class'][:64]}` | {g['opcode']} | {g['count']} | "
            f"{g['bound']} | {g['flops'] / 1e9:.3f} | "
            f"{g['bytes'] / 1e6:.3f} | {inten} | "
            f"{g['time_share'] * 100:.1f}% | {g['device_ms']:.4f} | "
            f"{_share(g['roofline_share'])} |")
    lines.append("")
    lines.append(
        f"Top-{report['top_k']} classes cover "
        f"{report['topk_time_coverage'] * 100:.1f}% of estimated time, "
        f"{report['topk_byte_coverage'] * 100:.1f}% of bytes "
        f"(top-10: {report['top10_byte_coverage'] * 100:.1f}%).")
    lines.append("")
    lines.append("## Worst individual kernel units")
    lines.append("")
    lines.append("| # | unit | op | bound | GFLOP | MB | FLOP/B | "
                 "time share | source op | device ms | roofline share |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for i, r in enumerate(report["offenders"], 1):
        inten = ("inf" if r["intensity"] is None
                 else f"{r['intensity']:.1f}")
        src = (r["op_name"] or "")[-48:]
        lines.append(
            f"| {i} | `{r['name']}` | {r['opcode']} | {r['bound']} | "
            f"{r['flops'] / 1e9:.3f} | {r['bytes'] / 1e6:.3f} | {inten} | "
            f"{r['time_share'] * 100:.1f}% | `{src}` | "
            f"{r['device_ms']:.4f} | {_share(r['roofline_share'])} |")
    return "\n".join(lines)


def dump_json(report, path):
    """Write the report as JSON atomically (`fault.atomic_output`: a temp
    file renamed over `path`)."""
    from ..fault import atomic_output
    with atomic_output(path, mode="w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=str)
