"""mx.profiler of the PyTorch port: Chrome-trace profiling, the stats
shims and the memory lane.

Counterpart of `incubator_mxnet_tpu/profiler.py` (≙ MXNet's
python/mxnet/profiler.py). Two layers:
  1. Framework events: `set_config` / `start` / `stop` record the port's
     spans and the user's Task / Frame / Event / Counter / Marker objects
     into an in-process buffer, dumped as Chrome tracing JSON (`dump`) or
     an aggregate table (`dumps`).
  2. Device events: on a machine with a card, `start()` also starts
     `torch.profiler` over the CUDA activity (CUPTI), and `stop()` takes
     its kernel and memcpy records, which `dump()` merges into the same
     trace on the port's clock (pid 1, one lane per stream). If CUPTI
     records nothing on the card, `dump()` raises: the port never passes
     host events off as a device trace. On the CPU, or with
     `set_config(profile_device=False)`, `start()` records host events
     only and `dump()` says so (`otherData.device_trace` false).

Memory: `read_memory_sample` reads the CUDA caching allocator's
`allocated_bytes.all.current` (host RSS on the CPU), `MemoryMonitor`
samples it on a thread into the trace's storage lane, and
`dump_storage_profile` writes the allocator's snapshot.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

from .base import MXNetError, get_env

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "state", "is_running", "record_event", "Task", "Frame", "Event",
           "Counter", "Domain", "Marker", "profiler_scope", "scope",
           "dispatch_stats", "serve_stats", "feed_stats", "io_stats",
           "fused_stats", "dump_storage_profile", "read_memory_sample",
           "MemoryMonitor"]

_lock = threading.Lock()
_events = []          # chrome trace events (host)
_device_events = []   # chrome trace events of the last device window
_state = {"running": False, "config": {}, "t0": None, "torch_prof": None,
          "device_trace": False}


def _now_us():
    """Event timestamp in microseconds on one process-wide monotonic
    clock (`perf_counter_ns`), shared by every thread, so events from the
    feeders and batchers interleave in happens-before order."""
    return time.perf_counter_ns() // 1000


def set_config(**kwargs):
    """≙ profiler.set_config(profile_all=, filename=, profile_device=...).
    `profile_device=False` keeps `start()` to host events on the card."""
    _state["config"].update(kwargs)


def _device_wanted():
    import torch
    return (_state["config"].get("profile_device", True)
            and torch.cuda.is_available())


# A device window's margin at each end. Kineto keeps a kernel record only
# when the kernel's start, put on the host clock, falls inside the window,
# and on an H100 those starts read up to milliseconds before the launch
# calls that made them (tools/torch_profiler_window.py): the kernels
# launched in a window's first milliseconds then had no record. A window
# therefore opens this long before its first launch and closes this long
# after its last kernel ends.
DEVICE_EDGE_S = 0.05


def open_device_window(prof):
    """Start `torch.profiler` object `prof` on an idle card, then wait out
    the window's edge (no wait without a card)."""
    import torch
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    prof.start()
    if on_card:
        time.sleep(DEVICE_EDGE_S)


def close_device_window(prof):
    """Stop `prof` once the card has finished its work and the window's
    edge has passed."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(DEVICE_EDGE_S)
    prof.stop()


@contextlib.contextmanager
def device_window(prof):
    """`with device_window(torch.profiler.profile(...)) as prof:` opens and
    closes `prof` as `open_device_window` / `close_device_window` do."""
    open_device_window(prof)
    try:
        yield prof
    finally:
        close_device_window(prof)


def start(profile_process="worker"):
    """≙ profiler.set_state('run'). On a card also starts `torch.profiler`
    over the CUDA activity."""
    if _state["running"]:
        return
    if _state["t0"] is None:
        _state["t0"] = _now_us()
    if _device_wanted() and _state["torch_prof"] is None:
        import torch
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        open_device_window(prof)
        # the two clocks at one instant: kineto's events carry unix-epoch
        # time, the port's events perf_counter time
        _state["torch_prof"] = (prof, time.time_ns() - time.perf_counter_ns())
    _state["running"] = True


def stop(profile_process="worker"):
    """≙ profiler.set_state('stop'). Stops `torch.profiler` (after a device
    synchronize and the window's edge) and keeps its kernel and memcpy
    records for `dump()`."""
    _state["running"] = False
    held = _state["torch_prof"]
    if held is None:
        return
    prof, epoch_minus_perf = held
    _state["torch_prof"] = None
    close_device_window(prof)
    events = _kineto_device_events(prof, epoch_minus_perf)
    with _lock:
        _device_events[:] = events
    _state["device_trace"] = True


def _kineto_device_events(prof, epoch_minus_perf):
    """The kernel, memcpy and memset records of a stopped torch.profiler,
    as Chrome events on the port's clock (pid 1, tid = the stream)."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mx_kineto_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts_ns = base_ns + float(e["ts"]) * 1e3
        out.append({"name": e["name"], "cat": e["cat"], "ph": "X",
                    "ts": (ts_ns - epoch_minus_perf) / 1e3,
                    "dur": float(e.get("dur", 0.0)), "pid": 1,
                    "tid": e.get("args", {}).get("stream", e.get("tid", 0)),
                    "args": {"device": e.get("args", {}).get("device")}})
    return out


def pause(profile_process="worker"):
    _state["running"] = False


def resume(profile_process="worker"):
    _state["running"] = True


def state():
    return "run" if _state["running"] else "stop"


def is_running():
    return _state["running"]


def record_event(name, category, dur_us, ts_us=None, args=None):
    """Internal hook: spans and the user objects call this while the
    profiler runs."""
    if not _state["running"]:
        return
    with _lock:
        _events.append({
            "name": name, "cat": category, "ph": "X",
            "ts": ts_us if ts_us is not None else _now_us(),
            "dur": dur_us, "pid": 0,
            "tid": threading.get_ident() % 100000,
            "args": args or {},
        })


def dump(finished=True, profile_process="worker", filename=None):
    """Write Chrome tracing JSON (≙ profiler.dump): the host events, the
    device records of the last window (when there was one), and the
    telemetry registry's snapshot under `otherData.telemetry`. Raises
    when the last window profiled the card and CUPTI recorded nothing."""
    fname = filename or _state["config"].get("filename", "profile.json")
    with _lock:
        host = list(_events)
        dev = list(_device_events)
    if _state["device_trace"] and not dev:
        raise MXNetError(
            "torch.profiler recorded no CUDA kernel in the last profiling "
            "window (is CUPTI available?); the port does not pass host "
            "events off as a device trace")
    from . import telemetry
    payload = {"traceEvents": host + dev, "displayTimeUnit": "ms",
               "otherData": {"telemetry": telemetry.snapshot(),
                             "device_trace": bool(_state["device_trace"])}}
    with open(fname, "w") as f:
        json.dump(payload, f)
    return fname


def dispatch_stats(reset=False):
    """Counters of the eager dispatch layer (`ops.registry`): dispatches
    and eager fallbacks. Always on; `reset=True` zeroes after the
    snapshot."""
    from .ops.registry import dispatch_stats as _ds
    return _ds(reset=reset)


def serve_stats(reset=False):
    """Process-wide serving counters of `serve` (requests, replies,
    rejected, shed, timeouts, batches, padded rows, decode counters)."""
    from .serve.metrics import serve_stats as _ss
    return _ss(reset=reset)


def feed_stats(reset=False):
    """Counters of the device feed (`io.DeviceFeed`): batches, H2D
    transfers, occupancy and the stall clocks."""
    from .io.device_feed import feed_stats as _fs
    return _fs(reset=reset)


def io_stats(reset=False):
    """Counters of the `ImageRecordIter` decode pipeline."""
    from .io import io_stats as _ios
    return _ios(reset=reset)


def fused_stats(reset=False):
    """Counters of the fused kernel tier (`ops.fused`): dispatches that
    launched a CUDA kernel (`pallas_calls`, the JAX package's name) and
    those that took the plain version on CPU tensors (`fallback_calls`)."""
    from .ops.fused import fused_stats as _fus
    return _fus(reset=reset)


def dumps(reset=False, format="table"):
    """Aggregate stats table (≙ profiler.dumps): the Chrome-trace event
    aggregate, the telemetry span aggregate (`span.duration_us` per span
    name, populated even when the event profiler never ran), and the
    registry's scalar snapshot. `format="json"` returns the same content
    as a JSON string."""
    with _lock:
        agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
        for e in _events + _device_events:
            a = agg[e["name"]]
            a[0] += 1
            a[1] += e["dur"]
            a[2] = min(a[2], e["dur"])
            a[3] = max(a[3], e["dur"])
        if reset:
            _events.clear()
            _device_events.clear()
            _state["device_trace"] = False
    from . import telemetry
    snap = telemetry.snapshot()
    spans = {k: v for k, v in snap.items()
             if k.startswith("span.duration_us")}
    scalars = {k: v for k, v in snap.items() if not isinstance(v, dict)}
    if format == "json":
        return json.dumps({
            "events": {name: {"calls": a[0], "total_us": a[1],
                              "min_us": (0.0 if a[0] == 0 else a[2]),
                              "max_us": a[3]}
                       for name, a in agg.items()},
            "telemetry": snap}, sort_keys=True)
    lines = [f"{'Name':<40}{'Calls':>8}{'Total(us)':>14}{'Min(us)':>12}"
             f"{'Max(us)':>12}",
             "-" * 86]
    for name, (calls, total, mn, mx) in sorted(agg.items(),
                                               key=lambda kv: -kv[1][1]):
        lines.append(f"{name[:39]:<40}{calls:>8}{total:>14.1f}{mn:>12.1f}"
                     f"{mx:>12.1f}")
    if spans:
        lines.append("")
        lines.append(f"{'Span (telemetry)':<40}{'Count':>8}"
                     f"{'Total(us)':>14}{'Min(us)':>12}{'Max(us)':>12}")
        lines.append("-" * 86)
        for name, h in sorted(spans.items(), key=lambda kv: -kv[1]["sum"]):
            lines.append(f"{name:<40}{h['count']:>8}{h['sum']:>14.1f}"
                         f"{h['min']:>12.1f}{h['max']:>12.1f}")
    if scalars:
        lines.append("")
        lines.append(f"{'Telemetry metric':<56}{'Value':>20}")
        lines.append("-" * 86)
        for name, v in sorted(scalars.items()):
            vv = f"{v:.1f}" if isinstance(v, float) else str(v)
            lines.append(f"{name:<56}{vv:>20}")
    return "\n".join(lines)


class Domain:
    """≙ profiler.Domain."""

    def __init__(self, name):
        self.name = name


class _Timed:
    def __init__(self, name, domain=None):
        self.name = name
        self.domain = domain
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is not None:
            record_event(self.name, type(self).__name__.lower(),
                         _now_us() - self._start, ts_us=self._start)
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Timed):
    """≙ profiler.Task."""


class Frame(_Timed):
    """≙ profiler.Frame."""


class Event(_Timed):
    """≙ profiler.Event."""


class Counter:
    """≙ profiler.Counter."""

    def __init__(self, domain, name, value=0):
        self.name = name
        self.value = value

    def set_value(self, value):
        self.value = value
        record_event(self.name, "counter", 0,
                     args={"value": value})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


class Marker:
    """≙ profiler.Marker (instant event)."""

    def __init__(self, domain, name):
        self.name = name

    def mark(self, scope="process"):
        record_event(self.name, "marker", 0)


class profiler_scope:
    """with profiler.scope('name'): annotate a region."""

    def __init__(self, name):
        self._task = Task(name)

    def __enter__(self):
        self._task.start()
        return self

    def __exit__(self, *exc):
        self._task.stop()


scope = profiler_scope


# ---------------------------------------------------------------------------
# storage lanes (≙ src/profiler/storage_profiler): the caching allocator's
# snapshot, and a sampled device-memory timeline
# ---------------------------------------------------------------------------
def dump_storage_profile(filename="memory.prof", device=None):
    """Write the CUDA caching allocator's snapshot (segments, blocks and,
    when `torch.cuda.memory._record_memory_history` ran, the allocation
    stacks) as a pickle, the format `torch.cuda.memory`'s viewer reads.
    ≙ storage_profiler's aggregate dump. Raises without a card."""
    import pickle
    import torch
    if not torch.cuda.is_available():
        raise MXNetError("dump_storage_profile needs a CUDA card: the CPU "
                         "has no caching allocator to snapshot")
    snap = torch.cuda.memory._snapshot(device)
    with open(filename, "wb") as f:
        pickle.dump(snap, f)
    return filename


def read_memory_sample(device=None):
    """One memory reading with its provenance: `(bytes_in_use, source)`.

    `source == "device"`: the CUDA caching allocator's
    `allocated_bytes.all.current` on `device` (default the current card).
    `source == "host_rss"`: no card (or a CPU device asked for), so the
    process RSS from `/proc/self/statm`, a host number that still moves
    with allocations. `source == "unavailable"`: neither worked (0)."""
    import torch
    dev = getattr(device, "torch_device", device)
    if dev is not None and not isinstance(dev, torch.device):
        dev = torch.device(dev)
    if torch.cuda.is_available() and (dev is None or dev.type == "cuda"):
        stats = torch.cuda.memory_stats(dev)
        return int(stats.get("allocated_bytes.all.current", 0)), "device"
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        import resource
        return rss_pages * resource.getpagesize(), "host_rss"
    except (OSError, ValueError, IndexError):
        return 0, "unavailable"


class MemoryMonitor:
    """Sampled memory timeline (≙ the storage profiler's
    MemoryManagerProfiler lane). Each sample lands in the Chrome trace as
    a counter event ('ph': 'C'), so `profiler.dump()` renders a memory
    lane beside the op events.

        with profiler.MemoryMonitor(interval=0.01):
            train()

    or `mon.start()` ... `mon.stop()` (which joins the thread). Samples
    are `(ts_us, bytes, source)` from `read_memory_sample`. Default
    interval: `MXNET_MEM_SAMPLE_INTERVAL`."""

    def __init__(self, interval=None, device=None):
        if interval is None:
            interval = get_env("MXNET_MEM_SAMPLE_INTERVAL", 0.05,
                               typ=float)
        self.interval = float(interval)
        self.device = device
        self.samples = []          # (ts_us, bytes_in_use, source)
        self.source = None         # stamp of the most recent sample
        self._stop = None
        self._thread = None

    def _read(self):
        from .telemetry.steptrace import _note_memory_sample
        b, source = read_memory_sample(self.device)
        self.source = source
        _note_memory_sample(b)
        return b, source

    def start(self):
        # handoff ordered by Thread start/join, not a lock: _stop and
        # samples are written before start() and read after join()
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                b, source = self._read()
                self.samples.append((_now_us(), b, source))
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mx-memory-monitor")
        self._thread.start()
        return self

    def stop(self):
        """Stop sampling, join the thread, and append the samples to the
        trace's storage lane (whether or not the op profiler runs: the
        caller asked for the lane)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        tid = threading.get_ident() % 100000
        with _lock:
            for ts, b, source in self.samples:
                _events.append({
                    "name": "device_memory", "cat": "storage", "ph": "C",
                    "ts": ts, "pid": 0, "tid": tid,
                    "args": {"bytes_in_use": b, "source": source},
                })

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def peak_bytes(self):
        return max((b for _, b, _src in self.samples), default=0)
