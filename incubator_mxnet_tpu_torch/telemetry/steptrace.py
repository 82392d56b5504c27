"""Step-timeline attribution of the PyTorch port: spans, the per-step
breakdown, and MFU from counted FLOPs.

Counterpart of `incubator_mxnet_tpu/telemetry/steptrace.py`:

  * `span(name, **attrs)`: a nesting-aware tracer over the trace
    ContextVar (`telemetry.trace`), so nesting follows `trace.attach(ctx)`
    across thread hops. Every span lands in the profiler's Chrome-trace
    buffer while it runs (cat "span", its parent's name in args), in the
    registry histogram `span.duration_us{name=...}` and counter
    `span.count{name=...}`, and in the flight recorder.

  * `StepTimeline`: where a loop's time went, data stall against compute
    against H2D staging, read from the live `feed` counters around each
    step, with the memory high-water of each step and, given
    `flops_per_step`, MFU against `device_peak_flops()`.

  * `cost_flops` / `model_flops` / `block_fwd_flops`: the MFU numerator.
    The JAX package reads XLA's cost analysis of a lowered program; the
    port has no lowered program, so it counts with
    `torch.utils.flop_counter.FlopCounterMode` over one real call on the
    device the arguments (or the block) live on. Both count a
    multiply-add as 2. FlopCounterMode counts matrix products,
    convolutions and attention, and no elementwise work, which XLA also
    counts: on matmul-dominated nets the two agree closely.

Attribution: `data_stall_us` is time the consumer provably waited on an
empty feed buffer inside the step window; `h2d_stage_us` is the feeder's
staging time, overlapped with compute, reported and never subtracted;
`compute_us` is the rest. The collective lanes (`allreduce_us`,
`reduce_scatter_us`, `allgather_us`) stay in the report at zero until the
port has a kvstore (ROADMAP A10).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

from ..base import MXNetError
from .registry import REGISTRY
from . import trace as _trace

__all__ = ["span", "current_span", "record_span", "StepTimeline",
           "model_flops", "block_fwd_flops", "cost_flops",
           "device_peak_flops", "SPAN_DURATION", "SPAN_COUNT"]

# one histogram family for every span name: static registration (lint +
# docs cover it), dynamic span names become label values, not new metrics
SPAN_DURATION = REGISTRY.histogram(
    "span.duration_us", help="telemetry.span durations by span name",
    labels=("name",))
SPAN_COUNT = REGISTRY.counter(
    "span.count", help="telemetry.span completions by span name",
    labels=("name",))

# process-wide memory high-water over every StepTimeline/MemoryMonitor
# sample; the python cell avoids a locked gauge read per step
MEM_PEAK = REGISTRY.gauge(
    "mem.peak_hbm_bytes", help="high-water bytes_in_use across every "
    "step-timeline / memory-monitor sample this process took "
    "(source per profiler.read_memory_sample: device HBM, or host RSS "
    "on backends without memory_stats)")
_mem_peak_seen = [0]


def _note_memory_sample(b):
    if b > _mem_peak_seen[0]:
        _mem_peak_seen[0] = b
        MEM_PEAK.set(b)

_enabled = _trace.enabled


# span name -> (bound duration histogram, bound counter): the label-value
# resolution is a dict+tuple build per call — memoized off the hot path
# (span names are a small closed set; labeled children are never removed)
_bound_memo = {}

# flight-recorder duration floor for CLOSED spans (see record_span): only
# spans at least this long are black-box-worthy; span_open events are
# never floored
FLIGHTREC_SPAN_FLOOR_US = 50_000.0


def current_span():
    """Name of the innermost open span on this execution context (follows
    an attached TraceContext across thread hops), or None."""
    ctx = _trace.current_context()
    return ctx.name if ctx is not None else None


def record_span(name, dur_us, ts_us=None, cat="span", ctx=None, **attrs):
    """Record an externally-timed span: the one implementation behind
    every Chrome-trace lane (`serve.batch`, `io.feed`, `feed.stage`, and
    `with span(...)` itself). Feeds the `span.duration_us{name=...}`
    histogram always (when telemetry is on), the flight-recorder ring,
    and the profiler's Chrome-trace buffer when the profiler is running.

    Trace linkage: pass `ctx` (a TraceContext) to record AS that node of
    a request tree; with no `ctx`, the ambient `trace.current_context()`
    — if any — becomes the parent and a fresh child id is minted. Either
    way the trace/span/parent ids land in the event args, so the
    cross-thread tree reassembles from the exported trace JSON."""
    if not _enabled():
        return
    bounds = _bound_memo.get(name)
    if bounds is None:
        bounds = _bound_memo[name] = (SPAN_DURATION.labels(name=name),
                                      SPAN_COUNT.labels(name=name))
    bounds[0].observe(dur_us)
    bounds[1].inc()
    if ctx is None:
        ambient = _trace.current_context()
        if ambient is not None:
            ctx = _trace.child_context(ambient, name)
    if ctx is not None:
        attrs.setdefault("trace_id", ctx.trace_id)
        attrs.setdefault("span_id", ctx.span_id)
        if ctx.parent_span_id is not None:
            attrs.setdefault("parent_span_id", ctx.parent_span_id)
        if ctx.parent_name is not None:
            attrs.setdefault("parent", ctx.parent_name)
        _trace.TRACE_STATS["spans"] += 1      # lock-free by design
    if dur_us >= FLIGHTREC_SPAN_FLOOR_US:
        # duration floor: step/request-scale spans are black-box-worthy;
        # sub-50ms spans at thousands/sec would evict the interesting
        # history from the bounded ring in well under a second (and cost
        # a spool write each when MXNET_FLIGHTREC_DIR is set). Span OPEN
        # events (the in-flight marker) are not floored — only `span`
        # class entries emit them, at step scale.
        _trace.flightrec_record("span", name, dur_us=round(dur_us, 1),
                                **attrs)
    # cached module ref, not `from .. import profiler`: record_span runs
    # per batch on the serving path and the import machinery costs ~1us
    # + import-lock traffic per call
    if _trace._profiler_running():
        _trace._profiler_mod[0].record_event(name, cat, dur_us,
                                             ts_us=ts_us, args=attrs)


class span:
    """`with telemetry.span("train.step", step=n):` — time a region.

    Nesting is tracked through the trace ContextVar: entering mints a
    child `TraceContext` of whatever is current (starting a new trace at
    the root, subject to MXNET_TRACE_SAMPLE), so the Chrome-trace event
    carries the enclosing span's name in `args["parent"]` PLUS the
    trace/span/parent ids, and — after `trace.attach(ctx)` on a worker
    thread — nesting survives thread hops. The registry histogram
    `span.duration_us{name=...}` aggregates durations, and the open/close
    pair feeds the flight recorder (an in-flight span at process death is
    named by its `span_open` spool line). A span is cheap when
    `MXNET_TELEMETRY=0` (no clock reads, no records). Reentrant and
    exception-safe (the span closes on the error path too: ContextVar
    tokens reset correctly even when an inner span leaked open, so traces
    stay balanced)."""

    __slots__ = ("name", "attrs", "_t0", "_parent", "_armed", "_dur",
                 "_ctx", "_token")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self._parent = None
        self._armed = False
        self._dur = None
        self._ctx = None
        self._token = None

    def __enter__(self):
        self._armed = _enabled()
        if not self._armed:
            return self
        from .. import profiler
        raw = _trace._raw_context()
        if raw is _trace.NOT_SAMPLED:
            # inside a sampled-out trace: inherit the decision — minting
            # a fresh root per inner span would fill the Chrome trace
            # with orphan mid-request fragments and count one "trace"
            # per span (head sampling samples TREES, not spans)
            self._parent = None
            self._ctx = None
        else:
            self._parent = raw.name if raw is not None else None
            self._ctx = _trace.child_context(raw, self.name)
            if self._ctx is not None:
                self._token = _trace._push(self._ctx)
                _trace.flightrec_record("span_open", self.name,
                                        **self.attrs)
            elif raw is None:
                # root draw came up sampled-out: mark the subtree
                self._token = _trace._push(_trace.NOT_SAMPLED)
        self._t0 = profiler._now_us()
        return self

    def __exit__(self, *exc):
        if not self._armed:
            return False
        from .. import profiler
        t1 = profiler._now_us()
        if self._token is not None:
            _trace._reset(self._token)
            self._token = None
        attrs = dict(self.attrs)
        if self._parent is not None:
            attrs["parent"] = self._parent
        self._dur = t1 - self._t0
        record_span(self.name, self._dur, ts_us=self._t0, ctx=self._ctx,
                    **attrs)
        return False

    @property
    def duration_us(self):
        """Set only after exit (None while open or telemetry disabled)."""
        return self._dur

    @property
    def context(self):
        """The span's TraceContext (None before entry, when telemetry is
        off, or when the root was sampled out)."""
        return self._ctx


def _stall_counters():
    """One consistent read of the counters a step window diffs: the feed's
    stall and staging clocks. The collective lanes read zero: the port
    has no kvstore yet (ROADMAP A10)."""
    out = {"data_stall_us": 0.0, "h2d_stage_us": 0.0, "host_transfers": 0,
           "allreduce_us": 0.0, "allreduce_buckets": 0,
           "reduce_scatter_us": 0.0, "reduce_scatter_buckets": 0,
           "allgather_us": 0.0, "allgather_buckets": 0}
    from ..io.device_feed import feed_stats
    f = feed_stats()
    out["data_stall_us"] = f.get("stall_data_us", 0.0)
    out["h2d_stage_us"] = f.get("stage_us", 0.0)
    out["host_transfers"] = f.get("host_transfers", 0)
    return out


class StepTimeline:
    """Per-step time attribution over a training (or serving) loop.

    ::

        tl = telemetry.StepTimeline(flops_per_step=fl, peak_flops=peak)
        for batch in feed:
            with tl.step():
                loss = train_step(*batch)
        report = tl.report()
        # {'steps', 'total_us', 'data_stall_us', 'compute_us',
        #  'h2d_stage_us', 'allreduce_us', 'stall_pct', 'compute_pct',
        #  'mfu', 'achieved_flops_per_sec', ...}

    Attribution runs over the LOOP WINDOW — first `step()` entry to the
    latest `step()` exit — with the cross-subsystem counters (DeviceFeed
    stall clock, kvstore allreduce clock) diffed continuously across it.
    That window deliberately includes the time BETWEEN steps, because that
    is where a `for batch in feed:` loop blocks on data — a per-step-only
    window would attribute an input-bound loop as pure compute. The report
    divides:

      data_stall_us   consumer blocked on an empty feed buffer (input-bound)
      allreduce_us, reduce_scatter_us, allgather_us
                      collective dispatch time (zero until ROADMAP A10)
      compute_us      total - data_stall - allreduce - reduce_scatter -
                      allgather (the device side)
      h2d_stage_us    feeder staging incl. async H2D dispatch — overlapped
                      work, reported for visibility, never subtracted
      step_time_us    sum of the in-step spans (loop-body time only)

    MFU = flops_per_step * steps / total_seconds / peak_flops.
    """

    def __init__(self, flops_per_step=None, peak_flops=None,
                 name="train.step"):
        self.name = name
        self.flops_per_step = flops_per_step
        self.peak_flops = (peak_flops if peak_flops is not None
                           else device_peak_flops())
        self.steps = 0
        self.step_time_us = 0.0
        # memory lane: per-step-exit bytes_in_use samples, high-water
        # over the loop window (profiler.read_memory_sample provenance:
        # "device" on the card, "host_rss" on the CPU)
        self.peak_hbm_bytes = 0
        self.mem_source = None
        self.deltas = {"data_stall_us": 0.0, "h2d_stage_us": 0.0,
                       "allreduce_us": 0.0, "host_transfers": 0,
                       "allreduce_buckets": 0,
                       "reduce_scatter_us": 0.0,
                       "reduce_scatter_buckets": 0,
                       "allgather_us": 0.0, "allgather_buckets": 0}
        self._base = None        # counters at first step entry
        self._t_first = None
        self._t_last = None

    class _Step:
        __slots__ = ("tl", "span")

        def __init__(self, tl):
            self.tl = tl
            self.span = span(tl.name, step=tl.steps)

        def __enter__(self):
            from .. import profiler
            tl = self.tl
            if tl._base is None:
                tl._base = _stall_counters()
                tl._t_first = profiler._now_us()
            self.span.__enter__()
            return self

        def __exit__(self, *exc):
            from .. import profiler
            t0 = self.span._t0
            self.span.__exit__(*exc)
            tl = self.tl
            tl.steps += 1
            if t0 is None:       # telemetry disabled: count steps only
                return False
            now = profiler._now_us()
            tl._t_last = now
            tl.step_time_us += now - t0
            after = _stall_counters()
            for k in tl.deltas:
                tl.deltas[k] = after[k] - tl._base[k]
            # memory lane: one cheap sample per step exit (the caching
            # allocator's counter, or one /proc read); the loop high-water
            # folds into the report and the process-wide mem.peak_hbm_bytes
            b, source = profiler.read_memory_sample()
            if b > tl.peak_hbm_bytes:
                tl.peak_hbm_bytes = b
            tl.mem_source = source
            _note_memory_sample(b)
            return False

    def step(self):
        """Context manager for one step of the loop."""
        return self._Step(self)

    @property
    def total_us(self):
        """The loop window: first step entry to latest step exit."""
        if self._t_first is None or self._t_last is None:
            return 0.0
        return float(self._t_last - self._t_first)

    def report(self):
        """Plain-data breakdown; safe to json.dumps."""
        total = self.total_us
        stall = self.deltas["data_stall_us"]
        allred = self.deltas["allreduce_us"]
        rs = self.deltas["reduce_scatter_us"]
        ag = self.deltas["allgather_us"]
        compute = max(0.0, total - stall - allred - rs - ag)
        out = {
            "name": self.name,
            "steps": self.steps,
            "total_us": round(total, 1),
            "step_time_us": round(self.step_time_us, 1),
            "step_mean_us": round(self.step_time_us / self.steps, 1)
            if self.steps else 0.0,
            "data_stall_us": round(stall, 1),
            "allreduce_us": round(allred, 1),
            "reduce_scatter_us": round(rs, 1),
            "allgather_us": round(ag, 1),
            "compute_us": round(compute, 1),
            "h2d_stage_us": round(self.deltas["h2d_stage_us"], 1),
            "host_transfers": self.deltas["host_transfers"],
            "allreduce_buckets": self.deltas["allreduce_buckets"],
            "reduce_scatter_buckets":
                self.deltas["reduce_scatter_buckets"],
            "allgather_buckets": self.deltas["allgather_buckets"],
            "stall_pct": round(100.0 * stall / total, 2) if total else 0.0,
            "compute_pct": round(100.0 * compute / total, 2) if total
            else 0.0,
            "peak_hbm_bytes": int(self.peak_hbm_bytes),
            "mem_source": self.mem_source,
        }
        if self.flops_per_step and total > 0:
            achieved = self.flops_per_step * self.steps / (total * 1e-6)
            out["achieved_flops_per_sec"] = achieved
            if self.peak_flops:
                # 6 decimals: tiny test-scale MFUs must not round to 0.0
                out["mfu"] = round(achieved / self.peak_flops, 6)
        return out


# ---------------------------------------------------------------------------
# MFU numerator: FLOPs counted over one real call
# ---------------------------------------------------------------------------
# key -> (fn, flops): the cached callable is held strongly so its id can
# never be recycled by another function while the entry lives; bounded
# (FIFO) so per-call closures cannot pin models without limit
_flops_cache = OrderedDict()
_FLOPS_CACHE_CAP = 128


def _sig(a):
    """Structural signature of one argument: shapes, dtypes and devices
    recurse through lists, tuples and dicts."""
    if hasattr(a, "shape") and hasattr(a, "dtype"):
        return (tuple(a.shape), str(a.dtype), str(getattr(a, "device", "")))
    if isinstance(a, (list, tuple)):
        return (type(a).__name__, tuple(_sig(v) for v in a))
    if isinstance(a, dict):
        return ("dict", tuple((k, _sig(v)) for k, v in sorted(a.items())))
    return ("scalar", type(a).__name__, a if isinstance(
        a, (int, float, bool, str, type(None))) else None)


def cost_flops(fn, *args, what="program"):
    """FLOPs of one call `fn(*args)`, counted by
    `torch.utils.flop_counter.FlopCounterMode` (a multiply-add counts 2,
    as accelerator peaks do). The call really runs, on the device its
    arguments live on. The JAX package's `cost_flops` reads a lowered
    program's cost analysis instead; the port lowers nothing."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    flops = float(counter.get_total_flops())
    if flops <= 0:
        raise MXNetError(f"FlopCounterMode counted no flops for {what}")
    return flops


def model_flops(fn, *args):
    """FLOPs of one call `fn(*args)` (`cost_flops`), memoized on (fn
    identity, structural argument signature); the entry holds `fn`
    strongly so a recycled id can never alias another function."""
    key = (id(fn), tuple(_sig(a) for a in args))
    hit = _flops_cache.get(key)
    if hit is not None and hit[0] is fn:
        return hit[1]
    flops = cost_flops(fn, *args, what=repr(fn))
    _flops_cache[key] = (fn, flops)
    while len(_flops_cache) > _FLOPS_CACHE_CAP:
        _flops_cache.popitem(last=False)
    return flops


# net (weak) -> {(param shapes, input sig): flops}: repeat calls on the
# same net count once, and a dead net drops its entries
_block_flops_memo = weakref.WeakKeyDictionary()


def block_fwd_flops(net, x):
    """FLOPs of one forward of an initialized block on batch `x` (the
    whole batch, a multiply-add as 2), counted over a real forward in
    predict mode without a tape, on the device the block and `x` live
    on. A training step is conventionally ~3x this (forward plus a
    backward of twice its cost). Memoized per net (weakly) on the
    parameter shapes and the batch signature."""
    import torch
    from .. import autograd
    params = [p for _, p in sorted(net.collect_params().items())]
    for p in params:
        if p._data is None:
            raise MXNetError("block_fwd_flops needs an initialized net: "
                             "run one forward first")
    raw = getattr(x, "_t", x)
    memo_key = (tuple(_sig(p.data()) for p in params), _sig(raw))
    try:
        memo = _block_flops_memo.setdefault(net, {})
    except TypeError:          # unweakrefable net: skip the memo
        memo = {}
    if memo_key in memo:
        return memo[memo_key]

    def fwd(xin):
        with autograd.predict_mode(), torch.no_grad():
            net(xin)

    flops = cost_flops(fwd, x, what=f"forward of {type(net).__name__}")
    memo[memo_key] = flops
    return flops


# device-name substring -> the advertised dense bf16 peak FLOP/s (a
# multiply-add as 2): the H100 SXM5's 989e12, the card the port is
# measured on (torch.cuda.get_device_name() "NVIDIA H100 80GB HBM3", at
# its 700.00 W power limit; PERF.md uses the same peak). A card set below
# 700 W runs slower under load, so an MFU read there understates the
# work. No TPU peak is carried over.
_PEAKS = (
    ("H100", 989e12),
)


def device_peak_flops(device=None):
    """The card's dense bf16 peak FLOP/s from `_PEAKS`, or None for the
    CPU, without a card, and for a card the table lacks: MFU is then
    left out rather than wrong."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    dev = getattr(device, "torch_device", device)
    dev = torch.device(dev) if not isinstance(dev, torch.device) else dev
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for sub, peak in _PEAKS:
        if sub in name:
            return peak
    return None
