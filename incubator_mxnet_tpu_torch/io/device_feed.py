"""mx.io.DeviceFeed of the PyTorch port — an input pipeline that stages
host batches onto the card behind the step (double buffering).

Counterpart of `incubator_mxnet_tpu/io/device_feed.py`. A background
feeder pulls batches from any host iterator (gluon `DataLoader`, an `mx.io`
DataIter, a plain generator) and stages each one ahead of the consumer:

  * on the card, through a ring of page-locked staging buffers and a side
    CUDA stream: each host leaf is copied into a pinned buffer of the ring
    (a host memcpy), then to the card by an asynchronous DMA on the side
    stream, and the batch is handed on with the CUDA event recorded after
    its copies; the consumer's stream waits on that event (no host
    synchronization), and each delivered tensor is recorded on the
    consumer's stream so the allocator never hands its memory out early.
    A ring buffer is rewritten only after the event of its last copy.
    (`non_blocking=True` from pageable memory would be a synchronous
    staged copy.)
  * on the CPU, as a copy (a host leaf may be a buffer the source rewrites).

Host decode and the copy of batch N+1 then overlap the card's work on
batch N, so a training loop pays max(data time, step time).

    feed = mx.io.DeviceFeed(loader, depth=2)       # or prefetch_to_device()
    for batch in feed:                             # NDArrays on the card
        loss = step(*batch)

Failure semantics match `PrefetchingIter`: a feeder exception re-raises in
the consumer (never a silently short epoch); transient I/O errors
(IOError/OSError/TimeoutError) retry in place up to `max_restarts`
consecutive times (default `MXNET_PREFETCH_RESTARTS`). Knobs: explicit
argument, else the `MXNET_*` environment variable. Observability:
`feed_stats()` (the registry's `feed` group), the `io.feed` (consumer
waits) and `feed.stage` (feeder staging) spans in the trace that was
current when the epoch started, and the staged batches as the
`device_feed` owner of `inspect.memory`'s census.

Not carried over until its queue lands (ROADMAP): placement over a
data-parallel mesh (`sharding=`, A10), which raises.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as _np
import torch

from .. import fault as _fault
from ..base import MXNetError, get_env
from ..device import resolve_device
from ..telemetry import record_span, trace as _trace
from ..telemetry.registry import REGISTRY

__all__ = ["DeviceFeed", "prefetch_to_device", "feed_stats",
           "maybe_device_put", "FEED_STATS"]

# ---------------------------------------------------------------------------
# counters (always on — plain increments under one lock; adopted into the
# telemetry registry as the `feed` stats group)
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()

FEED_STATS = REGISTRY.stats_group("feed", {
    "batches_fed": 0,          # staged + buffered by feeder threads
    "batches_consumed": 0,     # delivered to the consumer
    "epochs": 0,               # completed feed iterations
    "host_transfers": 0,       # host leaves copied to the device
    "recommitted": 0,          # device tensors moved to another device
    "device_put_skipped": 0,   # already on the device: no copy
    "stall_data_us": 0.0,      # consumer waited on an EMPTY buffer
    "stall_compute_us": 0.0,   # feeder waited on a FULL buffer
    "stage_us": 0.0,           # feeder staging time (pinned copy + async
    #                            H2D dispatch) — overlaps compute by design
    "occupancy_sum": 0,        # buffer depth seen at each consume (incl. the
    "occupancy_samples": 0,    # batch being taken)
    "restarts": 0,             # transient feeder errors retried in place
    "failures": 0,             # terminal feeder failures re-raised downstream
}, lock=_STATS_LOCK,
    help="device-feed input-pipeline counters (profiler.feed_stats)")


def _bump(key, delta=1):
    with _STATS_LOCK:
        FEED_STATS[key] += delta


def _mem_register(t, owner):
    """`inspect.memory.register(t, owner)`; returns `t`."""
    from ..inspect import memory as _mem
    return _mem.register(t, owner=owner)


def feed_stats(reset=False):
    """Snapshot of the device-feed counters (plus derived
    `occupancy_mean`). `reset=True` zeroes the counters after the
    snapshot (atomically — no increment is lost between copy and zero)."""
    snap = FEED_STATS.snapshot(reset=reset)
    snap["occupancy_mean"] = (
        snap["occupancy_sum"] / snap["occupancy_samples"]
        if snap["occupancy_samples"] else 0.0)
    return snap


def _no_sharding(sharding):
    if sharding is not None:
        raise MXNetError("DeviceFeed placement over a mesh (sharding=) is "
                         "not ported yet (ROADMAP A10)")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def maybe_device_put(raw, device=None, sharding=None):
    """`raw` (an NDArray, a tensor or a numpy array) as a tensor on `device`
    (None: the current device), skipping the copy when it is there already.
    Each case is counted in FEED_STATS: a tensor on the device is returned
    as it is (`device_put_skipped`), one on another device is moved
    (`recommitted`), a host value is copied (`host_transfers`; on the CPU a
    numpy array is copied too, never aliased)."""
    _no_sharding(sharding)
    from ..ndarray import NDArray
    dev = resolve_device(device)
    if isinstance(raw, NDArray):
        raw = raw._t
    if isinstance(raw, torch.Tensor):
        if raw.device == dev:
            _bump("device_put_skipped")
            return raw
        _bump("host_transfers" if raw.device.type == "cpu"
              else "recommitted")
        return raw.to(dev)
    _bump("host_transfers")
    return torch.tensor(_np.asarray(raw), device=dev)


class _FeedFailure:
    """Terminal sentinel: the feeder died; holds the original exception."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


def _fetch_with_restarts(source, point, max_restarts, on_restart=None):
    """Shared fetch loop for prefetch workers (PrefetchingIter._worker and
    DeviceFeed._worker): inject the fault `point` BEFORE each fetch (a
    transient injected fault must not consume a batch from the source),
    retry transient I/O errors (IOError/OSError/TimeoutError) in place up
    to `max_restarts` CONSECUTIVE times with a structured log per retry,
    and re-raise the original exception once the budget is exhausted (or
    immediately for non-transient errors). Yields fetched batches."""
    it = iter(source)
    restarts = 0
    while True:
        try:
            _fault.inject(point)
            batch = next(it)
        except StopIteration:
            return
        except (IOError, OSError, TimeoutError) as e:
            if restarts < max_restarts:
                restarts += 1
                if on_restart is not None:
                    on_restart()
                _fault._log_event(point + "_restart", attempt=restarts,
                                  error=repr(e))
                continue
            raise
        restarts = 0   # budget bounds CONSECUTIVE errors, not lifetime
        yield batch


class _PinnedRing:
    """Page-locked staging buffers for the feeder, `n` slots used in turn.
    A slot holds one pinned tensor per (shape, dtype) of the batches it
    staged and the CUDA event of its last copies; it is rewritten only
    once that event has completed."""

    def __init__(self, n):
        self._slots = [({}, None) for _ in range(n)]
        self._next = 0

    def take(self):
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()
        return i, bufs

    def done(self, i, event):
        self._slots[i] = (self._slots[i][0], event)


# ---------------------------------------------------------------------------
# the feed
# ---------------------------------------------------------------------------
class DeviceFeed:
    """Background device feed over any batch iterator (single consumer).

    Parameters
    ----------
    source : iterable
        Anything yielding batches: gluon `DataLoader`, `mx.io` DataIter
        (DataBatch elements are staged field-wise), or a generator of
        (nested) tuples/lists/dicts of NDArray/tensor/numpy leaves.
        Non-array leaves pass through untouched.
    depth : int, optional
        Buffer depth — batches staged ahead of the consumer (default
        `MXNET_DEVICE_FEED_DEPTH`, 2 = double buffering).
    sharding : None
        Mesh placement is ROADMAP A10; anything but None raises.
    batch_axis : int
        Kept for the JAX package's signature.
    max_restarts : int, optional
        Consecutive transient-error retries before the feeder gives up
        (default `MXNET_PREFETCH_RESTARTS`).
    device : optional
        Where batches go (default: the current device when an epoch
        starts, the card unless inside `with mx.cpu():`).

    Each `iter(feed)` starts one fresh pass over `source` (epoch); `reset`
    stops the feeder and forwards to `source.reset()` when it exists, and
    `len(feed)` forwards to the source.
    """

    _feeds_device = True   # integration marker (DataLoader)

    def __init__(self, source, depth=None, sharding=None, batch_axis=0,
                 max_restarts=None, device=None):
        _no_sharding(sharding)
        if depth is None:
            depth = get_env("MXNET_DEVICE_FEED_DEPTH", 2, typ=int)
        if int(depth) < 1:
            raise MXNetError("DeviceFeed depth must be >= 1")
        self._source = source
        self._depth = int(depth)
        self._batch_axis = int(batch_axis)
        self._max_restarts = (get_env("MXNET_PREFETCH_RESTARTS", 3, typ=int)
                              if max_restarts is None else int(max_restarts))
        self._device_arg = device
        self._device = None
        self._stream = None
        self._ring = None
        self._queue = None
        self._stop = None
        self._thread = None
        self._exhausted = False
        self.batch_size = getattr(source, "batch_size", None)

    # -- epoch lifecycle ------------------------------------------------
    def __iter__(self):
        self._start_epoch()
        return self

    def _start_epoch(self):
        self._shutdown()
        self._exhausted = False
        # resolved here, on the consumer thread: the feeder thread has an
        # empty device scope, so `with mx.cpu():` must be read now
        dev = resolve_device(self._device_arg)
        if dev != self._device:
            self._device = dev
            self._stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                            else None)
            self._ring = (_PinnedRing(self._depth + 2)
                          if dev.type == "cuda" else None)
        q = self._queue = _queue.Queue(maxsize=self._depth)
        stop = self._stop = threading.Event()
        # a new thread starts with an empty contextvars context: the
        # consumer's trace context rides as a Thread argument, so the
        # feeder's feed.stage spans nest under the consumer's step
        ctx = _trace.current_context()
        self._thread = threading.Thread(
            target=self._worker, args=(q, stop, ctx), daemon=True,
            name="mx-device-feed")
        self._thread.start()

    def __next__(self):
        if self._queue is None:
            if self._exhausted:    # stays exhausted until iter() restarts
                raise StopIteration
            self._start_epoch()
        t0 = time.perf_counter()
        item = self._queue.get()
        if item is None:
            self._finish_epoch()
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _FeedFailure):
            self._finish_epoch()
            self._exhausted = True
            raise item.error
        waited_us = (time.perf_counter() - t0) * 1e6
        with _STATS_LOCK:
            FEED_STATS["stall_data_us"] += waited_us
            FEED_STATS["occupancy_sum"] += self._queue.qsize() + 1
            FEED_STATS["occupancy_samples"] += 1
            FEED_STATS["batches_consumed"] += 1
        record_span("io.feed", waited_us, ts_us=t0 * 1e6, cat="io",
                    buffer=self._queue.qsize())
        staged, event, tensors = item
        if event is not None:
            # the consumer's stream waits for the batch's copies; the
            # tensors, made on the side stream, are marked as used on it
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for t in tensors:
                t.record_stream(cur)
        return staged

    next = __next__

    def __len__(self):
        return len(self._source)

    def reset(self):
        """Stop the feeder and reset the underlying source (when it can)."""
        self._shutdown()
        self._exhausted = False
        r = getattr(self._source, "reset", None)
        if r is not None:
            r()

    def close(self):
        """Stop the feeder thread (idempotent; also runs at GC)."""
        self._shutdown()

    def _finish_epoch(self):
        t, self._thread = self._thread, None
        self._queue = None
        self._stop = None
        if t is not None:
            t.join(timeout=10)
        _bump("epochs")

    def _shutdown(self):
        if self._thread is None:
            return
        self._stop.set()
        try:            # drain so a feeder blocked on a full buffer wakes
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # a fetch stalled past the join window: the old feeder may
            # still advance the shared source when it wakes, racing a new
            # epoch's feeder — surface it instead of silently proceeding
            _fault._log_event("io.device_feed_shutdown_timeout",
                              source=type(self._source).__name__)
        self._thread = None
        self._queue = None
        self._stop = None

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass

    # -- feeder thread --------------------------------------------------
    def _worker(self, q, stop, ctx=None):
        if ctx is not None:
            # adopt the consumer's trace context
            _trace.attach(ctx)
        fetch = _fetch_with_restarts(self._source, "io.device_feed",
                                     self._max_restarts,
                                     on_restart=lambda: _bump("restarts"))
        while not stop.is_set():
            try:
                batch = next(fetch)
            except StopIteration:
                self._put(q, stop, None)
                return
            except BaseException as e:   # re-raised in the consumer
                _bump("failures")
                self._put(q, stop, _FeedFailure(e))
                return
            try:
                t0 = time.perf_counter()
                staged = self._stage_batch(batch)
                stage_us = (time.perf_counter() - t0) * 1e6
            except BaseException as e:
                _bump("failures")
                self._put(q, stop, _FeedFailure(e))
                return
            _bump("stage_us", stage_us)
            record_span("feed.stage", stage_us, ts_us=t0 * 1e6, cat="io")
            if not self._put(q, stop, staged):
                return
            _bump("batches_fed")

    def _put(self, q, stop, item):
        """Blocking put that aborts on shutdown. Time spent here means the
        buffer is full — compute is the bottleneck, not data."""
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
            except _queue.Full:
                continue
            _bump("stall_compute_us", (time.perf_counter() - t0) * 1e6)
            return True
        return False

    # -- staging --------------------------------------------------------
    def _stage_batch(self, batch):
        """(staged batch, CUDA event of its copies or None, the tensors the
        copies made)."""
        dev = self._device
        if dev.type != "cuda":
            return self._stage(batch, None), None, []
        slot, bufs = self._ring.take()
        made = []
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            staged = self._stage(batch, (bufs, made))
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring.done(slot, event)
        return staged, event, made

    def _stage(self, batch, pinned):
        from . import DataBatch
        if isinstance(batch, DataBatch):
            return DataBatch(self._stage(batch.data, pinned),
                             label=self._stage(batch.label, pinned),
                             pad=batch.pad, index=batch.index,
                             provide_data=batch.provide_data,
                             provide_label=batch.provide_label)
        if isinstance(batch, dict):
            return {k: self._stage(v, pinned) for k, v in batch.items()}
        if isinstance(batch, tuple):
            staged = [self._stage(v, pinned) for v in batch]
            if hasattr(batch, "_fields"):     # namedtuple: keep the type
                return type(batch)(*staged)
            return tuple(staged)
        if isinstance(batch, list):
            return [self._stage(v, pinned) for v in batch]
        return self._stage_leaf(batch, pinned)

    def _stage_leaf(self, x, pinned):
        from ..ndarray import NDArray, _wrap
        raw = x._t if isinstance(x, NDArray) else x
        host = isinstance(raw, (_np.ndarray, _np.generic))
        if host:
            raw = torch.from_numpy(_np.ascontiguousarray(raw))
        if not isinstance(raw, torch.Tensor):
            return x                       # scalars/strings pass through
        dev = self._device
        if raw.device == dev and not host:
            _bump("device_put_skipped")
            return _wrap(raw)
        if pinned is None or raw.device.type != "cpu":
            # the CPU: a copy (a tensor over a numpy buffer would alias
            # what the source may rewrite); another card: a move
            _bump("host_transfers" if raw.device.type == "cpu"
                  else "recommitted")
            return _wrap(_mem_register(raw.to(dev, copy=True),
                                       "device_feed"))
        bufs, made = pinned
        key = (tuple(raw.shape), raw.dtype, len(made))
        buf = bufs.get(key)
        if buf is None:
            buf = bufs[key] = torch.empty(raw.shape, dtype=raw.dtype,
                                          pin_memory=True)
        buf.copy_(raw)
        out = buf.to(dev, non_blocking=True)
        made.append(out)
        _bump("host_transfers")
        # census attribution: the staged batches in flight are the feed's
        # resident set (a weak reference per leaf)
        _mem_register(out, "device_feed")
        return _wrap(out)


def prefetch_to_device(loader, size=None, sharding=None, batch_axis=0,
                       device=None):
    """flax-style convenience: `for batch in prefetch_to_device(loader):`
    — wraps `loader` in a DeviceFeed of depth `size` (default
    MXNET_DEVICE_FEED_DEPTH, 2 = double buffering, 3 = triple)."""
    return DeviceFeed(loader, depth=size, sharding=sharding,
                      batch_axis=batch_axis, device=device)
