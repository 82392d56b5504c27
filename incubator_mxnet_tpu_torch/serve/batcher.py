"""Request queue and dynamic batcher of the PyTorch port, over exported
artifacts or an in-process callable.

Counterpart of `incubator_mxnet_tpu/serve/batcher.py`:

    submit() ──► bounded queue ──► batcher thread ──► bucket's program ──► futures

One request is ONE sample (the exported input shape minus its batch dim).
The batcher coalesces concurrent requests into a batch, rounds it up to the
smallest bucket (pad rows are zeros, sliced off before the reply), runs the
bucket's program, makes one device-to-host copy of each output of the
batch and splits it into the replies (numpy arrays). Failures are typed
(`QueueFullError` for admission-control rejects and shed requests,
`RequestTimeout` for missed deadlines, `ServerClosed` after shutdown), and
the `serve.enqueue` / `serve.execute` / `serve.reply` fault points sit at
the JAX package's call sites. One request is one trace: its
`serve.request` root context is minted on the caller's thread (while a
collector can consume it: the profiler, the flight recorder's spool, or
an explicit `MXNET_TRACE_SAMPLE`) and rides the queue, so the
`serve.enqueue`, `serve.queue_wait`, `serve.execute` and `serve.reply`
spans land in it; the slowest requests' trace ids are in
`stats()["timeline"]["slowest"]`. Overload and timeouts feed the flight
recorder, and a failed batch that ran out of memory leaves the OOM black
box (`telemetry.mem_on_oom`).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as _np
import torch

from .. import fault as _fault
from ..base import MXNetError, get_env
from ..telemetry import (record_span, trace as _trace, mem_on_oom,
                         mem_install_oom_hook)
from .metrics import ServeMetrics

__all__ = ["ServeError", "QueueFullError", "RequestTimeout", "ServerClosed",
           "ReplicaDraining", "BucketedModel", "CallableModel", "Server",
           "pick_bucket"]


class ServeError(MXNetError):
    """Base class for serving failures."""


class QueueFullError(ServeError):
    """Admission control failed the request: the queue was at capacity and
    the overload policy rejected this request (`policy='reject'`)."""

    def __init__(self, msg, policy="reject"):
        super().__init__(msg)
        self.policy = policy


class RequestTimeout(ServeError):
    """The request missed its deadline while waiting in the queue."""


class ServerClosed(ServeError):
    """submit() after close(), or the request was pending at a non-draining
    shutdown."""


class ReplicaDraining(ServerClosed):
    """submit() while the engine is DRAINING: it has stopped admitting but
    is still finishing its resident requests before a restart. Subclasses
    ServerClosed so callers that already handle close() races keep
    working."""


def _fail(req, exc):
    if req.future.set_running_or_notify_cancel():
        req.future.set_exception(exc)


def pick_bucket(n, buckets):
    """Smallest bucket >= n, or None when n exceeds the largest bucket."""
    for b in buckets:
        if b >= n:
            return b
    return None


def _as_row(x):
    return _np.asarray(getattr(x, "asnumpy", lambda: x)())


# ---------------------------------------------------------------------------
# model backends
# ---------------------------------------------------------------------------
class BucketedModel:
    """A fixed set of batch-size buckets, each served by one
    `deploy.ExportedModel`: traffic is padded onto a small closed set of
    static-shape programs (`export_block` makes them from one block)."""

    def __init__(self, models):
        if not models:
            raise ServeError("BucketedModel needs at least one model")
        if not isinstance(models, dict):
            models = {m.batch_size: m for m in models}
        self._models = dict(sorted(models.items()))
        self.batch_sizes = list(self._models)
        if any(b < 1 for b in self.batch_sizes):
            raise ServeError(f"invalid batch buckets {self.batch_sizes}")
        ref = self.row_specs
        for b, m in self._models.items():
            specs = [(tuple(s[1:]), d) for s, d in m.input_specs]
            if specs != ref:
                raise ServeError(
                    f"bucket {b} row specs {specs} != bucket "
                    f"{self.batch_sizes[0]} row specs {ref}")
        m0 = self._models[self.batch_sizes[0]]
        self.single_output = m0.single_output
        self.n_out = m0.n_out

    @classmethod
    def from_prefixes(cls, prefixes, device=None):
        """Load one exported artifact set per bucket."""
        from ..deploy import ExportedModel
        return cls([ExportedModel(p, device=device) for p in prefixes])

    @classmethod
    def export_block(cls, block, sample_shape, buckets, directory,
                     name="model", dtype="float32", device=None):
        """Export `block` once per bucket size and load the artifacts back
        on `device` (default: the card). `sample_shape` is the per-sample
        input shape (no batch dim). Returns the BucketedModel over
        `<directory>/<name>-b<bucket>-0000`."""
        from ..deploy import ExportedModel, _torch_dtype
        from ..device import resolve_device
        dev = resolve_device(device)
        models = {}
        for b in sorted(set(int(x) for x in buckets)):
            x = torch.zeros((b,) + tuple(sample_shape),
                            dtype=_torch_dtype(dtype), device=dev)
            prefix = os.path.join(directory, f"{name}-b{b}")
            block.export(prefix, example_inputs=x)
            models[b] = ExportedModel(f"{prefix}-0000", device=dev)
        return cls(models)

    @property
    def num_inputs(self):
        return self._models[self.batch_sizes[0]].num_inputs

    @property
    def row_specs(self):
        """[(per-sample shape, dtype), ...] — input specs minus batch dim."""
        m = self._models[self.batch_sizes[0]]
        return [(tuple(s[1:]), d) for s, d in m.input_specs]

    def model(self, bucket):
        """The bucket's `ExportedModel`."""
        return self._models[bucket]

    def run_batch(self, bucket, arrs):
        """Run the bucket's program; a tuple of numpy outputs (leading dim
        == bucket), one device-to-host copy each."""
        out = self._models[bucket].run(*arrs)
        return out if isinstance(out, tuple) else (out,)

    def warmup(self):
        for m in self._models.values():
            m.warmup()

    def compile_cache_size(self):
        """Distinct programs run across buckets (one a bucket after
        warmup)."""
        return sum(m.compile_cache_size() for m in self._models.values())


class CallableModel:
    """Serve a torch callable at a fixed bucket set: `fn(*batched tensors)
    -> tensor | tuple`, its inputs on `device` (default: the card). The
    same closed-set contract as BucketedModel, with no export round trip
    (the in-process deployment path); `compile_cache_size()` counts the
    distinct bucket shapes it has run."""

    def __init__(self, fn, batch_sizes=None, row_specs=(),
                 single_output=True, device=None):
        from ..device import resolve_device
        if batch_sizes is None:
            # knob precedence: explicit arg > deployment profile >
            # default ladder (each bucket is one program shape, so the set
            # is a measured cost/padding trade — mx.tune's serve_batch)
            from ..tune.profile import resolve as _tune_resolve
            batch_sizes = _tune_resolve("serve.batch_buckets",
                                        [1, 2, 4, 8, 16, 32])
        if not row_specs:
            raise ServeError("CallableModel needs row_specs")
        self._fn = fn
        self.device = resolve_device(device)
        self.batch_sizes = sorted(int(b) for b in batch_sizes)
        self.row_specs = [(tuple(s), str(d).replace("torch.", ""))
                          for s, d in row_specs]
        self.single_output = bool(single_output)
        self._shapes = set()

    @property
    def num_inputs(self):
        return len(self.row_specs)

    def run_batch(self, bucket, arrs):
        from ..deploy import _to_host, _torch_dtype
        ts = [torch.from_numpy(_np.ascontiguousarray(a)).to(
            device=self.device, dtype=_torch_dtype(d))
            for a, (_, d) in zip(arrs, self.row_specs)]
        self._shapes.add(tuple(tuple(t.shape) for t in ts))
        with torch.no_grad():
            out = self._fn(*ts)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return tuple(_to_host(o) for o in out)

    def warmup(self):
        from ..deploy import _np_dtype
        for b in self.batch_sizes:
            self.run_batch(b, [_np.zeros((b,) + s, dtype=_np_dtype(d))
                               for s, d in self.row_specs])

    def compile_cache_size(self):
        return len(self._shapes)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class _Request:
    __slots__ = ("inputs", "future", "deadline", "t_submit", "ctx")

    def __init__(self, inputs, deadline, ctx=None):
        self.inputs = inputs
        self.future = Future()
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        # the request's root TraceContext ("serve.request"), minted on the
        # caller's thread and carried across the queue
        self.ctx = ctx


class Server:
    """Thread-safe dynamic-batching server over a bucketed model.

    ::

        model = serve.BucketedModel.from_prefixes(["m-b1-0000", "m-b8-0000"])
        with serve.Server(model, batch_timeout_ms=2.0) as srv:
            fut = srv.submit(x_row)          # a Future
            y = fut.result()
            y = srv.predict(x_row)           # submit + wait

    Knobs (constructor arg > MXNET_SERVE_* env > default): `max_queue`
    (admission control), `batch_timeout_ms` (max wait to fill a batch
    after its first request), `default_deadline_ms` (per-request queue
    deadline, None = none), `overload_policy` ('reject': fail the
    submitter; 'shed': fail the oldest queued request and admit the new
    one). One batcher thread runs the batches, so the model never runs
    concurrently with itself; submit() is safe from any number of
    threads.
    """

    def __init__(self, model, *, max_queue=None, batch_timeout_ms=None,
                 default_deadline_ms=None, overload_policy=None,
                 name="serve"):
        from ..deploy import ExportedModel
        if isinstance(model, ExportedModel):
            model = BucketedModel([model])
        elif isinstance(model, (dict, list)):
            model = BucketedModel(model)
        self.model = model
        self.name = name
        self.max_queue = int(
            max_queue if max_queue is not None
            else get_env("MXNET_SERVE_MAX_QUEUE", 256, typ=int))
        self.batch_timeout_s = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else get_env("MXNET_SERVE_BATCH_TIMEOUT_MS", 2.0,
                         typ=float)) / 1e3
        dl = (default_deadline_ms if default_deadline_ms is not None
              else get_env("MXNET_SERVE_DEADLINE_MS", typ=float))
        self.default_deadline_s = None if dl is None else float(dl) / 1e3
        self.overload_policy = (
            overload_policy
            or get_env("MXNET_SERVE_OVERLOAD_POLICY", "reject"))
        if self.overload_policy not in ("reject", "shed"):
            raise ServeError(
                f"overload_policy must be 'reject' or 'shed', got "
                f"{self.overload_policy!r}")
        if self.max_queue < 1:
            raise ServeError("max_queue must be >= 1")
        from ..deploy import _np_dtype
        self._row_dtypes = [_np_dtype(d) for _, d in model.row_specs]
        self.metrics = ServeMetrics()
        self._queue = deque()
        self._cv = threading.Condition()
        self._closing = False
        self._started = False
        self._warm = set()
        self._warm_first = True
        self._ready = threading.Event()
        self._start_error = None
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-batcher", daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup=True):
        """Start the batcher thread, which runs every bucket once (unless
        warmup=False) before it takes a request: kernel builds, algorithm
        choices and the thread's own library handles (PyTorch keeps its
        cuBLAS and cuDNN handles per thread) stay off the serving path.
        Returns when the warm-up is done and raises its error. With
        MXNET_METRICS_PORT set, also serve `/metrics` there (once per
        process; a port taken by another process only logs a warning)."""
        if self._started:
            return self
        with self._cv:
            self._warm_first = warmup
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self._thread.join()
            raise self._start_error
        port = get_env("MXNET_METRICS_PORT", typ=int)
        if port is not None:
            from .metrics import ensure_metrics_server
            try:
                ensure_metrics_server(port)
            except OSError as e:
                import logging
                logging.getLogger("mx.serve").warning(
                    "metrics endpoint on port %s unavailable (%s); "
                    "serving continues without /metrics", port, e)
        # the flight recorder's crash hooks (armed only while
        # MXNET_FLIGHTREC_DIR is set) and the OOM excepthook
        _trace.install_crash_hooks()
        mem_install_oom_hook()
        self._started = True
        return self

    def __enter__(self):
        return self.start()

    def close(self, drain=True, timeout=30.0):
        """Stop the batcher. `drain=True` serves the queued requests first;
        `drain=False` fails them with ServerClosed."""
        with self._cv:
            if self._closing:
                pending = []
            else:
                self._closing = True
                pending = [] if drain else list(self._queue)
                if not drain:
                    self._queue.clear()
            self._cv.notify_all()
        for req in pending:
            _fail(req, ServerClosed("server closed before execution"))
        if self._started:
            self._thread.join(timeout=timeout)

    def __exit__(self, *exc):
        self.close()

    def _mark_warm(self, bucket):
        """Record `bucket`'s program as run; True on first sighting."""
        with self._cv:
            if bucket in self._warm:
                return False
            self._warm.add(bucket)
            return True

    # -- submission --------------------------------------------------------
    def _check_row(self, inputs):
        specs = self.model.row_specs
        if len(inputs) != len(specs):
            raise ServeError(
                f"model takes {len(specs)} inputs, got {len(inputs)}")
        rows = []
        for i, (x, (shape, _), dt) in enumerate(
                zip(inputs, specs, self._row_dtypes)):
            a = _as_row(x)
            if tuple(a.shape) != shape:
                raise ServeError(
                    f"input {i}: sample shape {tuple(a.shape)} != exported "
                    f"row shape {shape} (one request = one sample)")
            rows.append(a.astype(dt, copy=False))
        return tuple(rows)

    def submit(self, *inputs, deadline_ms=None):
        """Enqueue one sample; returns a `concurrent.futures.Future`.

        Raises QueueFullError at once when the queue is full under
        reject-newest; under shed-oldest the OLDEST queued request fails
        instead and this one is admitted. Raises ServerClosed after
        close()."""
        if not self._started:
            raise ServeError("Server.start() (or `with Server(...)`) first")
        t_enter = time.perf_counter()
        rows = self._check_row(inputs)
        _fault.inject("serve.enqueue")
        dl = (deadline_ms / 1e3 if deadline_ms is not None
              else self.default_deadline_s)
        # one request = one trace, minted here on the caller's thread
        ctx = _trace.request_root("serve.request")
        req = _Request(rows, None if dl is None
                       else time.perf_counter() + dl, ctx=ctx)
        shed_req = None
        rejected_depth = None
        with self._cv:
            if self._closing:
                raise ServerClosed("server is closed")
            if len(self._queue) >= self.max_queue:
                if self.overload_policy == "reject":
                    rejected_depth = len(self._queue)
                else:
                    shed_req = self._queue.popleft()
            if rejected_depth is None:
                self._queue.append(req)
                depth = len(self._queue)
                self._cv.notify()
        if rejected_depth is not None:
            # flight-recorder I/O (a rate-limited dump too) outside the
            # server lock: an overload black box must not stall admission
            self.metrics.count("rejected")
            _trace.flightrec_record(
                "serve.reject", self.name, depth=rejected_depth,
                trace_id=ctx.trace_id if ctx else None)
            _trace.flightrec_maybe_dump("serve.overload")
            raise QueueFullError(
                f"queue full ({self.max_queue}); request rejected",
                policy="reject")
        self.metrics.count("requests")
        self.metrics.set_queue_depth(depth)
        if ctx is not None and _trace._profiler_running():
            # the caller-side stage span: admission + enqueue cost
            record_span("serve.enqueue",
                        (time.perf_counter() - t_enter) * 1e6,
                        ts_us=t_enter * 1e6, cat="serve",
                        ctx=_trace.child_context(ctx, "serve.enqueue"),
                        queue_depth=depth)
        if shed_req is not None:
            self.metrics.count("shed")
            _trace.flightrec_record(
                "serve.shed", self.name, depth=depth,
                trace_id=shed_req.ctx.trace_id if shed_req.ctx else None)
            _trace.flightrec_maybe_dump("serve.overload")
            _fail(shed_req, QueueFullError(
                f"queue full ({self.max_queue}); oldest request shed",
                policy="shed"))
        return req.future

    def predict(self, *inputs, timeout=None, deadline_ms=None):
        """submit() + wait; returns the model output for this sample."""
        return self.submit(*inputs, deadline_ms=deadline_ms).result(
            timeout=timeout)

    def stats(self):
        """Metrics snapshot plus the buckets and the programs run;
        `out["timeline"]` splits request time into queue-wait and
        execute."""
        out = self.metrics.snapshot()
        out["buckets"] = list(self.model.batch_sizes)
        out["compile_cache_size"] = self.model.compile_cache_size()
        return out

    def timeline(self):
        """Request-timeline attribution only: where request time went."""
        return self.metrics.snapshot()["timeline"]

    def metrics_text(self):
        """Prometheus text: the process-wide counters (`serve.
        metrics_text()`) plus this server's gauges."""
        from .metrics import metrics_text
        return metrics_text() + "\n".join(
            self.metrics.prometheus_lines(server=self.name)) + "\n"

    # -- batcher thread ----------------------------------------------------
    def _assemble(self):
        """Pop the next batch (up to the largest bucket), waiting at most
        the batch timeout from the FIRST queued request."""
        max_b = self.model.batch_sizes[-1]
        with self._cv:
            while not self._queue and not self._closing:
                self._cv.wait()
            if not self._queue:
                return None          # closing and empty
            t_end = self._queue[0].t_submit + self.batch_timeout_s
            while len(self._queue) < max_b and not self._closing:
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue), max_b))]
            depth = len(self._queue)
        self.metrics.set_queue_depth(depth)
        return batch, depth

    def _loop(self):
        try:
            if self._warm_first:
                self.model.warmup()
                for b in self.model.batch_sizes:
                    if self._mark_warm(b):
                        self.metrics.count("programs_compiled")
        except BaseException as e:
            with self._cv:
                self._start_error = e
            return
        finally:
            self._ready.set()
        while True:
            got = self._assemble()
            if got is None:
                return
            batch, depth = got
            now = time.perf_counter()
            live = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    self.metrics.count("timeouts")
                    _trace.flightrec_record(
                        "serve.timeout", self.name,
                        waited_ms=round((now - req.t_submit) * 1e3, 1),
                        trace_id=req.ctx.trace_id if req.ctx else None)
                    _fail(req, RequestTimeout(
                        "deadline expired after "
                        f"{(now - req.t_submit) * 1e3:.1f}ms in queue"))
                else:
                    live.append(req)
            if live:
                self._execute(live, depth)

    def _execute(self, batch, depth):
        n = len(batch)
        bucket = pick_bucket(n, self.model.batch_sizes)
        if self._mark_warm(bucket):
            self.metrics.count("programs_compiled")
        t0 = time.perf_counter()
        try:
            _fault.inject("serve.execute")
            arrs = []
            for j, ((shape, _), dt) in enumerate(
                    zip(self.model.row_specs, self._row_dtypes)):
                a = _np.zeros((bucket,) + shape, dtype=dt)
                for i, req in enumerate(batch):
                    a[i] = req.inputs[j]
                arrs.append(a)
            outs = self.model.run_batch(bucket, arrs)
            # pad rows [n:] are whatever the model made of zero rows: slice
            # them off here, and refuse an output without the batch dim
            # (no row <-> request correspondence, e.g. a batch reduction)
            bad = [tuple(getattr(o, "shape", ())) for o in outs
                   if getattr(o, "shape", None) is None
                   or len(o.shape) == 0 or o.shape[0] != bucket]
            if bad:
                raise ServeError(
                    f"model output shapes {bad} do not carry the batch "
                    f"dim (bucket {bucket}): pad rows cannot be masked "
                    f"off, refusing to reply with pad-contaminated data")
            outs = tuple(o[:n] for o in outs)
        except BaseException as e:
            # an OOM leaves its black box before the batch fails (never
            # raises, so it cannot displace the real error)
            mem_on_oom(e, where="serve.batch")
            self.metrics.count("errors", n)
            err = e if isinstance(e, MXNetError) else ServeError(
                f"batch execution failed: {type(e).__name__}: {e}")
            for req in batch:
                _fail(req, err)
            return
        exec_ms = (time.perf_counter() - t0) * 1e3
        wait_ms = sum((t0 - req.t_submit) * 1e3 for req in batch)
        self.metrics.observe_batch(
            bucket, n, exec_ms, depth, queue_wait_ms=wait_ms,
            member_traces=[req.ctx.trace_id for req in batch if req.ctx])
        # the batcher-side stage spans of each traced request, while the
        # profiler collects
        if _trace._profiler_running():
            for req in batch:
                if req.ctx is None:
                    continue
                record_span("serve.queue_wait",
                            (t0 - req.t_submit) * 1e6,
                            ts_us=req.t_submit * 1e6, cat="serve",
                            ctx=_trace.child_context(req.ctx,
                                                     "serve.queue_wait"),
                            bucket=bucket)
                record_span("serve.execute", exec_ms * 1e3,
                            ts_us=t0 * 1e6, cat="serve",
                            ctx=_trace.child_context(req.ctx,
                                                     "serve.execute"),
                            bucket=bucket, batch_n=n)
        try:
            _fault.inject("serve.reply")
        except BaseException as e:
            self.metrics.count("errors", n)
            err = e if isinstance(e, MXNetError) else ServeError(
                f"reply failed: {type(e).__name__}: {e}")
            for req in batch:
                _fail(req, err)
            return
        # one shared timestamp: set_result() runs client callbacks inline,
        # and their time must not count as later members' latency
        done = time.perf_counter()
        for i, req in enumerate(batch):
            row = tuple(o[i] for o in outs)
            if self.model.single_output:
                row = row[0]
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(row)
            self.metrics.count("replies")
            total_ms = (done - req.t_submit) * 1e3
            self.metrics.observe_latency(total_ms)
            if req.ctx is not None and _trace._profiler_running():
                record_span("serve.reply",
                            (time.perf_counter() - done) * 1e6,
                            ts_us=done * 1e6, cat="serve",
                            ctx=_trace.child_context(req.ctx,
                                                     "serve.reply"))
                # the request's root span: enqueue -> reply
                record_span("serve.request", total_ms * 1e3,
                            ts_us=req.t_submit * 1e6, cat="serve",
                            ctx=req.ctx, bucket=bucket)
            self.metrics.observe_request(
                total_ms,
                trace_id=req.ctx.trace_id if req.ctx else None,
                queue_wait_ms=(t0 - req.t_submit) * 1e3,
                exec_ms=exec_ms, batch_size=n,
                deadline_margin_ms=((req.deadline - done) * 1e3
                                    if req.deadline is not None else None))
