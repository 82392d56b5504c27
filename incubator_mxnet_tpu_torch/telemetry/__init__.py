"""mx.telemetry of the PyTorch port: the metrics registry, spans, step
timelines and request tracing.

Counterpart of `incubator_mxnet_tpu/telemetry/__init__.py`, one
observability surface for the whole process:

  telemetry.counter/gauge/histogram   typed metrics with labels on the
                                      process-global REGISTRY
  telemetry.snapshot(reset=False)     flat dict over every counter in the
                                      process (dispatch, serve, feed,
                                      io.imagerec, fused, spans, memory)
  telemetry.prometheus_text()         Prometheus text exposition (0.0.4)
  telemetry.span("train.step", n=1)   nesting-aware tracer: Chrome-trace
                                      lane + duration histogram
  telemetry.StepTimeline              per-step data-stall / compute / H2D
                                      breakdown from live counters, MFU
  telemetry.block_fwd_flops(net, x)   FLOPs counted over a real forward
  telemetry.start_metrics_server(port)  /metrics HTTP endpoint
  telemetry.trace                     request tracing (TraceContext,
                                      attach) + the crash flight recorder

The modules' own accessors keep working: `serve_stats()`, `io_stats()`,
`feed_stats()`, `dispatch_stats()` and `fused_stats()` read registry
stats groups with the same keys and reset semantics.

Knobs: `MXNET_TELEMETRY` (default on; `0` makes spans and step timelines
no-ops, counters stay live), `MXNET_METRICS_PORT` (when set,
`serve.Server.start()` also starts the /metrics endpoint).
"""
from __future__ import annotations

import threading as _threading

from ..base import _register_env
from .registry import (Counter, Gauge, Histogram, StatsGroup, Registry,
                       REGISTRY, counter, gauge, histogram, stats_group,
                       snapshot, snapshot_json, prometheus_text,
                       DEFAULT_BUCKETS)
from . import trace
from .trace import (TraceContext, current_context, attach, detach,
                    attached, new_context, child_context,
                    flightrec_record, flightrec_dump, flightrec_maybe_dump,
                    flightrec_events, install_crash_hooks, FLIGHTREC)
from .steptrace import (span, current_span, record_span, StepTimeline,
                        model_flops, block_fwd_flops, cost_flops,
                        device_peak_flops)

__all__ = [
    "Counter", "Gauge", "Histogram", "StatsGroup", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "stats_group", "snapshot",
    "snapshot_json", "prometheus_text", "DEFAULT_BUCKETS",
    "span", "current_span", "record_span", "StepTimeline", "model_flops",
    "block_fwd_flops", "cost_flops", "device_peak_flops",
    "metrics_text", "scalar_snapshot", "start_metrics_server",
    "ensure_metrics_server", "mem_on_oom", "mem_install_oom_hook",
    "trace", "TraceContext", "current_context", "attach", "detach",
    "attached", "new_context", "child_context", "flightrec_record",
    "flightrec_dump", "flightrec_maybe_dump", "flightrec_events",
    "install_crash_hooks", "FLIGHTREC",
]

_register_env("MXNET_TELEMETRY", bool, True,
              "0 disables span recording and step-timeline collection "
              "(counters stay live — plain increments are free)")
_register_env("MXNET_METRICS_PORT", int, None,
              "When set, serve.Server.start() also serves the telemetry "
              "/metrics endpoint on this port (0 = ephemeral)")


def mem_on_oom(error, where=""):
    """Crash-path-safe proxy to `inspect.memory.on_oom`: the one wrapper
    every driver (run_resilient, the serve batcher, the continuous
    engine) calls from its exception path. It guards the import too: a
    failure to load the inspect package must never replace the original
    error on a crash path. Returns the dump path or None; never raises."""
    try:
        from ..inspect.memory import on_oom
        return on_oom(error, where=where)
    except Exception:
        return None


def mem_install_oom_hook():
    """Crash-path-safe proxy to `inspect.memory.install_oom_hook` (the
    sys.excepthook chain for uncaught OOMs), armed next to
    `install_crash_hooks` by the same drivers. Never raises."""
    try:
        from ..inspect.memory import install_oom_hook
        install_oom_hook()
    except Exception:
        pass


def metrics_text():
    """The full registry in Prometheus text format: what /metrics serves."""
    return prometheus_text()


def scalar_snapshot(nonzero=True):
    """Scalar metrics only (histogram dicts dropped), by default nonzero:
    the compact form a run log embeds."""
    out = {}
    for k, v in snapshot().items():
        if isinstance(v, dict) or (nonzero and not v):
            continue
        out[k] = v
    return out


def start_metrics_server(port=0, host="127.0.0.1"):
    """Serve `/metrics` (Prometheus text) and `/metrics.json` (snapshot)
    on a daemon thread. Returns the HTTPServer; `server.server_address`
    carries the bound (host, port) (port 0 takes an ephemeral one), and
    `server.shutdown()` stops the loop, closes the socket and joins the
    thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = snapshot_json().encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):      # no stderr chatter per scrape
            pass

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        block_on_close = True

        def shutdown(self):
            super().shutdown()
            self.server_close()
            self.thread.join()

    server = _Server((host, int(port)), _Handler)
    server.thread = _threading.Thread(target=server.serve_forever,
                                      name="mx-metrics", daemon=True)
    server.thread.start()
    return server


# process-wide /metrics endpoint (the MXNET_METRICS_PORT integration):
# one per process however many Servers start; no Server's close() tears it
# down under the others
_shared_metrics = {"server": None}
_shared_metrics_lock = _threading.Lock()


def ensure_metrics_server(port=0, host="127.0.0.1"):
    """Start (once) and return the process-wide /metrics endpoint. Repeat
    calls return the existing server whatever port they name."""
    with _shared_metrics_lock:
        if _shared_metrics["server"] is None:
            _shared_metrics["server"] = start_metrics_server(port, host)
        return _shared_metrics["server"]
