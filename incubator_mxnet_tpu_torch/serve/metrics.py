"""Serving counters, percentiles and per-server metrics of the PyTorch
port.

Counterpart of `incubator_mxnet_tpu/serve/metrics.py`: the process-wide
`SERVE_STATS` counters and the prefix cache's `PREFIX_STATS`, adopted into
the telemetry registry as the `serve` and `prefix` stats groups (every
mutation holds the group's lock, since `d[k] += n` is not atomic across
threads), the nearest-rank `percentile`, and `ServeMetrics`, one
`Server`'s own view: requests/s, p50/p95/p99 latency over a bounded
reservoir, the batch-occupancy histogram keyed by bucket, queue depth, and
the request timeline that splits queue-wait from execute time, with the
slowest requests' trace ids.

`metrics_text()` is the telemetry registry's Prometheus text (every stats
group and metric of the process, under the JAX package's names), and
`start_metrics_server(port)` serves it at `/metrics`.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque

from ..telemetry import (REGISTRY, metrics_text, start_metrics_server,
                         ensure_metrics_server)

__all__ = ["SERVE_STATS", "serve_stats", "PREFIX_STATS", "prefix_stats",
           "percentile", "ServeMetrics", "metrics_text",
           "start_metrics_server", "ensure_metrics_server"]

_STATS_LOCK = threading.Lock()

# Field meanings are those of the JAX package's SERVE_STATS (the
# continuous-batching decode_* family).
SERVE_STATS = REGISTRY.stats_group("serve", {
    "requests": 0, "replies": 0, "rejected": 0, "shed": 0,
    "timeouts": 0, "errors": 0, "batches": 0, "padded_rows": 0,
    "programs_compiled": 0,
    "decode_iterations": 0, "decode_tokens": 0,
    "decode_prefill_tokens": 0, "decode_admitted": 0, "decode_retired": 0,
    "decode_sampled_tokens": 0, "decode_draft_accepted": 0,
    "decode_draft_rejected": 0,
}, lock=_STATS_LOCK,
    help="process-wide serving counters (profiler.serve_stats)")

_PREFIX_LOCK = threading.Lock()

# Shared-prefix KV-cache counters (serve.prefix_cache), the JAX package's
# "prefix" group
PREFIX_STATS = REGISTRY.stats_group("prefix", {
    "hits": 0,           # acquiring lookups that reused a cached prefix
    "misses": 0,         # acquiring lookups that found nothing reusable
    "cached_tokens": 0,  # prompt tokens served from cache across all hits
    "evictions": 0,      # LRU-evicted entries (refcount 0 only, ever)
    "collisions": 0,     # hash hits rejected by the token-block verify
}, lock=_PREFIX_LOCK,
    help="Shared-prefix KV-cache counters (serve.prefix_cache."
         "prefix_stats)")


def serve_stats(reset=False):
    """Snapshot of the process-wide serving counters; the snapshot and the
    optional reset are one atomic step."""
    return SERVE_STATS.snapshot(reset=reset)


def prefix_stats(reset=False):
    """Snapshot of the process-wide prefix-cache counters (atomic with the
    optional reset, the serve_stats() contract)."""
    return PREFIX_STATS.snapshot(reset=reset)


def percentile(sorted_vals, q):
    """Nearest-rank percentile over an already-sorted list (no numpy needed
    on the reply path)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServeMetrics:
    """Per-Server metrics. Every mutator takes the internal lock;
    `snapshot` returns plain data safe to json.dumps."""

    LATENCY_WINDOW = 4096    # bounded reservoir: recent-request percentiles
    SLOWEST_K = 8            # top-K slowest-request table in the timeline

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._lat_ms = deque(maxlen=self.LATENCY_WINDOW)
        self._occupancy = {}     # bucket -> [batches, rows, padded rows]
        self.counters = {k: 0 for k in SERVE_STATS}
        self.queue_depth = 0
        self.queue_depth_max = 0
        # time requests spent queued (summed per request) against the
        # batches' execution time (summed per batch)
        self.queue_wait_ms_total = 0.0
        self.exec_ms_total = 0.0
        self._slowest = []       # min-heap of (total_ms, seq, row)
        self._slow_seq = 0

    def count(self, key, n=1):
        with self._lock:
            self.counters[key] += n
        with _STATS_LOCK:
            SERVE_STATS[key] += n

    def set_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth
            self.queue_depth_max = max(self.queue_depth_max, depth)

    def observe_batch(self, bucket, occupancy, exec_ms, queue_depth,
                      queue_wait_ms=0.0, member_traces=None):
        """One executed batch: `occupancy` rows served out of `bucket`;
        `queue_wait_ms` is the sum over its requests of their time
        queued; `member_traces` the trace ids of its requests, which the
        `serve.batch` span links."""
        pad = bucket - occupancy
        with self._lock:
            self.counters["batches"] += 1
            self.counters["padded_rows"] += pad
            row = self._occupancy.setdefault(bucket, [0, 0, 0])
            row[0] += 1
            row[1] += occupancy
            row[2] += pad
            self.queue_depth = queue_depth
            self.queue_depth_max = max(self.queue_depth_max, queue_depth)
            self.queue_wait_ms_total += queue_wait_ms
            self.exec_ms_total += exec_ms
        with _STATS_LOCK:
            SERVE_STATS["batches"] += 1
            SERVE_STATS["padded_rows"] += pad
        # the `serve.batch` span lane, only while a collector can consume
        # it (this runs on the batcher thread, once a batch)
        from ..telemetry import record_span, trace as _trace
        if _trace.enabled() and _trace.collector_active():
            extra = {}
            if member_traces:
                extra["member_traces"] = ",".join(member_traces[:16])
                extra["n_member_traces"] = len(member_traces)
            record_span("serve.batch", exec_ms * 1000.0, cat="serve",
                        bucket=bucket, occupancy=occupancy,
                        queue_depth=queue_depth, **extra)

    def observe_latency(self, ms):
        with self._lock:
            self._lat_ms.append(ms)

    def observe_request(self, total_ms, trace_id=None, queue_wait_ms=0.0,
                        exec_ms=0.0, batch_size=None,
                        deadline_margin_ms=None):
        """Keep the K slowest requests seen (a bounded min-heap); the row
        is built only for a request that enters the table."""
        with self._lock:
            if len(self._slowest) >= self.SLOWEST_K \
                    and total_ms <= self._slowest[0][0]:
                return
            row = {"total_ms": round(total_ms, 3),
                   "trace_id": trace_id,
                   "queue_wait_ms": round(queue_wait_ms, 3),
                   "exec_ms": round(exec_ms, 3),
                   "batch_size": batch_size,
                   "deadline_margin_ms": (round(deadline_margin_ms, 3)
                                          if deadline_margin_ms is not None
                                          else None)}
            self._slow_seq += 1
            item = (total_ms, self._slow_seq, row)
            if len(self._slowest) < self.SLOWEST_K:
                heapq.heappush(self._slowest, item)
            else:
                heapq.heapreplace(self._slowest, item)

    def snapshot(self):
        with self._lock:
            lat = sorted(self._lat_ms)
            elapsed = time.perf_counter() - self._t0
            counters = dict(self.counters)
            occ = {b: {"batches": r[0], "rows": r[1], "padded": r[2],
                       "mean_occupancy": round(r[1] / (r[0] * b), 4)}
                   for b, r in sorted(self._occupancy.items())}
            depth, depth_max = self.queue_depth, self.queue_depth_max
            wait_ms, exec_ms = self.queue_wait_ms_total, self.exec_ms_total
            slowest = [row for _, _, row in
                       sorted(self._slowest, reverse=True)]
        out = dict(counters)
        out["queue_depth"] = depth
        out["queue_depth_max"] = depth_max
        out["batch_occupancy"] = occ
        out["elapsed_s"] = round(elapsed, 3)
        out["requests_per_sec"] = round(
            counters["replies"] / elapsed, 2) if elapsed > 0 else 0.0
        for q in (50, 95, 99):
            v = percentile(lat, q)
            out[f"p{q}_ms"] = round(v, 3) if v is not None else None
        busy = wait_ms + exec_ms
        out["timeline"] = {
            "queue_wait_ms": round(wait_ms, 3),
            "exec_ms": round(exec_ms, 3),
            "queue_wait_pct": round(100.0 * wait_ms / busy, 2) if busy
            else 0.0,
            "exec_pct": round(100.0 * exec_ms / busy, 2) if busy else 0.0,
            "slowest": slowest,
        }
        return out

    def prometheus_lines(self, server="serve"):
        """This server's gauges in the Prometheus text format, under the
        JAX package's names (`mx_server_*{server="..."}`)."""
        snap = self.snapshot()
        lab = f'{{server="{_prom_label_value(server)}"}}'
        lines = [f"mx_server_{k}{lab} {snap[k]}"
                 for k in ("queue_depth", "queue_depth_max",
                           "requests_per_sec", "elapsed_s")]
        for q in (50, 95, 99):
            v = snap[f"p{q}_ms"]
            if v is not None:
                lines.append(f"mx_server_latency_p{q}_ms{lab} {v}")
        tl = snap["timeline"]
        lines.append(f"mx_server_queue_wait_ms_total{lab} "
                     f"{tl['queue_wait_ms']}")
        lines.append(f"mx_server_exec_ms_total{lab} {tl['exec_ms']}")
        return lines


def _prom_label_value(v):
    """Escape a label value (backslash, double quote, newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")
