"""Serving counters and percentiles of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/serve/metrics.py`: the process-wide
`SERVE_STATS` counters (a plain dict; every mutation holds `_STATS_LOCK`,
since `d[k] += n` is not atomic across threads) and the nearest-rank
`percentile`. The telemetry registry and the per-Server `ServeMetrics`
are not ported yet.
"""
from __future__ import annotations

import threading

__all__ = ["SERVE_STATS", "serve_stats", "percentile"]

_STATS_LOCK = threading.Lock()

# Field meanings are those of the JAX package's SERVE_STATS (the
# continuous-batching decode_* family).
SERVE_STATS = {
    "requests": 0, "replies": 0, "rejected": 0, "timeouts": 0, "errors": 0,
    "decode_iterations": 0, "decode_tokens": 0,
    "decode_prefill_tokens": 0, "decode_admitted": 0, "decode_retired": 0,
}


def serve_stats(reset=False):
    """Snapshot of the process-wide serving counters; the snapshot and the
    optional reset are one atomic step."""
    with _STATS_LOCK:
        snap = dict(SERVE_STATS)
        if reset:
            for k in SERVE_STATS:
                SERVE_STATS[k] = 0
    return snap


def percentile(sorted_vals, q):
    """Nearest-rank percentile over an already-sorted list (no numpy needed
    on the reply path)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]
