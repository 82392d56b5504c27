"""Serving counters and percentiles of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/serve/metrics.py`: the process-wide
`SERVE_STATS` counters (a plain dict; every mutation holds `_STATS_LOCK`,
since `d[k] += n` is not atomic across threads), the prefix cache's
`PREFIX_STATS` (the JAX package's "prefix" stats group, here a plain dict
under `_PREFIX_LOCK`) and the nearest-rank `percentile`. The telemetry
registry and the per-Server `ServeMetrics` are not ported yet.
"""
from __future__ import annotations

import threading

__all__ = ["SERVE_STATS", "serve_stats", "PREFIX_STATS", "prefix_stats",
           "percentile"]

_STATS_LOCK = threading.Lock()

# Field meanings are those of the JAX package's SERVE_STATS (the
# continuous-batching decode_* family).
SERVE_STATS = {
    "requests": 0, "replies": 0, "rejected": 0, "timeouts": 0, "errors": 0,
    "decode_iterations": 0, "decode_tokens": 0,
    "decode_prefill_tokens": 0, "decode_admitted": 0, "decode_retired": 0,
    "decode_sampled_tokens": 0, "decode_draft_accepted": 0,
    "decode_draft_rejected": 0,
}

_PREFIX_LOCK = threading.Lock()

# Shared-prefix KV-cache counters (serve.prefix_cache), the JAX package's
# "prefix" group
PREFIX_STATS = {
    "hits": 0,           # acquiring lookups that reused a cached prefix
    "misses": 0,         # acquiring lookups that found nothing reusable
    "cached_tokens": 0,  # prompt tokens served from cache across all hits
    "evictions": 0,      # LRU-evicted entries (refcount 0 only, ever)
    "collisions": 0,     # hash hits rejected by the token-block verify
}


def _snapshot(stats, lock, reset):
    with lock:
        snap = dict(stats)
        if reset:
            for k in stats:
                stats[k] = 0
    return snap


def serve_stats(reset=False):
    """Snapshot of the process-wide serving counters; the snapshot and the
    optional reset are one atomic step."""
    return _snapshot(SERVE_STATS, _STATS_LOCK, reset)


def prefix_stats(reset=False):
    """Snapshot of the process-wide prefix-cache counters (atomic with the
    optional reset, the serve_stats() contract)."""
    return _snapshot(PREFIX_STATS, _PREFIX_LOCK, reset)


def percentile(sorted_vals, q):
    """Nearest-rank percentile over an already-sorted list (no numpy needed
    on the reply path)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]
