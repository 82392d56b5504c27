"""Serving in the PyTorch port.

Counterpart of `incubator_mxnet_tpu/serve/`, with its surface:

  serve.Server          thread-safe bounded queue + dynamic batcher:
                        concurrent requests coalesce into padded batch
                        buckets, run through one program per bucket, and
                        split back into per-request futures (numpy)
  serve.BucketedModel   bucket -> `deploy.ExportedModel` map
                        (`export_block` makes the per-bucket artifacts)
  serve.CallableModel   the same contract over an in-process torch callable
  serve.stats()         process-wide serving counters; per-server metrics
                        (requests/s, p50/p95/p99, batch occupancy, queue
                        depth, queue-wait vs execute) via `Server.stats()`
  serve.metrics_text()  Prometheus text of the telemetry registry;
                        `serve.start_metrics_server(port)` (or
                        MXNET_METRICS_PORT at `Server.start()`) serves it
  serve.ContinuousEngine  iteration-level batching decode engine over a
                        cached-KV decoder (`CachedDecoder`), its slot pool
                        (`KVCachePool`) and prefix cache (`PrefixCache`)
  serve.Fleet           replica supervisor + router over
                        `serve.replica` processes: failover, respawn,
                        prefix affinity, rolling drain-and-swap

Requests are traced (`telemetry.trace`: one trace per request, across
the batcher's queue and a fleet's replica hop). The engine's and the
batcher's knobs resolve through `mx.tune` profiles, and a replica boots
on the profile of its (model, hardware) fingerprints; the engine counts
its programs' signatures (`compile_cache_size`, `assert_no_retraces`)
and runs under `mx.sanitize`'s modes. The rest of the compile surface
(CUDA-graph capture, memory plans) waits for ROADMAP A2/A3.
"""
from .batcher import (ServeError, QueueFullError, RequestTimeout,
                      ServerClosed, ReplicaDraining, BucketedModel,
                      CallableModel, Server, pick_bucket)
from .continuous import (DecoderConfig, CachedDecoder, ContinuousEngine,
                         init_decoder_params, params_from_jax)
from .kv_pool import KVCachePool, SlotsFullError
from .metrics import (SERVE_STATS, ServeMetrics, serve_stats, percentile,
                      metrics_text, start_metrics_server)
from .prefix_cache import PrefixCache, PrefixCacheError, prefix_stats
from .fleet import Fleet, FleetError, ReplicaDied, FLEET_STATS, fleet_stats

stats = serve_stats

__all__ = ["Server", "BucketedModel", "CallableModel", "pick_bucket",
           "ServeError", "QueueFullError", "RequestTimeout", "ServerClosed",
           "ReplicaDraining", "ServeMetrics", "SERVE_STATS", "stats",
           "serve_stats", "percentile", "metrics_text",
           "start_metrics_server",
           "DecoderConfig", "CachedDecoder", "ContinuousEngine",
           "init_decoder_params", "params_from_jax",
           "KVCachePool", "SlotsFullError", "PrefixCache",
           "PrefixCacheError", "prefix_stats",
           "Fleet", "FleetError", "ReplicaDied", "FLEET_STATS",
           "fleet_stats"]
