"""Serving in the PyTorch port: the continuous-batching decode engine.

Counterpart of `incubator_mxnet_tpu/serve/`. Ported so far: the engine
(`ContinuousEngine`) over a cached-KV decoder (`CachedDecoder`) and its
slot pool (`KVCachePool`), greedy requests only, the error types, and the
process-wide counters. The stateless `Server`, the prefix cache, replicas
and the fleet are not ported yet.
"""
from .batcher import (ServeError, QueueFullError, RequestTimeout,
                      ServerClosed, ReplicaDraining)
from .continuous import (DecoderConfig, CachedDecoder, ContinuousEngine,
                         init_decoder_params, params_from_jax)
from .kv_pool import KVCachePool, SlotsFullError
from .metrics import SERVE_STATS, serve_stats, percentile

__all__ = ["ServeError", "QueueFullError", "RequestTimeout", "ServerClosed",
           "ReplicaDraining", "DecoderConfig", "CachedDecoder",
           "ContinuousEngine", "init_decoder_params", "params_from_jax",
           "KVCachePool", "SlotsFullError",
           "SERVE_STATS", "serve_stats", "percentile"]
