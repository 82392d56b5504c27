"""Serving in the PyTorch port: the continuous-batching decode engine.

Counterpart of `incubator_mxnet_tpu/serve/`. Ported so far: the engine
(`ContinuousEngine`: greedy and sampled requests, speculative decode,
float or int8 KV, the shared-prefix cache) over a cached-KV decoder
(`CachedDecoder`), its slot pool (`KVCachePool`) and prefix cache
(`PrefixCache`), the error types, and the process-wide counters. The
stateless `Server`, replicas and the fleet are not ported yet.
"""
from .batcher import (ServeError, QueueFullError, RequestTimeout,
                      ServerClosed, ReplicaDraining)
from .continuous import (DecoderConfig, CachedDecoder, ContinuousEngine,
                         init_decoder_params, params_from_jax)
from .kv_pool import KVCachePool, SlotsFullError
from .metrics import SERVE_STATS, serve_stats, percentile
from .prefix_cache import PrefixCache, PrefixCacheError, prefix_stats

__all__ = ["ServeError", "QueueFullError", "RequestTimeout", "ServerClosed",
           "ReplicaDraining", "DecoderConfig", "CachedDecoder",
           "ContinuousEngine", "init_decoder_params", "params_from_jax",
           "KVCachePool", "SlotsFullError", "PrefixCache",
           "PrefixCacheError", "prefix_stats",
           "SERVE_STATS", "serve_stats", "percentile"]
