"""Base utilities of the PyTorch port: the error root, the environment-flag
layer and the dtype names.

Counterpart of `incubator_mxnet_tpu/base.py`. The port keeps its own copy
of what it needs from there (`MXNetError` and the typed errors, the flag
registry with `env_flags` / `get_env` / `set_env`, the dtype table), so
that it never imports the JAX package. Crash-consistent file writes are
`fault.atomic_output`.

The dtype table (`name_to_dtype`, `to_torch_dtype`, `from_torch_dtype`)
follows the JAX package with JAX's 64-bit types off, as it runs: an array
made from a float64 source is float32, from an int64 source int32, and no
op returns a 64-bit type. `bfloat16` has no numpy dtype without
`ml_dtypes`, which the port does not import: its dtype is `BFLOAT16`, a
string equal to "bfloat16" (the JAX package's `mx.np.bfloat16`) with a
dtype's `name` and `itemsize`.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["MXNetError", "NotImplementedForSymbol", "InternalError",
           "ValueError_", "TypeError_", "IndexError_", "AttributeError_",
           "NotImplementedError_", "get_env", "set_env", "env_flags",
           "torch_dtype", "BFLOAT16", "DTYPE_NAMES", "name_to_dtype",
           "dtype_to_name", "to_torch_dtype", "from_torch_dtype",
           "numeric_types", "integer_types", "string_types"]

string_types = (str,)
numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)


class MXNetError(RuntimeError):
    """Base error for all framework errors (reference: python/mxnet/error.py:27)."""


# the JAX package's typed errors: each an MXNetError, and the builtin it
# names where there is one
class InternalError(MXNetError):
    """Framework-internal invariant violation."""


class NotImplementedForSymbol(MXNetError):
    """Operation unavailable in traced/deferred mode."""


class ValueError_(MXNetError, ValueError):
    pass


class TypeError_(MXNetError, TypeError):
    pass


class IndexError_(MXNetError, IndexError):
    pass


class AttributeError_(MXNetError, AttributeError):
    pass


class NotImplementedError_(MXNetError, NotImplementedError):
    pass



# ---------------------------------------------------------------------------
# environment flag layer (reference: the documented MXNET_* knobs,
# env_var.md): name -> (type, default, help). Unknown flags still work
# through get_env(); registering gives introspection through env_flags().
# ---------------------------------------------------------------------------
_ENV_REGISTRY = {}


def _register_env(name, typ, default, doc):
    _ENV_REGISTRY[name] = (typ, default, doc)
    return name


def env_flags():
    """Return {name: (type, default, doc)} of registered flags (≙ env_var.md)."""
    return dict(_ENV_REGISTRY)


def get_env(name, default=None, typ=None):
    """dmlc::GetEnv equivalent: typed environment lookup with registry
    defaults (a registered flag's type and default apply where the caller
    gives none)."""
    if name in _ENV_REGISTRY:
        rtyp, rdefault, _ = _ENV_REGISTRY[name]
        typ = typ or rtyp
        if default is None:
            default = rdefault
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw not in ("0", "false", "False", "")
    if typ is None:
        return raw
    return typ(raw)


def set_env(name, value):
    """Mirror of mx.util.set_env."""
    os.environ[name] = str(value)


# The flags of the JAX package's registry that the port reads, with its
# types, defaults and help.
_register_env("MXNET_TEST_SEED", int, None, "Fixed seed for test reproducibility")
_register_env("MXNET_MODULE_SEED", int, None, "Module-level test seed")
_register_env("MXNET_DEFAULT_DEVICE", str, None,
              "Override default device, e.g. 'tpu(0)' or 'cpu(0)'")
_register_env("MXNET_FAULT_SPEC", str, None,
              "Arm fault injection: 'point:hit:kind[:arg],...' "
              "(see mx.fault)")
_register_env("MXNET_PREFETCH_RESTARTS", int, 3,
              "Bounded in-place retries for transient PrefetchingIter "
              "worker errors")
_register_env("MXNET_DATALOADER_RETRIES", int, 3,
              "Max attempts for a gluon DataLoader batch fetch on "
              "transient I/O errors")
_register_env("MXNET_PREFETCH_TO_DEVICE", bool, False,
              "Route gluon DataLoader batches through io.DeviceFeed: "
              "async H2D prefetch overlapping the train step")
_register_env("MXNET_DEVICE_FEED_DEPTH", int, 2,
              "io.DeviceFeed buffer depth (batches staged ahead; "
              "2 = double buffering)")
# serving (serve.Server, ContinuousEngine) and the fleet (serve.Fleet)
_register_env("MXNET_SERVE_MAX_QUEUE", int, 256,
              "Bound on queued inference requests (admission control)")
_register_env("MXNET_SERVE_BATCH_TIMEOUT_MS", float, 2.0,
              "Max wait to fill a batch after its first request")
_register_env("MXNET_SERVE_DEADLINE_MS", float, None,
              "Default per-request queue deadline (unset = none)")
_register_env("MXNET_SERVE_OVERLOAD_POLICY", str, "reject",
              "Queue-full behavior: 'reject' (newest) or 'shed' (oldest)")
_register_env("MXNET_SERVE_MAX_SLOTS", int, 8,
              "KV-cache slots in the continuous-batching engine = max "
              "concurrently-decoding requests (serve.KVCachePool)")
_register_env("MXNET_SERVE_PREFILL_BUDGET", int, 256,
              "Max prompt tokens prefilled per engine iteration "
              "(bounds prefill's added latency on in-flight decode)")
_register_env("MXNET_SERVE_DECODE_STEPS", int, 4,
              "Decode micro-iterations per dispatch in the continuous "
              "engine (host round-trip amortization)")
_register_env("MXNET_SERVE_PREFILL_LANES", int, None,
              "Fixed lane count of the prefill program (unset = "
              "min(max_slots, 8)); sized to the admission rate")
_register_env("MXNET_SERVE_KV_DTYPE", str, None,
              "KV pool storage dtype ('int8' = quantized codes + "
              "scales; unset = model dtype)")
_register_env("MXNET_SERVE_PREFIX_BLOCK", int, 16,
              "Shared-prefix cache granularity in tokens (prefixes "
              "cache and match on whole blocks only)")
_register_env("MXNET_SERVE_PREFIX_CACHE_SLOTS", int, 0,
              "Dedicated KV-pool rows holding shared-prefix KV for "
              "reuse across requests (0 = prefix cache off)")
_register_env("MXNET_SERVE_PREFIX_CACHE_INSERT", int, 1,
              "Publish a retiring request's own prompt prefix back "
              "into the shared-prefix cache (0 = read-only cache)")
_register_env("MXNET_FLEET_REPLICAS", int, 2,
              "Replica worker processes a serve.Fleet spawns")
_register_env("MXNET_FLEET_HEARTBEAT_MS", float, 500.0,
              "Fleet heartbeat interval; a replica missing "
              "`heartbeat_misses` consecutive beats is declared hung")
_register_env("MXNET_FLEET_RETRY_BUDGET", int, 2,
              "Failover retries per request before the original replica "
              "error surfaces to the client")
_register_env("MXNET_FLEET_DRAIN_TIMEOUT_MS", float, 30000.0,
              "Max wait for a draining replica to finish its resident "
              "requests before the swap hard-stops it (survivors absorb "
              "its in-flight via failover)")


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name):
    """The torch dtype of a float dtype name ("float32", "bfloat16",
    "float16"), the names `DecoderConfig` and `KVCachePool` take."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError(
            f"dtype {name!r} is not one of {sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------------
# the dtype table (the JAX package's `name_to_dtype`, with JAX's 32-bit
# defaults)
# ---------------------------------------------------------------------------
class _BFloat16(str):
    """The dtype of a bfloat16 array: equal to "bfloat16" (and to
    `mx.np.bfloat16`), with a numpy dtype's `name` and `itemsize`."""

    name = "bfloat16"
    itemsize = 2

    def __repr__(self):
        return "dtype(bfloat16)"


BFLOAT16 = _BFloat16("bfloat16")

# the dtype names arrays take (the reference's Python-visible names)
DTYPE_NAMES = (
    "float32", "float64", "float16", "bfloat16",
    "uint8", "int8", "int16", "int32", "int64", "bool",
)

_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int32, "uint16": torch.int32,
    "uint32": torch.int32, "uint64": torch.int32, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex64,
}
_FROM_TORCH = {
    torch.float32: _np.dtype("float32"), torch.float16: _np.dtype("float16"),
    torch.bfloat16: BFLOAT16, torch.uint8: _np.dtype("uint8"),
    torch.int8: _np.dtype("int8"), torch.int16: _np.dtype("int16"),
    torch.int32: _np.dtype("int32"), torch.int64: _np.dtype("int64"),
    torch.float64: _np.dtype("float64"), torch.bool: _np.dtype("bool"),
    torch.complex64: _np.dtype("complex64"),
    torch.complex128: _np.dtype("complex128"),
}
# what an op result of a 64-bit type becomes (JAX computes in 32 bits)
NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.complex128: torch.complex64}


def name_to_dtype(name):
    """A dtype name or object as a numpy dtype (`BFLOAT16` for bfloat16);
    None is float32."""
    if name is None:
        return _np.dtype("float32")
    if isinstance(name, torch.dtype):
        return from_torch_dtype(name)
    if isinstance(name, str) and name == "bfloat16":
        return BFLOAT16
    if getattr(name, "name", None) == "bfloat16":
        return BFLOAT16
    return _np.dtype(name)


def dtype_to_name(dtype):
    """The name of a dtype (a numpy dtype, `BFLOAT16` or a name):
    "bfloat16" for bfloat16, else numpy's name."""
    if getattr(dtype, "name", None) == "bfloat16" or dtype == "bfloat16":
        return "bfloat16"
    return _np.dtype(dtype).name


def to_torch_dtype(dtype):
    """The torch dtype an array of `dtype` holds: a 64-bit type as its
    32-bit one (the JAX package's arrays with 64-bit types off)."""
    if isinstance(dtype, torch.dtype):
        return NARROW.get(dtype, dtype)
    name = name_to_dtype(dtype).name
    try:
        return _TO_TORCH[name]
    except KeyError:
        raise MXNetError(f"dtype {name!r} has no array type") from None


def from_torch_dtype(dtype):
    """The numpy dtype (or `BFLOAT16`) of a torch dtype."""
    return _FROM_TORCH[dtype]
