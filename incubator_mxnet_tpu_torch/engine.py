"""mx.engine of the PyTorch port: the execution-engine facade.

Counterpart of `incubator_mxnet_tpu/engine.py`. PyTorch queues every op
on the device's stream as it is called, so the engine's surface maps as:

  Engine::WaitForVar   -> NDArray.wait_to_read (the tensor's stream)
  Engine::WaitForAll   -> waitall() (a device synchronize)
  op bulking           -> `bulk(size)` / `set_bulk_size` record the size
                          (override > `mx.tune` profile > env > default),
                          and nothing bulks: the JAX package defers eager
                          ops into one compiled segment; PyTorch has no
                          counterpart (CUDA-graph capture is ROADMAP A2)
  stats()              -> ops.registry.dispatch_stats()
  NaiveEngine          -> MXNET_ENGINE_TYPE=NaiveEngine or `set_naive(True)`:
                          every op dispatched through `ops.registry.invoke`
                          waits for the card before it returns (one op at
                          a time, as the reference's NaiveEngine); the
                          bulk size in force is then 0
"""
from __future__ import annotations

from contextlib import contextmanager

from .base import get_env

__all__ = ["bulk", "set_bulk_size", "current_bulk_size",
           "effective_bulk_size", "is_naive", "set_naive", "waitall",
           "wait_for_all", "stats"]

_bulk_size = [None]


def set_bulk_size(size):
    """Record the bulk size (≙ mx.engine.set_bulk_size); returns the
    previous one. Nothing bulks in the port."""
    prev = current_bulk_size()
    _bulk_size[0] = int(size)
    return prev


def current_bulk_size():
    if _bulk_size[0] is not None:
        return _bulk_size[0]
    # knob precedence: set_bulk_size override > deployment profile
    # (mx.tune) > MXNET_ENGINE_BULK_SIZE env > default
    from .tune.profile import resolve as _tune_resolve
    v = _tune_resolve("dispatch.bulk_size")
    if v is not None:
        return int(v)
    return int(get_env("MXNET_ENGINE_BULK_SIZE", 4096, int))


def effective_bulk_size():
    """The bulk size in force: 0 under NaiveEngine."""
    return 0 if is_naive() else current_bulk_size()


_naive = [None]  # None: follow MXNET_ENGINE_TYPE; a bool: set_naive's


def is_naive():
    """True under MXNET_ENGINE_TYPE=NaiveEngine (read at each call) unless
    `set_naive` overrode it."""
    if _naive[0] is not None:
        return _naive[0]
    return get_env("MXNET_ENGINE_TYPE") == "NaiveEngine"


def set_naive(value):
    """Turn synchronous dispatch on or off (None: follow the env var
    again). Returns the previous effective setting."""
    prev = is_naive()
    _naive[0] = value if value is None else bool(value)
    return prev


@contextmanager
def bulk(size):
    """≙ mx.engine.bulk: records `size` for its extent."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def waitall():
    from .ndarray import waitall as _waitall
    _waitall()


wait_for_all = waitall


def stats(reset=False):
    """The dispatch counters (`ops.registry.dispatch_stats`)."""
    from .ops.registry import dispatch_stats
    return dispatch_stats(reset=reset)
