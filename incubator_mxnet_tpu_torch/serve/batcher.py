"""Serving error types of the PyTorch port.

Counterpart of the error half of `incubator_mxnet_tpu/serve/batcher.py`
(`ServeError` and its subclasses, `_fail`). The stateless batching
`Server` and `BucketedModel` are not ported yet.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServeError", "QueueFullError", "RequestTimeout", "ServerClosed",
           "ReplicaDraining"]


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
