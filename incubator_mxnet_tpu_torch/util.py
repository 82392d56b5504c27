"""mx.util of the PyTorch port: the np-mode scopes and env helpers.

Counterpart of `incubator_mxnet_tpu/util.py`. NumPy semantics are always
on (there is no legacy nd / symbol split to toggle), so the np_shape /
np_array machinery is a set of no-ops that keep reference scripts running.
"""
from __future__ import annotations

import os

import torch

from .base import get_env, set_env

__all__ = ["use_np", "use_np_shape", "use_np_array", "np_shape", "np_array",
           "is_np_shape", "is_np_array", "set_np", "reset_np", "getenv",
           "setenv", "get_max_supported_compute_capability",
           "default_array", "makedirs"]


def is_np_shape():
    return True


def is_np_array():
    return True


def set_np(shape=True, array=True, dtype=None):
    pass


def reset_np():
    pass


class _NoOpScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, func):
        return func


def np_shape(active=True):
    return _NoOpScope()


def np_array(active=True):
    return _NoOpScope()


def use_np(func):
    """Decorator (≙ mx.util.use_np): numpy semantics are the default."""
    return func


use_np_shape = use_np
use_np_array = use_np


def getenv(name):
    return get_env(name)


def setenv(name, value):
    set_env(name, value)


def get_max_supported_compute_capability():
    """The compute capability of card 0 as major * 10 + minor (90 on an
    H100), 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    major, minor = torch.cuda.get_device_capability(0)
    return major * 10 + minor


def default_array(source_array, ctx=None, dtype=None):
    from .ndarray import array
    return array(source_array, device=ctx, dtype=dtype)


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)
