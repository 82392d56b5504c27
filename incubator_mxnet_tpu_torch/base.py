"""Base utilities of the PyTorch port: the error root, the environment-flag
lookup, the dtype names and atomic file writes.

Counterpart of `incubator_mxnet_tpu/base.py`. The port keeps its own copy
of what it needs from there (`MXNetError`, `get_env`), so that it never
imports the JAX package.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager

import torch

__all__ = ["MXNetError", "get_env", "torch_dtype", "atomic_output"]


class MXNetError(RuntimeError):
    """Base error for all framework errors (reference: python/mxnet/error.py:27)."""


def get_env(name, default=None, typ=None):
    """dmlc::GetEnv equivalent: typed environment lookup. `default` is
    returned when the variable is unset."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw not in ("0", "false", "False", "")
    if typ is None:
        return raw
    return typ(raw)


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@contextmanager
def atomic_output(path):
    """A binary file object whose contents replace `path` only when the
    block ends without an error (written beside it, then renamed), so a
    failure never leaves a truncated file."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            yield f
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def torch_dtype(name):
    """The torch dtype of a float dtype name ("float32", "bfloat16",
    "float16"), the names `DecoderConfig` and `KVCachePool` take."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError(
            f"dtype {name!r} is not one of {sorted(_DTYPES)}") from None
