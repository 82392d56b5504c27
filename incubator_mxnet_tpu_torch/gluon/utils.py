"""gluon.utils of the PyTorch port: `split_data`, `split_and_load`,
`clip_global_norm`, `check_sha1` and `download`.

Counterpart of `incubator_mxnet_tpu/gluon/utils.py`. Devices are
`torch.device`s, their names or `mx.Device`s; NDArray data gives NDArray
slices (tensors give tensors). `clip_global_norm` scales in place as
the JAX package's `npx.clip_by_global_norm` does (the norm over the
squares of every array, each array times max_norm / max(norm, max_norm)),
with plain torch ops and without reading the norm back to the host: the
scale stays a device tensor, and an array already within the norm is
multiplied by exactly 1. `download` raises: nothing of the port needs the
network.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..base import MXNetError
from ..device import resolve_device
from ..ndarray import NDArray, _wrap

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def _as_tensor(data):
    if isinstance(data, NDArray):
        return data._t
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(data))


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis`, each of size //
    num_slice rows (a remainder on axis 0 is dropped when `even_split` is
    False; on another axis the split must be even)."""
    data = _as_tensor(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    if batch_axis == 0:
        return [data[i * step:(i + 1) * step] for i in range(num_slice)]
    if size % num_slice != 0:
        raise MXNetError(f"axis {batch_axis} of size {size} does not split "
                         f"evenly into {num_slice}")
    return list(torch.split(data, step, dim=batch_axis))


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """`data` split along `batch_axis` over the devices of `ctx_list`, one
    slice each; with one device, `[data]` moved there."""
    nd = isinstance(data, NDArray)
    data = _as_tensor(data)
    if len(ctx_list) == 1:
        out = [data.to(resolve_device(ctx_list[0]))]
    else:
        slices = split_data(data, len(ctx_list), batch_axis, even_split)
        out = [s.to(resolve_device(c)) for s, c in zip(slices, ctx_list)]
    return [_wrap(o) for o in out] if nd else out


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so their global L2 norm is at most
    `max_norm`; returns the norm before scaling (a float32 0-d tensor on
    the arrays' device)."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    arrays = [getattr(a, "_t", a) for a in arrays]
    total = arrays[0].float().square().sum()
    for a in arrays[1:]:
        total = total + a.float().square().sum()
    norm = total.sqrt()
    scale = float(max_norm) / torch.clamp(norm, min=float(max_norm))
    with torch.no_grad():
        for a in arrays:
            a.mul_(scale.to(a.dtype))
    return norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises: the port fetches nothing over the network."""
    raise MXNetError(
        "download() needs network access, which the port does not use; "
        "place files locally and load them directly")
