"""Samplers of the PyTorch port (≙ python/mxnet/gluon/data/sampler.py;
the JAX package's `gluon/data/sampler.py`, the same code)."""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "FilterSampler",
           "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        idx = _np.random.permutation(self._length)
        return iter(idx.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """≙ gluon.data.BatchSampler(keep/discard/rollover)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"invalid last_batch {last_batch!r}")
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return n // self._batch_size  # rollover
