"""Datasets of the PyTorch port (≙ python/mxnet/gluon/data/dataset.py + the
C++ 2.0 datasets src/io/dataset.cc — random-access only; streaming
iterators live in mx.io). Counterpart of
`incubator_mxnet_tpu/gluon/data/dataset.py`, the same code."""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Random-access dataset (≙ gluon.data.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """≙ Dataset.filter."""
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        """≙ Dataset.shard — partition for multi-worker loading."""
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        count = min(count, len(self))
        return SimpleDataset([self[i] for i in range(count)])

    def transform(self, fn, lazy=True):
        """≙ Dataset.transform."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """≙ Dataset.transform_first."""
        return self.transform(_first_wrapper(fn), lazy)


def _first_wrapper(fn):
    def _f(sample):
        if isinstance(sample, tuple):
            return (fn(sample[0]),) + sample[1:]
        return fn(sample)
    return _f


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple) and _accepts_multi(self._fn, len(item)):
            return self._fn(*item)
        return self._fn(item)


def _accepts_multi(fn, n):
    import inspect
    try:
        sig = inspect.signature(fn)
        params = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        if any(p.kind == inspect.Parameter.VAR_POSITIONAL
               for p in sig.parameters.values()):
            return True
        return len(params) >= n
    except (TypeError, ValueError):
        return False


class SimpleDataset(Dataset):
    """List wrapper (≙ gluon.data.SimpleDataset)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (≙ gluon.data.ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all inputs must have the same length")
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Record file dataset over .rec/.idx (≙ gluon.data.RecordFileDataset,
    C++ fast path src/io/dataset.cc RecordFileDataset)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
