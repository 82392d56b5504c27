"""Vision datasets of the PyTorch port (≙ python/mxnet/gluon/data/vision/
datasets.py; the JAX package's `gluon/data/vision/datasets.py`, the same
code).

Datasets read the standard on-disk formats from a local `root` directory
(idx-ubyte for MNIST, pickled batches for CIFAR); nothing downloads: a
missing file raises and names the directory and the files searched.
Samples are NDArrays on the current device.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as _np

from ....base import MXNetError
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        from ....ndarray import array
        x = array(self._data[idx])
        y = int(self._label[idx])
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def _get_data(self):
        raise NotImplementedError


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError(f"bad MNIST image magic in {path}")
        data = _np.frombuffer(f.read(), dtype=_np.uint8)
        return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError(f"bad MNIST label magic in {path}")
        return _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)


def _find(root, names):
    for n in names:
        p = os.path.join(root, n)
        if os.path.exists(p):
            return p
    raise MXNetError(
        f"dataset files not found under {root} (searched {names}); this "
        "package downloads nothing — place the files locally")


class MNIST(_DownloadedDataset):
    """≙ gluon.data.vision.MNIST (idx-ubyte files under root)."""

    _prefix = ""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        part = "train" if self._train else "t10k"
        img = _find(self._root, [f"{part}-images-idx3-ubyte",
                                 f"{part}-images-idx3-ubyte.gz"])
        lab = _find(self._root, [f"{part}-labels-idx1-ubyte",
                                 f"{part}-labels-idx1-ubyte.gz"])
        self._data = _read_idx_images(img)
        self._label = _read_idx_labels(lab)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """≙ gluon.data.vision.CIFAR10 (python pickled batches under root)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        datas, labels = [], []
        for name in self._batches():
            p = _find(self._root, [name,
                                   os.path.join("cifar-10-batches-py", name)])
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(d[b"data"].reshape(-1, 3, 32, 32)
                         .transpose(0, 2, 3, 1))
            labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        self._data = _np.concatenate(datas, axis=0)
        self._label = _np.asarray(labels, dtype=_np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batches(self):
        return ["train" if self._train else "test"]

    def _get_data(self):
        name = self._batches()[0]
        p = _find(self._root, [name, os.path.join("cifar-100-python", name)])
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self._data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._label = _np.asarray(d[key], dtype=_np.int32)


class ImageRecordDataset(Dataset):
    """≙ gluon.data.vision.ImageRecordDataset — .rec of packed images.
    Needs an image codec for decode; raw payload access works without."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._rec = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._rec)

    def payload(self, idx):
        """Raw IRHeader-packed record bytes — no decode, no NDArray wrap
        (the ImageRecordIter PIL fallback and the shm decode workers parse
        these through `io._imagerec_common.parse_record` instead of paying
        a device round-trip per image)."""
        return self._rec[idx]

    def __getitem__(self, idx):
        from ....recordio import unpack
        header, payload = unpack(self._rec[idx])
        img = _decode_image(payload, self._flag)
        from ....ndarray import array
        x = array(img)
        label = header.label
        if self._transform is not None:
            return self._transform(x, label)
        return x, label


def _decode_image(payload, flag):
    try:
        import io
        from PIL import Image
        img = Image.open(io.BytesIO(payload))
        if flag == 0:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        arr = _np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    except ImportError:
        raise MXNetError("image decode needs PIL, which is unavailable; "
                         "store raw arrays in the record payload instead")


class ImageFolderDataset(Dataset):
    """≙ gluon.data.vision.ImageFolderDataset: root/label/img.jpg layout."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(exts):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        with open(path, "rb") as f:
            img = _decode_image(f.read(), self._flag)
        from ....ndarray import array
        x = array(img)
        if self._transform is not None:
            return self._transform(x, label)
        return x, label
