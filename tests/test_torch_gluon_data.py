"""PyTorch port: `gluon.data` — datasets, samplers, batchify, DataLoader
(threads, spawned worker processes, the device feed), the vision
transforms and the MNIST / CIFAR / image-record / image-folder datasets
over files the test writes — each against the JAX package on the CPU from
the same inputs. Exact, but Resize (float32 sums of the same weights in
another order: 1e-5) and the float transforms (1e-6)."""
import gzip
import io as pyio
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf

torch.set_num_threads(1)

CPU = tmx.cpu()
R = np.random.RandomState(0)
IMGS = R.randint(0, 256, (10, 6, 5, 3)).astype(np.uint8)
LABELS = np.arange(10, dtype=np.int32)


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want, rtol=0.0):
    got, want = _np(got), _np(want)
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------
def test_dataset_views_match_jax():
    for mod in (jdata, tdata):
        ds = mod.ArrayDataset(IMGS, LABELS)
        assert len(ds) == 10
    j, t = jdata.ArrayDataset(IMGS, LABELS), tdata.ArrayDataset(IMGS, LABELS)
    _same(t[3], j[3])
    even = lambda s: s[1] % 2 == 0                    # noqa: E731
    assert [s[1] for s in t.filter(even)] == [s[1] for s in j.filter(even)]
    for k in range(3):
        assert [s[1] for s in t.shard(3, k)] == [s[1] for s in j.shard(3, k)]
    assert [s[1] for s in t.take(4)] == [s[1] for s in j.take(4)]
    f = lambda x, y: (x.astype(np.float32) * 2, y + 1)  # noqa: E731
    _same(t.transform(f)[2], j.transform(f)[2])
    _same(t.transform(f, lazy=False)[5], j.transform(f, lazy=False)[5])
    g = lambda x: x[:2]                               # noqa: E731
    _same(t.transform_first(g)[1], j.transform_first(g)[1])
    assert tdata.SimpleDataset([1, 2, 3])[2] == 3
    with pytest.raises(MXNetError, match="same length"):
        tdata.ArrayDataset(IMGS, LABELS[:3])


def test_record_file_dataset_reads_the_jax_packages_files(tmp_path):
    from incubator_mxnet_tpu import recordio as jrec
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 5
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last):
    assert list(tdata.SequentialSampler(5, 2)) == list(
        jdata.SequentialSampler(5, 2))
    np.random.seed(5)
    want = list(jdata.RandomSampler(9))
    np.random.seed(5)
    assert list(tdata.RandomSampler(9)) == want
    ds = list(range(10))
    assert list(tdata.FilterSampler(lambda v: v % 3 == 0, ds)) == list(
        jdata.FilterSampler(lambda v: v % 3 == 0, ds))
    tb = tdata.BatchSampler(tdata.SequentialSampler(10), 4, last)
    jb = jdata.BatchSampler(jdata.SequentialSampler(10), 4, last)
    for _ in range(2):                 # rollover carries into the next pass
        assert list(tb) == list(jb)
        assert len(tb) == len(jb)
    with pytest.raises(MXNetError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "drop")


def test_batchify_matches_jax():
    from incubator_mxnet_tpu.gluon.data import batchify as jb
    from incubator_mxnet_tpu_torch.gluon.data import batchify as tb
    ragged = [np.arange(n, dtype=np.float32) for n in (3, 1, 4)]
    pairs = [(IMGS[i], np.arange(i + 1, dtype=np.int32)) for i in range(3)]
    with tmx.cpu():
        _same(tb.Stack()(list(IMGS[:4])), jb.Stack()(list(IMGS[:4])))
        _same(tb.Pad(val=-1)(ragged), jb.Pad(val=-1)(ragged))
        _same(tb.Pad(val=0, dtype="int32")(ragged),
              jb.Pad(val=0, dtype="int32")(ragged))
        _same(tb.Group(tb.Stack(), tb.Pad(val=9))(pairs),
              jb.Group(jb.Stack(), jb.Pad(val=9))(pairs))
    with pytest.raises(MXNetError, match="2 functions"):
        tb.Group(tb.Stack(), tb.Stack())([(1,)])


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------
def _loader_batches(mod, **kw):
    ds = mod.ArrayDataset(IMGS, LABELS)
    return [_np(b) for b in mod.DataLoader(ds, **kw)]


LOADERS = {
    "plain": dict(batch_size=4),
    "discard": dict(batch_size=4, last_batch="discard"),
    "threads": dict(batch_size=3, num_workers=2),
    "threads-no-prefetch": dict(batch_size=3, num_workers=2, prefetch=0),
    "device-feed": dict(batch_size=4, prefetch_to_device=True),
    "device-feed-threads": dict(batch_size=4, num_workers=2,
                                prefetch_to_device=True),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_dataloader_batches_match_jax(name):
    want = _loader_batches(jdata, **LOADERS[name])
    with tmx.cpu():
        got = _loader_batches(tdata, **LOADERS[name])
    _same(got, want)


def test_spawned_process_workers_give_the_same_batches():
    """Two spawned workers build numpy batches in shared memory, with the
    card hidden from them; the parent's batches equal `num_workers=0`'s,
    with and without the device feed."""
    with tmx.cpu():
        want = _loader_batches(tdata, batch_size=3)
        got = _loader_batches(tdata, batch_size=3, num_workers=2,
                              thread_pool=False)
        fed = _loader_batches(tdata, batch_size=3, num_workers=2,
                              thread_pool=False, prefetch_to_device=True)
    _same(got, want)
    _same(fed, want)
    _same(got, _loader_batches(jdata, batch_size=3, num_workers=2,
                               thread_pool=False))


class _EnvProbe:
    """A dataset whose samples report the worker's CUDA environment."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.array([os.environ.get("CUDA_VISIBLE_DEVICES") == "",
                         "torch.cuda" in __import__("sys").modules
                         and __import__("torch").cuda.is_initialized()],
                        np.int32)


def test_process_workers_never_see_the_card():
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    with tmx.cpu():
        (batch,) = list(tdata.DataLoader(_EnvProbe(), batch_size=4,
                                         num_workers=2, thread_pool=False))
    np.testing.assert_array_equal(batch.asnumpy(), [[1, 0]] * 4)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before


def test_dataloader_knobs_and_refusals():
    ds = tdata.ArrayDataset(IMGS, LABELS)
    with pytest.raises(MXNetError, match="batch_size required"):
        tdata.DataLoader(ds)
    with pytest.raises(MXNetError, match="shuffle conflicts"):
        tdata.DataLoader(ds, 2, shuffle=True,
                         sampler=tdata.SequentialSampler(10))
    with pytest.raises(MXNetError, match="batch_sampler conflicts"):
        tdata.DataLoader(ds, 2, batch_sampler=tdata.BatchSampler(
            tdata.SequentialSampler(10), 2))
    assert len(tdata.DataLoader(ds, 3)) == 4
    with pytest.raises(MXNetError, match="cuda"):
        next(iter(tdata.DataLoader(ds, 3)))        # the card by default


def test_a_stalled_thread_worker_times_out():
    import threading
    gate = threading.Event()

    class Slow:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            gate.wait(5)
            return np.zeros(1, np.float32)

    with tmx.cpu():
        with pytest.raises(MXNetError, match="exceeded"):
            list(tdata.DataLoader(Slow(), batch_size=1, num_workers=1,
                                  timeout=0.2))
    gate.set()


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
IMG = R.randint(0, 256, (20, 24, 3)).astype(np.uint8)

TRANSFORMS = {
    "ToTensor": (lambda m: m.ToTensor(), 0.0),
    "Cast": (lambda m: m.Cast("float16"), 0.0),
    "Normalize": (lambda m: m.Compose([m.ToTensor(), m.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.25, 0.3))]), 1e-6),
    "Resize-down": (lambda m: m.Resize((11, 7)), 1e-5),
    "Resize-up": (lambda m: m.Resize(30), 1e-5),
    "Resize-keep-ratio": (lambda m: m.Resize(12, keep_ratio=True), 1e-5),
    "CenterCrop": (lambda m: m.CenterCrop((10, 8)), 0.0),
    "CenterCrop-upsized": (lambda m: m.CenterCrop(26), 1e-5),
    "RandomCrop": (lambda m: m.RandomCrop(9), 0.0),
    "RandomCrop-pad": (lambda m: m.RandomCrop((16, 12), pad=2), 0.0),
    "RandomResizedCrop": (lambda m: m.RandomResizedCrop(10), 1e-5),
    "RandomFlipLeftRight": (lambda m: m.RandomFlipLeftRight(0.5), 0.0),
    "RandomFlipTopBottom": (lambda m: m.RandomFlipTopBottom(0.5), 0.0),
    "CropResize": (lambda m: m.CropResize(2, 3, 10, 8, size=(6, 6)), 1e-5),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make, rtol = TRANSFORMS[name]
    for seed in (1, 2, 3):
        np.random.seed(seed)
        want = make(jtf)(jmx.np.array(IMG))
        np.random.seed(seed)
        got = make(ttf)(tmx.np.array(IMG, device=CPU))
        _same(got, want, rtol)
    if name == "RandomCrop-pad":
        return          # the JAX package pads an HWC image only
    # a batch too (NHWC)
    batch = np.stack([IMG, IMG[::-1]])
    np.random.seed(7)
    want = make(jtf)(jmx.np.array(batch))
    np.random.seed(7)
    _same(make(ttf)(tmx.np.array(batch, device=CPU)), want, rtol)


# ---------------------------------------------------------------------------
# vision datasets over local files
# ---------------------------------------------------------------------------
def _write_mnist(root, part, n, gz):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(n)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with opener(os.path.join(root, f"{part}-images-idx3-ubyte{sfx}"),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(os.path.join(root, f"{part}-labels-idx1-ubyte{sfx}"),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("cls,train,gz", [("MNIST", True, False),
                                          ("MNIST", False, True),
                                          ("FashionMNIST", True, True)])
def test_mnist_readers_match_jax(tmp_path, cls, train, gz):
    root = str(tmp_path / "m")
    _write_mnist(root, "train" if train else "t10k", 7, gz)
    j = getattr(jdata.vision, cls)(root=root, train=train)
    t = getattr(tdata.vision, cls)(root=root, train=train)
    assert len(t) == len(j) == 7
    with tmx.cpu():
        for i in (0, 6):
            _same(t[i], j[i])
        tt = getattr(tdata.vision, cls)(root=root, train=train,
                                        transform=lambda x, y: (x, y + 100))
        assert tt[2][1] == j[2][1] + 100


def _write_cifar(root, names, n, fine):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(len(names))
    for name in names:
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8)}
        if fine:
            d[b"fine_labels"] = rng.randint(0, 100, n).tolist()
            d[b"coarse_labels"] = rng.randint(0, 20, n).tolist()
        else:
            d[b"labels"] = rng.randint(0, 10, n).tolist()
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(d, f)


def test_cifar_readers_match_jax(tmp_path):
    root10 = str(tmp_path / "c10")
    _write_cifar(root10, [f"data_batch_{i}" for i in range(1, 6)]
                 + ["test_batch"], 3, False)
    root100 = str(tmp_path / "c100")
    _write_cifar(root100, ["train", "test"], 4, True)
    with tmx.cpu():
        for train in (True, False):
            j = jdata.vision.CIFAR10(root=root10, train=train)
            t = tdata.vision.CIFAR10(root=root10, train=train)
            assert len(t) == len(j)
            _same(t[len(t) - 1], j[len(j) - 1])
        for fine in (True, False):
            j = jdata.vision.CIFAR100(root=root100, fine_label=fine)
            t = tdata.vision.CIFAR100(root=root100, fine_label=fine)
            assert len(t) == len(j) == 4
            _same(t[3], j[3])


def test_a_missing_dataset_file_raises_and_names_the_directory(tmp_path):
    root = str(tmp_path / "nothing-here")
    for cls in ("MNIST", "CIFAR10", "CIFAR100"):
        with pytest.raises(MXNetError, match="nothing-here"):
            getattr(tdata.vision, cls)(root=root)


def test_image_record_and_folder_datasets_match_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    from incubator_mxnet_tpu import recordio as jrec
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    folder = tmp_path / "folder"
    for i in range(3):
        img = R.randint(0, 256, (9 + i, 7, 3)).astype(np.uint8)
        buf = pyio.BytesIO()
        PIL.fromarray(img).save(buf, format="PNG")
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i), i, 0),
                                 buf.getvalue()))
        (folder / f"class{i % 2}").mkdir(parents=True, exist_ok=True)
        PIL.fromarray(img).save(str(folder / f"class{i % 2}" / f"{i}.png"))
    w.close()
    with tmx.cpu():
        for flag in (1, 0):
            j = jdata.vision.ImageRecordDataset(rec, flag=flag)
            t = tdata.vision.ImageRecordDataset(rec, flag=flag)
            assert len(t) == len(j) == 3
            for i in range(3):
                _same(t[i], j[i])
            assert t.payload(1) == j.payload(1)
        j = jdata.vision.ImageFolderDataset(str(folder))
        t = tdata.vision.ImageFolderDataset(str(folder))
        assert t.synsets == j.synsets == ["class0", "class1"]
        assert [x[1] for x in t.items] == [x[1] for x in j.items]
        for i in range(len(t)):
            _same(t[i], j[i])
