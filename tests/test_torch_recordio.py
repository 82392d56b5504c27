"""PyTorch port: RecordIO files written by either package are read by the
other, and the native reader (`native/recordio.cc`, built with g++ at
first use) agrees with the Python one. Byte-exact throughout."""
import os
import struct

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import native as tnative
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.io import _imagerec_common as tcommon

torch.set_num_threads(1)

MAGIC = struct.pack("<I", 0x3ed7230a)
PAYLOADS = [b"", b"a", b"abcd", b"x" * 1001, b"pre" + MAGIC + b"post",
            MAGIC, b"two" + MAGIC + MAGIC + b"!", bytes(range(256)) * 3]


def _write(mod, path, payloads):
    w = mod.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(mod, path):
    r = mod.MXRecordIO(path, "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_records_round_trip_between_the_packages(tmp_path, writer, reader):
    mods = {"jax": jrec, "port": trec}
    path = str(tmp_path / "a.rec")
    _write(mods[writer], path, PAYLOADS)
    assert _read_all(mods[reader], path) == PAYLOADS


def test_the_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    _write(jrec, a, PAYLOADS[1:])
    _write(trec, b, PAYLOADS[1:])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_indexed_records_between_the_packages(tmp_path, writer):
    mods = {"jax": jrec, "port": trec}
    idx, rec = str(tmp_path / "d.idx"), str(tmp_path / "d.rec")
    w = mods[writer].MXIndexedRecordIO(idx, rec, "w")
    for k, p in enumerate(PAYLOADS[1:]):
        w.write_idx(10 + k, p)
    w.close()
    for mod in (jrec, trec):
        r = mod.MXIndexedRecordIO(idx, rec, "r")
        assert r.keys == [10 + k for k in range(len(PAYLOADS) - 1)]
        for k in reversed(r.keys):
            assert r.read_idx(k) == PAYLOADS[1 + k - 10]
        r.close()


@pytest.mark.parametrize("label", [3.5, [1.0, -2.0, 7.25]])
def test_irheader_pack_unpack_match(label):
    for mod_w, mod_r in ((jrec, trec), (trec, jrec)):
        buf = mod_w.pack(mod_w.IRHeader(0, label, 42, 7), b"img")
        assert buf == trec.pack(trec.IRHeader(0, label, 42, 7), b"img")
        h, payload = mod_r.unpack(buf)
        assert payload == b"img" and h.id == 42 and h.id2 == 7
        np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                      np.asarray(label, np.float32))


def test_image_codec_entry_points_raise_as_in_the_jax_package():
    for name in ("pack_img", "unpack_img"):
        with pytest.raises(Exception, match="codec"):
            getattr(jrec, name)(trec.IRHeader(0, 1.0, 0, 0), None) \
                if name == "pack_img" else getattr(jrec, name)(b"")
        with pytest.raises(MXNetError, match="codec"):
            getattr(trec, name)(trec.IRHeader(0, 1.0, 0, 0), None) \
                if name == "pack_img" else getattr(trec, name)(b"")


def test_bad_magic_and_wrong_mode_raise(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(b"\x00" * 16)
    r = trec.MXRecordIO(path, "r")
    with pytest.raises(MXNetError, match="magic"):
        r.read()
    with pytest.raises(MXNetError, match="not opened for writing"):
        r.write(b"x")
    r.close()
    with pytest.raises(MXNetError, match="invalid flag"):
        trec.MXRecordIO(path, "a")


def test_native_reader_agrees_with_the_python_readers(tmp_path):
    path = str(tmp_path / "n.rec")
    payloads = PAYLOADS[1:]
    _write(jrec, path, payloads)
    if tnative.load_recordio() is None:
        pytest.skip("g++ is not on this host: the native reader is not built")
    nat = tnative.NativeRecordFile(path)
    py = tcommon.PyRecordIndex(path)
    assert len(nat) == len(py) == len(payloads)
    for i, p in enumerate(payloads):
        assert nat.read(i) == p == py.payload(i)
    # the fixed-stride gather of the DataLoader fast path
    fixed = str(tmp_path / "f.rec")
    rows = [bytes([i]) * 12 for i in range(5)]
    _write(trec, fixed, rows)
    batch = tnative.NativeRecordFile(fixed).read_batch([4, 0, 2], 12)
    np.testing.assert_array_equal(
        batch, np.frombuffer(b"".join(rows[i] for i in (4, 0, 2)),
                             np.uint8).reshape(3, 12))
    nat.close()


def test_native_libraries_build_into_the_package_build_dir():
    if tnative.load_recordio() is None:
        pytest.skip("g++ is not on this host: the native reader is not built")
    build = os.path.join(os.path.dirname(os.path.dirname(tnative.__file__)),
                         "_build")
    assert os.path.isfile(os.path.join(build, "librecordio.so"))
    assert tnative.load_recordio().rr_version() == \
        b"incubator-mxnet-tpu-native-recordio/1"


def test_tiny_imagerec_reads_alike_in_every_reader():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "tiny_imagerec.rec")
    r = trec.MXRecordIO(path, "r")
    recs = []
    while (rec := r.read()) is not None:
        recs.append(rec)
    py = tcommon.PyRecordIndex(path)
    assert [py.payload(i) for i in range(len(py))] == recs
    assert recs == _read_all(jrec, path)
    h, img = trec.unpack(recs[0])
    assert img[:2] == b"\xff\xd8"          # a JPEG
