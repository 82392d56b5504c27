"""mx.recordio of the PyTorch port — RecordIO container format
(≙ python/mxnet/recordio.py + 3rdparty/dmlc-core recordio).

Counterpart of `incubator_mxnet_tpu/recordio.py`, the same code: files
written by either package are read by the other.

Binary-compatible with the reference format so datasets packed by the
reference's im2rec tooling load directly:

  record  := magic(u32=0x3ed7230a) | lrecord(u32) | data | pad to 4B
  lrecord := cflag(u29 in upper 3 bits... reference packs cflag<<29 | length)
  IRHeader := flag(u32) label(f32) id(u64) id2(u64)   (struct IRHeader)

Continuation records (cflag 1/2/3) support data containing the magic.
"""
from __future__ import annotations

import os
import struct
import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0x3ed7230a
_LFLAG_BITS = 29
_LMASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential RecordIO reader/writer (≙ mx.recordio.MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")
        self.pid = os.getpid()

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def reset(self):
        self.close()
        self.open()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_pid(self):
        if self.pid != os.getpid():
            # reopen after fork (≙ reference's is_mx_rec pid check)
            self.reset()

    def tell(self):
        return self.record.tell()

    def seek(self, pos):
        """Reposition the read cursor to a byte offset previously obtained
        from tell() (≙ MXRecordIOReaderSeek)."""
        self._check_pid()
        if self.writable:
            raise MXNetError("seek is for readers")
        self.record.seek(pos)

    def write(self, buf):
        """Write one record."""
        self._check_pid()
        if not self.writable:
            raise MXNetError("not opened for writing")
        # split payload at magic occurrences like dmlc recordio
        data = bytes(buf)
        # simple single-chunk write with cflag=0 (dmlc only needs chunking
        # when data embeds the magic; scan and chunk if needed)
        chunks = _split_on_magic(data)
        n = len(chunks)
        for i, chunk in enumerate(chunks):
            if n == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == n - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << _LFLAG_BITS) | len(chunk)
            self.record.write(struct.pack("<II", _MAGIC, lrec))
            self.record.write(chunk)
            pad = (4 - (len(chunk) % 4)) % 4
            if pad:
                self.record.write(b"\x00" * pad)

    def read(self):
        """Read one record; None at EOF."""
        self._check_pid()
        if self.writable:
            raise MXNetError("not opened for reading")
        out = b""
        while True:
            head = self.record.read(8)
            if len(head) < 8:
                return out if out else None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic")
            cflag = lrec >> _LFLAG_BITS
            length = lrec & _LMASK
            data = self.record.read(length)
            pad = (4 - (length % 4)) % 4
            if pad:
                self.record.read(pad)
            if cflag == 0:
                return data
            if cflag == 1:
                out = data
            elif cflag == 2:
                out += struct.pack("<I", _MAGIC) + data
            elif cflag == 3:
                return out + struct.pack("<I", _MAGIC) + data


def _split_on_magic(data):
    magic_bytes = struct.pack("<I", _MAGIC)
    parts = data.split(magic_bytes)
    return parts if len(parts) > 1 else [data]


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with .idx sidecar (≙ mx.recordio.MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.writable and self.idx:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


# IRHeader: flag, label, id, id2 (≙ mx.recordio.IRHeader struct)
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class IRHeader:
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


def pack(header, s):
    """Pack IRHeader + payload into a record buffer (≙ mx.recordio.pack)."""
    label = header.label
    if isinstance(label, (list, tuple, _np.ndarray)):
        label = _np.asarray(label, dtype=_np.float32)
        header = IRHeader(len(label), 0.0, header.id, header.id2)
        payload = struct.pack(_IR_FORMAT, header.flag, header.label,
                              header.id, header.id2) + label.tobytes() + s
        return payload
    return struct.pack(_IR_FORMAT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s):
    """Unpack a record buffer into (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    if flag > 0:
        labels = _np.frombuffer(payload[:4 * flag], dtype=_np.float32)
        return IRHeader(flag, labels, id_, id2), payload[4 * flag:]
    return IRHeader(flag, label, id_, id2), payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    raise MXNetError("pack_img requires an image codec (OpenCV) which is not "
                     "bundled; pack raw arrays with pack() instead")


def unpack_img(s, iscolor=-1):
    raise MXNetError("unpack_img requires an image codec; use unpack() and "
                     "decode with PIL/your codec of choice")
