"""Native (C++) readers of the PyTorch port, loaded with ctypes.

The port's own copy of the JAX package's `native` loaders and sources
(`recordio_core.h`, `recordio.cc`, `imagerec.cc`): the C++ IO stack of the
reference (src/io/, dmlc recordio) for `.rec` files. Each library is built
with g++ at first use into the package's `_build/` directory (listed in
`.gitignore`); `imagerec.cc` links libjpeg. Where g++ or libjpeg's headers
are missing the loader returns None and every consumer takes the
pure-Python path (`io/_imagerec_common.py`, PIL for JPEG).

IMPORT CONTRACT: stdlib (and numpy inside the readers) only, no package
import: `io/_shm_worker.py` loads this file by path in a bare subprocess
that must never import torch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LOCK = threading.Lock()
_LIB = {"recordio": None, "tried": False,
        "imagerec": None, "imagerec_tried": False}


def _compile(src, out, extra_flags=()):
    """g++ `src` into `out`, through a file of this process's own that is
    renamed into place, so that processes building at once never load a
    half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           src, "-o", tmp, *extra_flags]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _needs_rebuild(out, *srcs):
    newest = max(os.path.getmtime(s) for s in srcs)
    return not os.path.exists(out) or os.path.getmtime(out) < newest


def load_recordio():
    """Load (building if needed) the native recordio library; None if the
    toolchain is unavailable."""
    with _LOCK:
        if _LIB["tried"]:
            return _LIB["recordio"]
        _LIB["tried"] = True
        src = os.path.join(_HERE, "recordio.cc")
        hdr = os.path.join(_HERE, "recordio_core.h")
        out = os.path.join(_BUILD_DIR, "librecordio.so")
        try:
            if _needs_rebuild(out, src, hdr):
                _compile(src, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.rr_open.restype = ctypes.c_void_p
        lib.rr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.rr_close.argtypes = [ctypes.c_void_p]
        lib.rr_count.restype = ctypes.c_int64
        lib.rr_count.argtypes = [ctypes.c_void_p]
        lib.rr_record_len.restype = ctypes.c_int64
        lib.rr_record_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.rr_read.restype = ctypes.c_int64
        lib.rr_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64]
        lib.rr_read_batch.restype = ctypes.c_int
        lib.rr_read_batch.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
        lib.rr_version.restype = ctypes.c_char_p
        _LIB["recordio"] = lib
        return lib


def load_imagerec():
    """Load (building if needed) the native JPEG decode+augment library
    (imagerec.cc, links -ljpeg); None when the toolchain or libjpeg is
    unavailable — consumers fall back to the Python/PIL path."""
    with _LOCK:
        if _LIB["imagerec_tried"]:
            return _LIB["imagerec"]
        _LIB["imagerec_tried"] = True
        src = os.path.join(_HERE, "imagerec.cc")
        out = os.path.join(_BUILD_DIR, "libimagerec.so")
        hdr = os.path.join(_HERE, "recordio_core.h")
        try:
            if _needs_rebuild(out, src, hdr):
                try:
                    # built on the machine that runs it: native ISA is safe
                    # and lets the sampling loops auto-vectorize (AVX)
                    _compile(src, out,
                             extra_flags=("-ljpeg", "-march=native",
                                          "-funroll-loops"))
                except subprocess.CalledProcessError:
                    _compile(src, out, extra_flags=("-ljpeg",))
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.ir_open.restype = ctypes.c_void_p
        lib.ir_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ir_close.argtypes = [ctypes.c_void_p]
        lib.ir_count.restype = ctypes.c_int64
        lib.ir_count.argtypes = [ctypes.c_void_p]
        lib.ir_read_batch.restype = ctypes.c_int64
        lib.ir_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.ir_read_batch_u8.restype = ctypes.c_int64
        lib.ir_read_batch_u8.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.ir_advise.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64]
        lib.ir_version.restype = ctypes.c_char_p
        lib.ir_stage_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 4
        lib.ir_stage_reset.argtypes = []
        _LIB["imagerec"] = lib
        return lib


def imagerec_stage_stats(reset=False):
    """Per-stage accumulated wall nanoseconds of the native image pipeline
    since the last reset: {'read_ns', 'decode_ns', 'augment_ns', 'records'}.
    read = record-byte acquisition (mmap fault / chunk reassembly — the
    stage ir_advise readahead targets), decode = JPEG, augment = the fused
    resize/crop/mirror[/normalize] sampling pass. The measured basis for
    the IO decode-bound analysis; surfaced through
    `io.io_stats()`."""
    lib = load_imagerec()
    if lib is None:
        return None
    rd = ctypes.c_int64()
    d = ctypes.c_int64()
    a = ctypes.c_int64()
    r = ctypes.c_int64()
    lib.ir_stage_stats(ctypes.byref(rd), ctypes.byref(d), ctypes.byref(a),
                       ctypes.byref(r))
    out = {"read_ns": rd.value, "decode_ns": d.value, "augment_ns": a.value,
           "records": r.value}
    if reset:
        lib.ir_stage_reset()
    return out


def imagerec_stage_reset():
    lib = load_imagerec()
    if lib is not None:
        lib.ir_stage_reset()


class NativeImageRecordFile:
    """Threaded decode+augment reader over an image .rec file (≙ the
    worker half of ImageRecordIter, src/io/iter_image_recordio_2.cc)."""

    def __init__(self, path, num_threads=0):
        import numpy as np
        self._np = np
        self._lib = load_imagerec()
        if self._lib is None:
            raise RuntimeError("native imagerec library unavailable")
        if num_threads <= 0:
            num_threads = min(os.cpu_count() or 4, 16)
        self._h = self._lib.ir_open(path.encode(), num_threads)
        if not self._h:
            raise IOError(f"cannot open/parse record file {path}")

    def __len__(self):
        return int(self._lib.ir_count(self._h))

    def read_batch(self, indices, data_shape, resize=0, rand_crop=False,
                   rand_mirror=False, seed=0, mean=None, std=None,
                   label_width=1, out_images=None, out_labels=None):
        """Decode+augment `indices` into one contiguous NHWC float32 batch.

        data_shape is (H, W, 3) (NHWC) or reference-style
        (3, H, W); labels come back as (n, label_width) float32. Corrupt
        records zero-fill their slot with label -1. `out_images`/
        `out_labels` decode in place (e.g. straight into a ring slot — no
        intermediate batch copy); omitted, fresh arrays are allocated."""
        np = self._np
        ct = ctypes
        h, w = self._out_hw(data_shape)
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        images = (np.empty((n, h, w, 3), dtype=np.float32)
                  if out_images is None else out_images)
        labels = (np.empty((n, label_width), dtype=np.float32)
                  if out_labels is None else out_labels)

        def fptr(a):
            return a.ctypes.data_as(ct.POINTER(ct.c_float))

        mean_a = (np.ascontiguousarray(mean, np.float32)
                  if mean is not None else None)
        std_a = (np.ascontiguousarray(std, np.float32)
                 if std is not None else None)
        failed = self._lib.ir_read_batch(
            self._h, idx.ctypes.data_as(ct.POINTER(ct.c_int64)), n,
            h, w, int(resize), int(bool(rand_crop)), int(bool(rand_mirror)),
            ct.c_uint64(seed),
            fptr(mean_a) if mean_a is not None else None,
            fptr(std_a) if std_a is not None else None,
            fptr(images), fptr(labels), label_width)
        if failed < 0:
            raise IOError("ir_read_batch: invalid arguments")
        return images, labels, int(failed)

    @staticmethod
    def _out_hw(data_shape):
        if len(data_shape) != 3:
            raise ValueError("data_shape must be rank 3")
        if data_shape[0] == 3 and data_shape[2] != 3:
            return int(data_shape[1]), int(data_shape[2])  # (3,H,W) legacy
        return int(data_shape[0]), int(data_shape[1])

    def read_batch_u8(self, indices, data_shape, resize=0, rand_crop=False,
                      rand_mirror=False, seed=0, label_width=1,
                      out_images=None, out_labels=None):
        """uint8-handoff decode: resize+crop[+mirror] to raw NHWC uint8 —
        normalize/cast run on the card (ops.fused.image_augment), so the
        batch handed to H2D is 1/4 the float32 bytes. Same per-record RNG
        as read_batch (crop geometry is bitwise identical across paths).
        `out_images`/`out_labels` decode in place (e.g. into a
        shared-memory ring slot); omitted, fresh arrays are allocated."""
        np = self._np
        ct = ctypes
        h, w = self._out_hw(data_shape)
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        if out_images is None:
            out_images = np.empty((n, h, w, 3), dtype=np.uint8)
        if out_labels is None:
            out_labels = np.empty((n, label_width), dtype=np.float32)
        failed = self._lib.ir_read_batch_u8(
            self._h, idx.ctypes.data_as(ct.POINTER(ct.c_int64)), n,
            h, w, int(resize), int(bool(rand_crop)), int(bool(rand_mirror)),
            ct.c_uint64(seed),
            out_images.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            out_labels.ctypes.data_as(ct.POINTER(ct.c_float)), label_width)
        if failed < 0:
            raise IOError("ir_read_batch_u8: invalid arguments")
        return out_images, out_labels, int(failed)

    def advise(self, indices):
        """posix_fadvise/madvise(WILLNEED) the records' coalesced byte
        ranges so an upcoming batch's pages stream in ahead of the decode
        (called per lookahead batch by the ImageRecordIter producer)."""
        np = self._np
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        self._lib.ir_advise(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx))

    def close(self):
        if self._h:
            self._lib.ir_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeRecordFile:
    """Random-access .rec reader over the C++ library (≙ the C++
    RecordFileDataset fast path, src/io/dataset.cc)."""

    def __init__(self, path, num_threads=4):
        import numpy as np
        self._np = np
        self._lib = load_recordio()
        if self._lib is None:
            raise RuntimeError("native recordio library unavailable")
        self._h = self._lib.rr_open(path.encode(), num_threads)
        if not self._h:
            raise IOError(f"cannot open/parse record file {path}")

    def __len__(self):
        return int(self._lib.rr_count(self._h))

    def read(self, idx):
        n = int(self._lib.rr_record_len(self._h, idx))
        if n < 0:
            raise IndexError(idx)
        buf = self._np.empty(n, dtype=self._np.uint8)
        w = self._lib.rr_read(
            self._h, idx,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        if w < 0:
            raise IOError(f"read failed for record {idx}")
        return buf.tobytes()

    def read_batch(self, indices, stride):
        """Gather len(indices) fixed-stride payloads in parallel into one
        contiguous (n, stride) uint8 array (the DataLoader fast path)."""
        np = self._np
        idx = np.asarray(indices, dtype=np.int64)
        out = np.empty((len(idx), stride), dtype=np.uint8)
        rc = self._lib.rr_read_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            stride)
        if rc != 0:
            raise IOError("batch read failed (bad index?)")
        return out

    def close(self):
        if self._h:
            self._lib.rr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
