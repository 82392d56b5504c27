"""mx.io of the PyTorch port — the data iterator API (≙ python/mxnet/io/).

Counterpart of `incubator_mxnet_tpu/io/__init__.py`: DataIter / DataBatch /
DataDesc, NDArrayIter, ResizeIter, PrefetchingIter, CSVIter, the image
record iterator over a persistent decode pool (`imagerec_pool.py`, the
C++ reader `native/imagerec.cc`, or PIL through the shared augment spec
`_imagerec_common.py`), and `DeviceFeed` (`device_feed.py`). Batches land
on the card unless the caller asks for the CPU (`device="cpu"` or inside
`with mx.cpu():`).

Left out until their queues land (ROADMAP): `LibSVMIter` (it serves
`CSRNDArray`s, A12), the
registry gauges, trace spans and `inspect.memory` attribution of the
staged batches (A11), and the `mx.tune` knob tier (A11): a knob is the
explicit argument, else its `MXNET_*` environment variable.
"""
from __future__ import annotations

import threading as _threading
from collections import namedtuple

import numpy as _np
import torch as _torch

from .. import fault as _fault
from ..base import MXNetError, get_env
from ..device import resolve_device
from ..ndarray import NDArray, _wrap, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "io_stats"]

# ---------------------------------------------------------------------------
# ImageRecordIter pipeline counters (consumer-side; the native per-stage
# read/decode/augment clocks ride along in io_stats())
# ---------------------------------------------------------------------------
_IO_STATS_LOCK = _threading.Lock()

IO_STATS = {
    "batches": 0,            # batches delivered to the consumer
    "images": 0,             # real (non-pad) images delivered
    "failed_records": 0,     # corrupt records zero-filled by the decoders
    "stage_us": 0.0,         # consumer staging (async H2D dispatch + wrap,
    #                          and the augment kernel's launch)
    "wait_us": 0.0,          # consumer waited on the decode pool (producer-
    #                          bound stall; ≙ feed.stall_data_us)
    "bytes_staged": 0,       # host bytes copied to the device (the uint8
    #                          handoff's 4x win shows up here)
    "device_augment_batches": 0,  # batches normalized on the card (the
    #                               augment kernel)
    "alias_copies": 0,       # CPU batches copied out of a ring slot
    "submit_restarts": 0,    # transient submit faults retried in place
    "worker_restarts": 0,    # decode worker processes respawned
}


def _bump_io(key, delta=1):
    with _IO_STATS_LOCK:
        IO_STATS[key] += delta


# native stage-clock deltas shipped back by out-of-process decode workers
# (the in-process lib's globals only see parent-side decodes); guarded by
# _IO_STATS_LOCK, folded into io_stats()
_WORKER_STAGES = {"read_ns": 0, "decode_ns": 0, "augment_ns": 0,
                  "records": 0}


def _note_worker_stages(stages):
    with _IO_STATS_LOCK:
        for k in _WORKER_STAGES:
            _WORKER_STAGES[k] += int(stages.get(k, 0))


def io_stats(reset=False):
    """Snapshot of the ImageRecordIter pipeline counters plus the native
    decoder's per-stage clocks (`native.imagerec_stage_stats`): read
    (record-byte acquisition — what `ir_advise` readahead targets),
    decode (JPEG), augment (fused resize/crop/mirror[/normalize] sampling
    pass), and the decoded-record count, the shm workers' included.
    `reset=True` zeroes both the counters and the native clocks after the
    snapshot."""
    with _IO_STATS_LOCK:
        snap = dict(IO_STATS)
        if reset:
            for k, v in IO_STATS.items():
                IO_STATS[k] = type(v)()
    try:
        from ..native import imagerec_stage_stats
        stages = imagerec_stage_stats(reset=reset)
    except Exception:
        stages = None
    with _IO_STATS_LOCK:
        worker = dict(_WORKER_STAGES)
        if reset:
            for k in _WORKER_STAGES:
                _WORKER_STAGES[k] = 0
    if stages is None:          # no native lib: worker deltas still count
        stages = {"read_ns": 0, "decode_ns": 0, "augment_ns": 0,
                  "records": 0}
    for key, src in (("read_ns", "read_ns"),
                     ("decode_ns", "decode_ns"),
                     ("augment_ns", "augment_ns"),
                     ("decoded_records", "records")):
        snap[key] = stages[src] + worker[src]
    return snap


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """≙ mx.io.DataDesc (name, shape[, dtype, layout])."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """≙ mx.io.DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """≙ mx.io.DataIter."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{('_%d' % i) if i else ''}": d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            v = array(_np.asarray(v))
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """≙ mx.io.NDArrayIter(data, label, batch_size, shuffle,
    last_batch_handle). Batches are made on the device that was current when the iterator was
    made (a feeder thread that pulls them has a scope of its own)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        from ..device import current_device
        self._device = current_device()
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"invalid last_batch_handle {last_batch_handle}")
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle
        self.cursor = -batch_size
        self._order = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            _np.random.shuffle(self._order)

    def __len__(self):
        return self.num_batches

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        idx = self._order[self.cursor:self.cursor + self.batch_size]
        pad = self.getpad()
        if pad:
            idx = _np.concatenate([idx, self._order[:pad]])
        for _, v in arrays:
            out.append(array(v.asnumpy()[idx], device=self._device))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """≙ mx.io.ResizeIter — cap/extend an iterator to `size` batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad or 0


class _WorkerFailure:
    """Terminal sentinel: the prefetch worker died; holds its exception."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class PrefetchingIter(DataIter):
    """≙ mx.io.PrefetchingIter — background thread prefetch wrapper.

    Worker failures are never silent: an exception in the prefetch thread is
    captured and re-raised in the consumer's `__next__` (the reference's
    thread would die and the epoch would just end short). Transient I/O
    errors (IOError/OSError/TimeoutError) are retried in place up to
    `max_restarts` times (default MXNET_PREFETCH_RESTARTS=3) with a
    structured log per retry — the retry re-fetches, so nothing is lost
    unless the source itself advanced before raising (the source's own
    contract)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 max_restarts=None):
        import queue
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError(
                "PrefetchingIter wraps exactly ONE iterator; for multiple "
                "streams compose them into a single source first (zip your "
                "iterators, or build one combined Dataset/DataLoader) and "
                "wrap that — for host->device prefetch of the combined "
                "stream use io.DeviceFeed / io.prefetch_to_device instead")
        super().__init__(iters[0].batch_size)
        self.iter = iters[0]
        self._queue = queue.Queue(maxsize=2)
        self._started = False
        self._thread = None
        self.current_batch = None
        self._max_restarts = (get_env("MXNET_PREFETCH_RESTARTS", 3, typ=int)
                              if max_restarts is None else max_restarts)
        self._terminated = False  # terminal sentinel already consumed

    def _worker(self):
        # the fetch/retry protocol (inject-before-fetch, consecutive
        # restart budget, original-exception re-raise) is shared with
        # DeviceFeed's feeder
        from .device_feed import _fetch_with_restarts
        try:
            for batch in _fetch_with_restarts(self.iter, "io.prefetch",
                                              self._max_restarts):
                self._queue.put(batch)
        except BaseException as e:  # re-raised in the consumer
            self._queue.put(_WorkerFailure(e))
            return
        self._queue.put(None)

    def _ensure_started(self):
        import threading
        if not self._started:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            self._started = True

    def reset(self):
        if self._thread is not None:
            # drain until the worker's terminal sentinel (None on epoch end,
            # _WorkerFailure on death) so join() cannot deadlock on a full
            # queue; skip when the sentinel was already consumed
            while not self._terminated and not isinstance(
                    self._queue.get(), (type(None), _WorkerFailure)):
                pass
            self._thread.join()
            self._thread = None
        self.iter.reset()
        self._started = False
        self._terminated = False

    def iter_next(self):
        self._ensure_started()
        batch = self._queue.get()
        if batch is None:
            self._terminated = True
            return False
        if isinstance(batch, _WorkerFailure):
            self._terminated = True
            raise batch.error
        self.current_batch = batch
        return True

    def __len__(self):
        # passthrough so the wrapper composes with epoch loops and
        # DeviceFeed the same as its inner iterator
        return len(self.iter)

    @property
    def provide_data(self):
        return getattr(self.iter, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self.iter, "provide_label", None)

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad or 0


class CSVIter(NDArrayIter):
    """≙ mx.io.CSVIter (src/io/iter_csv.cc): batches from CSV files.

    data_csv/label_csv: file paths; data_shape/label_shape: per-example
    shapes. Loads host-side via numpy then serves fixed-size batches; every
    example is served each epoch (the final partial batch wraps with its
    `pad` count exposed, ≙ the reference batch loader's padding contract).
    """

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32"):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        if data.size == 0:
            raise MXNetError(f"no examples in {data_csv}")
        n = data.shape[0]
        data = data.reshape((n,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2).reshape((n,) + tuple(label_shape))
        else:
            label = _np.zeros((n,) + tuple(label_shape), dtype)
        super().__init__(data, label, batch_size, last_batch_handle="pad")


def _not_ported(name, queue):
    def fn(*args, **kwargs):
        raise MXNetError(f"mx.io.{name} is not ported yet (ROADMAP {queue})")
    fn.__name__ = fn.__qualname__ = name
    return fn


# it serves CSRNDArray batches (ndarray/sparse.py)
LibSVMIter = _not_ported("LibSVMIter", "A12 (ndarray.sparse)")


__all__ += ["CSVIter", "LibSVMIter"]


class ImageRecordIter(DataIter):
    """Image .rec iterator over a persistent decode pool (≙ ImageRecordIter,
    src/io/iter_image_recordio_2.cc:708-940 + the prefetcher in
    iter_prefetcher.h; the port's counterpart of the JAX package's).

    Batches come out NHWC, and the decode+augment pipeline runs on a
    PERSISTENT producer — `workers=N` (or `MXNET_IO_WORKERS=N`) decodes
    each batch sharded across N out-of-process shared-memory workers
    (io/imagerec_pool.py; no per-batch thread spawn, no pickling of image
    arrays), default `0` uses the in-process native thread pool
    (imagerec.cc) behind one persistent dispatcher thread — with
    `lookahead` (`MXNET_IMAGEREC_LOOKAHEAD`) batches decoded ahead of the
    consumer and `posix_fadvise(WILLNEED)` readahead over each upcoming
    batch's record ranges. Without the native library and without workers
    it decodes synchronously through PIL (the shared augment spec: crop
    and mirror geometry equal to the native path's).

    Staging: on the card the pool's ring is page-locked, and each batch
    goes from its slot to the card by an asynchronous copy on a side CUDA
    stream; the consumer's stream waits on the copy's event, and the slot
    returns to the ring fenced on that event. On the CPU the batch is
    copied out of its slot before the slot is released.

    Handoff modes:
      * float32 (default, reference semantics): normalized float32 NHWC,
        mean/std applied by the decoders.
      * `handoff="uint8"`: the decoders produce raw cropped uint8 NHWC —
        1/4 the bytes through shared memory and to the card. With
        `device_augment=True` (or `MXNET_IO_DEVICE_AUGMENT=1`, which also
        implies the uint8 handoff) mirror/normalize/cast run on the card
        in one pass of the augment kernel (`npx.fused_image_augment`),
        its mirror bits drawn from a generator seeded by (epoch, batch) —
        the batch still arrives normalized in `dtype`, so training code is
        unchanged.

    Supported reference knobs: path_imgrec, data_shape ((3,H,W) or
    (H,W,3)), batch_size, shuffle, rand_crop, rand_mirror, resize,
    mean_r/g/b, std_r/g/b (255-scale like the reference; converted),
    label_width, seed, round_batch (partial final batch dropped like the
    reference when round_batch=False ... kept=padded when True).

    Failure semantics: a decode-worker failure re-raises the ORIGINAL
    exception in the consumer's `next()`; transient submit-time faults
    (IOError/OSError/TimeoutError) retry in place up to a bounded number
    of CONSECUTIVE times (`max_restarts`, `MXNET_PREFETCH_RESTARTS`).
    Observability: `io_stats()`.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, resize=0,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=0.0, std_g=0.0, std_b=0.0,
                 label_width=1, seed=0, round_batch=True,
                 preprocess_threads=0, prefetch=True, handoff=None,
                 device_augment=None, dtype="float32", workers=None,
                 lookahead=None, shm_mb=None, max_restarts=None,
                 device=None, **kwargs):
        super().__init__(batch_size)
        self._device = resolve_device(device)
        self._path = path_imgrec
        self._shape = tuple(int(s) for s in data_shape)
        if self._shape[0] == 3 and self._shape[2] != 3:
            self._hw = (self._shape[1], self._shape[2])
        else:
            self._hw = (self._shape[0], self._shape[1])
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = int(resize)
        # reference means/stds are in 0..255 pixel units (each std defaults
        # to 1.0 per channel there); normalization happens after scaling to
        # [0,1], so divide by 255 and map unset std channels to the
        # reference default 1.0 rather than a 1/0 blow-up
        self._mean = ([mean_r / 255.0, mean_g / 255.0, mean_b / 255.0]
                      if (mean_r or mean_g or mean_b) else None)
        self._std = ([(s if s else 1.0) / 255.0
                      for s in (std_r, std_g, std_b)]
                     if (std_r or std_g or std_b) else None)
        self._label_width = int(label_width)
        self._seed = int(seed)
        self._round_batch = round_batch
        self._prefetch = prefetch
        self._epoch = 0
        self._dtype = dtype
        if device_augment is None:
            device_augment = get_env("MXNET_IO_DEVICE_AUGMENT", "0") \
                not in ("0", "false")
        self._device_augment = bool(device_augment)
        if handoff is None:
            handoff = "uint8" if self._device_augment else "float32"
        if handoff not in ("float32", "uint8"):
            raise MXNetError(f"invalid handoff {handoff!r}")
        if self._device_augment and handoff != "uint8":
            raise MXNetError("device_augment needs handoff='uint8' "
                             "(the device kernel normalizes raw pixels)")
        self._handoff_u8 = handoff == "uint8"
        if self._handoff_u8 and not self._device_augment \
                and (self._mean is not None or std_r or std_g or std_b):
            raise MXNetError(
                "handoff='uint8' delivers RAW pixels — mean/std would be "
                "silently ignored. Use device_augment=True (normalize on "
                "device) or the float32 handoff (normalize in the "
                "decoders), or drop the mean/std arguments and normalize "
                "in your step")
        # knob precedence: explicit arg > MXNET_* env > default
        self._workers = (get_env("MXNET_IO_WORKERS", 0, typ=int)
                         if workers is None else int(workers))
        ahead = (get_env("MXNET_IMAGEREC_LOOKAHEAD", 2, typ=int)
                 if lookahead is None else int(lookahead))
        self._ahead = max(0, ahead) if prefetch else 0
        self._shm_mb = shm_mb
        self._max_restarts = (get_env("MXNET_PREFETCH_RESTARTS", 3, typ=int)
                              if max_restarts is None else int(max_restarts))
        self._stream = (_torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)

        from ..native import NativeImageRecordFile
        try:
            self._native = NativeImageRecordFile(
                path_imgrec, num_threads=preprocess_threads)
            self._n = len(self._native)
        except (RuntimeError, IOError):
            self._native = None
            from ._imagerec_common import PyRecordIndex
            self._pyds = PyRecordIndex(path_imgrec)
            self._n = len(self._pyds)
        self._order = _np.arange(self._n)
        self._pool = self._make_pool()
        self._batch_ids = iter(range(1 << 62)).__next__
        self.reset()

    def _make_pool(self):
        if self._native is None and self._workers <= 0:
            return None              # synchronous shared-spec PIL path
        from .imagerec_pool import DecodePool
        try:
            return DecodePool(
                self._path, self._hw, self.batch_size,
                out_u8=self._handoff_u8, resize=self._resize,
                rand_crop=self._rand_crop,
                rand_mirror=self._host_mirror, mean=self._mean,
                std=self._std, label_width=self._label_width,
                reader=self._native, workers=self._workers,
                lookahead=max(1, self._ahead), shm_mb=self._shm_mb,
                max_restarts=self._max_restarts,
                pin=self._device.type == "cuda")
        except Exception as e:
            if self._native is not None:
                raise
            _fault._log_event("io.imagerec_pool_fallback",
                              error=f"{type(e).__name__}: {e}",
                              mode="python-sync")
            return None

    @property
    def decode_route(self):
        """How records are decoded: "native" (imagerec.cc threads),
        "processes/native" or "processes/python" (shm workers, libjpeg or
        PIL), or "python" (PIL in the consumer's thread)."""
        if self._pool is None:
            return "python"
        if self._pool.mode == "processes":
            return f"processes/{self._pool.worker_backend}"
        return "native"

    @property
    def _host_mirror(self):
        # device_augment moves the mirror coin-flip into the augment
        # kernel; the host decode must not also mirror
        return self._rand_mirror and not self._device_augment

    @property
    def num_records(self):
        return self._n

    def __len__(self):
        if self._n == 0:
            return 0
        if self._round_batch:
            return -(-self._n // self.batch_size)
        return self._n // self.batch_size

    def reset(self):
        self._epoch += 1
        if self._shuffle:
            rng = _np.random.RandomState(self._seed + self._epoch)
            self._order = rng.permutation(self._n)
        self._cursor = 0
        self._sched_cursor = 0
        self._inflight = []
        self._restarts = 0
        if self._pool is None:
            return
        self._pool.reset()
        self._fill_lookahead()

    def _force_python_fallback(self):
        """TEST hook: drop the native reader and its pool so subsequent
        epochs run the synchronous shared-augment-spec PIL path — the
        parity tests' way of exercising the fallback on a host where the
        native library built fine."""
        self._native = None
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        if not hasattr(self, "_pyds"):
            from ._imagerec_common import PyRecordIndex
            self._pyds = PyRecordIndex(self._path)
        self.reset()

    def close(self):
        """Stop the decode pool (workers/dispatcher); idempotent."""
        if getattr(self, "_pool", None) is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _epoch_seed(self):
        return self._seed * 1000003 + self._epoch

    def _batch_indices(self, cursor):
        if cursor >= self._n:
            return None
        idx = self._order[cursor:cursor + self.batch_size]
        if len(idx) < self.batch_size:
            if not self._round_batch:
                return None
            # pad by wrapping as often as needed (reference round_batch
            # semantics; datasets smaller than one batch wrap repeatedly so
            # the batch shape stays static)
            reps = -(-self.batch_size // self._n)
            wrapped = _np.concatenate([self._order] * reps)
            idx = _np.concatenate(
                [idx, wrapped[:self.batch_size - len(idx)]])
        return idx

    # -- pooled path: persistent producer, bounded lookahead -------------
    def _fill_lookahead(self):
        limit = min(self._ahead + 1, self._pool.n_slots)
        while len(self._inflight) < limit:
            idx = self._batch_indices(self._sched_cursor)
            if idx is None:
                return
            job = self._submit_with_restarts(idx)
            n_real = min(self.batch_size, self._n - self._sched_cursor)
            self._inflight.append((job, self._sched_cursor, n_real))
            self._sched_cursor += self.batch_size

    def _submit_with_restarts(self, idx):
        """`io.device_feed` semantics for the `io.imagerec` fault point:
        inject BEFORE the submit, retry transient I/O errors in place up
        to a bounded number of CONSECUTIVE times, re-raise the original
        exception once the budget is exhausted."""
        batch_id = self._batch_ids()   # a retry keeps the batch's slot
        while True:
            try:
                _fault.inject("io.imagerec")
                job = self._pool.submit(batch_id, idx, self._epoch_seed())
            except (IOError, OSError, TimeoutError) as e:
                if self._restarts < self._max_restarts:
                    self._restarts += 1
                    _bump_io("submit_restarts")
                    _fault._log_event("io.imagerec_restart",
                                      attempt=self._restarts, error=repr(e))
                    continue
                raise
            self._restarts = 0   # budget bounds CONSECUTIVE errors
            return job

    def next(self):
        if self._pool is None:
            return self._next_python()
        import time as _time
        self._fill_lookahead()
        if not self._inflight:
            raise StopIteration
        job, cursor, n_real = self._inflight.pop(0)
        t0 = _time.perf_counter()
        images_view, labels_view, failed = self._pool.wait(job)
        wait_us = (_time.perf_counter() - t0) * 1e6
        self._cursor = cursor + self.batch_size
        batch = self._stage(images_view, labels_view, job, cursor, n_real,
                            failed, wait_us)
        self._fill_lookahead()   # the consumed batch's slot is free again
        return batch

    def _stage(self, images_view, labels_view, job, cursor, n_real, failed,
               wait_us):
        """Move one decoded slot to the consumer: labels copy out (tiny);
        on the card the images go from the (page-locked) slot to the card
        by an asynchronous copy on the side stream, which the consumer's
        stream waits on, and the slot returns to the ring fenced on the
        copy's event; on the CPU they are copied out of the slot (a tensor
        over the slot would be rewritten by the next decode). In
        device_augment mode the batch then goes through the augment
        kernel."""
        import time as _time
        t0 = _time.perf_counter()
        dev = self._device
        labels = _torch.from_numpy(_np.array(labels_view))
        host = _torch.from_numpy(images_view)
        fence = None
        if dev.type == "cuda":
            # both copies from page-locked memory, so neither blocks the
            # host (a copy from pageable memory would wait for the
            # consumer's stream to drain)
            if job is None:          # a fresh array of the PIL path
                host = host.pin_memory()
            labels = labels.pin_memory()
            with _torch.cuda.device(dev), _torch.cuda.stream(self._stream):
                data = host.to(dev, non_blocking=True)
                labels = labels.to(dev, non_blocking=True)
                fence = _torch.cuda.Event()
                fence.record(self._stream)
            cur = _torch.cuda.current_stream(dev)
            cur.wait_event(fence)
            data.record_stream(cur)
            labels.record_stream(cur)
        elif job is not None:
            data = host.clone()
            _bump_io("alias_copies")
        else:
            data = host
        if self._pool is not None and job is not None:
            self._pool.release(job, fence=fence)
        data, labels = _wrap(data), _wrap(labels)
        if self._device_augment:
            data = self._augment_on_device(data, cursor)
        stage_us = (_time.perf_counter() - t0) * 1e6
        with _IO_STATS_LOCK:
            IO_STATS["batches"] += 1
            IO_STATS["images"] += int(n_real)
            IO_STATS["failed_records"] += int(failed)
            IO_STATS["stage_us"] += stage_us
            IO_STATS["wait_us"] += wait_us
            IO_STATS["bytes_staged"] += int(images_view.nbytes)
            if self._device_augment:
                IO_STATS["device_augment_batches"] += 1
        return DataBatch(data=[data], label=[labels],
                         pad=self.batch_size - n_real)

    def augment_key(self, cursor):
        """The (epoch seed, batch number) pair of uint32 the augment
        kernel's draws of the batch at `cursor` are seeded from."""
        batch_no = cursor // self.batch_size
        return (self._epoch_seed() & 0xFFFFFFFF, batch_no & 0xFFFFFFFF)

    def _augment_on_device(self, data_u8, cursor):
        """ONE launch of the augment kernel (npx.fused_image_augment) for
        mirror/normalize/cast, its mirror bits drawn from a generator
        seeded by (epoch, batch)."""
        from .. import numpy_extension as npx
        mean = tuple(self._mean) if self._mean is not None else None
        std = tuple(self._std) if self._std is not None else None
        return npx.fused_image_augment(
            data_u8, self.augment_key(cursor), mean=mean, std=std,
            rand_mirror=bool(self._rand_mirror), out_dtype=self._dtype)

    # -- synchronous fallback (shared augment spec; PIL decode) ----------
    def _next_python(self):
        idx = self._batch_indices(self._cursor)
        if idx is None:
            raise StopIteration
        n_real = min(self.batch_size, self._n - self._cursor)
        cursor = self._cursor
        self._cursor += self.batch_size
        h, w = self._hw
        from . import _imagerec_common as common
        out_u8 = self._handoff_u8
        images = _np.zeros((len(idx), h, w, 3),
                           _np.uint8 if out_u8 else _np.float32)
        labels = _np.zeros((len(idx), self._label_width), _np.float32)
        failed = 0
        eseed = self._epoch_seed()
        for k, i in enumerate(idx):
            try:
                img, lab = common.process_record(
                    self._payload(int(i)), h, w, self._resize,
                    self._rand_crop, self._host_mirror,
                    common.record_seed(eseed, int(i)), self._label_width,
                    out_u8, mean=self._mean, std=self._std)
                images[k] = img
                labels[k] = lab
            except ValueError:       # corrupt record: native parity
                labels[k] = -1.0
                failed += 1
        return self._stage(images, labels, None, cursor, n_real, failed,
                           0.0)

    def _payload(self, i):
        ds = self._pyds
        if hasattr(ds, "payload"):
            return ds.payload(i)
        return ds._rec[i]            # gluon ImageRecordDataset shim


__all__ += ["ImageRecordIter"]

from .device_feed import (DeviceFeed, prefetch_to_device,  # noqa: E402
                          feed_stats, maybe_device_put)

__all__ += ["DeviceFeed", "prefetch_to_device", "feed_stats",
            "maybe_device_put"]
