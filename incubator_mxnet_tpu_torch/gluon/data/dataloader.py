"""DataLoader of the PyTorch port (≙ python/mxnet/gluon/data/dataloader.py:
307/514; the counterpart of `incubator_mxnet_tpu/gluon/data/dataloader.py`).

Batches are numpy work: a thread pool (decode/augment release the GIL in
numpy/PIL) prefetches `prefetch` batches ahead, or, for GIL-bound Python
transforms, spawned worker processes (`thread_pool=False`) assemble them
straight into shared memory. The workers are spawned, never forked (a live
CUDA context is not fork-safe), with `CUDA_VISIBLE_DEVICES` empty before
anything in them imports torch, and they build numpy batches only: no
worker touches the card. With `prefetch_to_device=True` (or
`MXNET_PREFETCH_TO_DEVICE=1`) the host batches go through `io.DeviceFeed`:
page-locked staging and a side CUDA stream, so host assembly and the copy
overlap the consumer's step. A batch fetch that fails with a transient
I/O error is retried with backoff (`MXNET_DATALOADER_RETRIES` attempts, the
`dataloader.fetch` fault point).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError

import numpy as _np

from ... import fault as _fault
from ...base import MXNetError, get_env
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (≙ dataloader.default_batchify_fn)."""
    from ...ndarray import NDArray, array
    if isinstance(data[0], NDArray):
        from ...ndarray import stack
        return stack(*data, axis=0)
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(s)) for s in zip(*data))
    arr = _np.asarray(data)
    return array(arr)


default_mp_batchify_fn = default_batchify_fn


class DataLoader:
    """≙ gluon.data.DataLoader(dataset, batch_size, shuffle, sampler,
    last_batch, batch_sampler, batchify_fn, num_workers, pin_memory,
    prefetch, thread_pool, timeout, prefetch_to_device)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=True, timeout=120,
                 try_nopython=None, prefetch_to_device=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle conflicts with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_sampler conflicts with batch_size/"
                             "shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._use_processes = (not thread_pool) and num_workers > 0
        self._user_batchify = batchify_fn
        if self._use_processes and batchify_fn is None:
            batchify_fn = _host_batchify
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pin_memory = pin_memory
        self._timeout = timeout
        # transient fetch errors (flaky storage, network FS) retry with
        # backoff instead of killing the epoch; bound via
        # MXNET_DATALOADER_RETRIES (default 3 attempts). Wrapped once here,
        # not per batch — _make_batch is the hot path.
        self._make_batch = _fault.retrying(
            max_attempts=get_env("MXNET_DATALOADER_RETRIES", 3, typ=int),
            name="dataloader.fetch")(self._fetch_batch)
        # opt-in device prefetch (MXNET_PREFETCH_TO_DEVICE, or the explicit
        # kwarg): host batches stage onto the device through io.DeviceFeed
        # so host assembly + the copy overlap the consumer's step
        self._prefetch_to_device = (
            get_env("MXNET_PREFETCH_TO_DEVICE", False, typ=bool)
            if prefetch_to_device is None else bool(prefetch_to_device))
        self._feeds_device = self._prefetch_to_device
        # an EXPLICIT falsy prefetch_to_device is an opt-out that downstream
        # wrappers must respect
        self._prefetch_opt_out = (prefetch_to_device is not None
                                  and not prefetch_to_device)

    def _fetch_batch(self, indices, host, device):
        # a worker thread runs in the consumer's device scope (`with
        # mx.cpu():` included), which is thread-local
        _fault.inject("dataloader.fetch")
        with device:
            samples = [self._dataset[i] for i in indices]
            if host and self._user_batchify is None:
                # the feed stages host batches itself (page-locked, async)
                return _host_batchify(samples)
            return self._batchify_fn(samples)

    def __iter__(self):
        from ...device import current_device
        device = current_device()
        if self._prefetch_to_device:
            from ...io.device_feed import DeviceFeed
            feed = DeviceFeed(self._host_iter(True, device), device=device)
            try:
                yield from feed
            finally:
                feed.close()
            return
        yield from self._host_iter(False, device)

    def _host_iter(self, host, device):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices, host, device)
            return
        if self._use_processes:
            yield from self._iter_processes(host, device)
            return
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        stalled = False
        try:
            it = iter(self._batch_sampler)
            pending = []
            for indices in itertools.islice(it, self._prefetch + 1):
                pending.append(pool.submit(self._make_batch, indices, host,
                                           device))
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._make_batch, nxt, host,
                                               device))
                try:
                    yield fut.result(timeout=self._timeout)
                except FuturesTimeoutError:
                    stalled = True
                    raise MXNetError(
                        f"DataLoader batch fetch exceeded {self._timeout}s "
                        "(worker stalled; raise timeout= or check the "
                        "dataset's I/O)") from None
        finally:
            # on stall, skip the join so the timeout error surfaces to the
            # caller now instead of hanging here
            pool.shutdown(wait=not stalled, cancel_futures=True)

    def _iter_processes(self, host, device):
        """Spawned process workers + shared-memory batch rebuild
        (≙ reference worker_loop; thread_pool=False, num_workers>0)."""
        import multiprocessing as mp
        import pickle
        from multiprocessing import TimeoutError as MPTimeoutError
        ctx = mp.get_context("spawn")
        payload = pickle.dumps((self._dataset, self._batchify_fn))
        pending = []
        with _cuda_hidden():
            # every worker starts here, with the card hidden from it
            pool = ctx.Pool(self._num_workers, initializer=_mp_worker_init,
                            initargs=(payload,))
        try:
            it = iter(self._batch_sampler)
            for indices in itertools.islice(it, self._prefetch + 1):
                pending.append(pool.apply_async(_mp_worker_batch,
                                                (list(indices),)))
            while pending:
                res = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.apply_async(_mp_worker_batch,
                                                    (list(nxt),)))
                try:
                    spec, descs = res.get(timeout=self._timeout)
                except MPTimeoutError:
                    raise MXNetError(
                        f"DataLoader batch fetch exceeded {self._timeout}s "
                        "(worker stalled; raise timeout= or check the "
                        "dataset's I/O)") from None
                with device:
                    batch = _rebuild_batch(spec, descs, host)
                yield batch
        finally:
            # the PARENT owns every produced block (workers unregister
            # them): on early exit / error, drain pending results and
            # unlink their segments, else up to prefetch+1 batches of
            # /dev/shm leak per abandoned epoch
            for res in pending:
                try:
                    _, descs = res.get(timeout=self._timeout)
                    _release_descs(descs)
                except Exception:
                    pass
            pool.terminate()
            pool.join()

    def __len__(self):
        return len(self._batch_sampler)


# ---------------------------------------------------------------------------
# Multiprocessing workers + shared-memory batch rebuild (≙ the reference's
# worker_loop + CPUSharedStorageManager, dataloader.py:47-88,514). For
# GIL-BOUND Python transforms on multi-core hosts; numpy/PIL-heavy
# pipelines usually do as well in thread mode (the default).
#
# Safety model: workers are SPAWNED (never forked) with CUDA_VISIBLE_DEVICES
# empty in their environment from the start (and set again by the
# initializer), so a worker cannot reach the card even if a dataset
# touches CUDA. Batches travel as multiprocessing.shared_memory blocks: the
# worker assembles host arrays straight into the block, the parent copies
# them out — no pickling of bulk data.
# ---------------------------------------------------------------------------

_MP_STATE = {}
_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def _cuda_hidden():
    """CUDA_VISIBLE_DEVICES empty in this process's environment for the
    block, which a process spawned in it inherits (the parent's own CUDA
    context, made earlier, is not affected)."""
    with _ENV_LOCK:
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            yield
        finally:
            if saved is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _host_array(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "numpy") and hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _host_batchify(data):
    """Worker-side batchify: numpy in, numpy out (no NDArray creation)."""
    if isinstance(data[0], (tuple, list)):
        return tuple(_host_batchify(list(s)) for s in zip(*data))
    return _np.stack([_host_array(d) for d in data])


def _mp_worker_init(payload):
    # the dataset/batchify travel as PICKLED BYTES, unpickled here after
    # the card is hidden again (a replacement worker the pool starts later
    # is spawned outside `_cuda_hidden`)
    import pickle
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    dataset, batchify_fn = pickle.loads(payload)
    _MP_STATE["dataset"] = dataset
    _MP_STATE["batchify"] = batchify_fn


def _flatten_batch(batch):
    if isinstance(batch, (tuple, list)):
        leaves, subspecs = [], []
        for b in batch:
            sub_leaves, sub_spec = _flatten_batch(b)
            leaves.extend(sub_leaves)
            subspecs.append(sub_spec)
        kind = "tuple" if isinstance(batch, tuple) else "list"
        return leaves, (kind, subspecs)
    if isinstance(batch, dict):
        keys = list(batch)
        leaves, subspecs = [], []
        for k in keys:
            sub_leaves, sub_spec = _flatten_batch(batch[k])
            leaves.extend(sub_leaves)
            subspecs.append(sub_spec)
        return leaves, ("dict", keys, subspecs)
    return [batch], None


def _unflatten_batch(spec, leaves_iter):
    if spec is None:
        return next(leaves_iter)
    if spec[0] == "dict":
        _, keys, subspecs = spec
        return {k: _unflatten_batch(s, leaves_iter)
                for k, s in zip(keys, subspecs)}
    kind, subspecs = spec
    seq = [_unflatten_batch(s, leaves_iter) for s in subspecs]
    return tuple(seq) if kind == "tuple" else seq


def _mp_worker_batch(indices):
    from multiprocessing import resource_tracker, shared_memory

    from ...device import cpu
    ds = _MP_STATE["dataset"]
    fn = _MP_STATE["batchify"]
    with cpu():                 # arrays a dataset makes stay on the host
        samples = [ds[i] for i in indices]
        batch = fn(samples)
    leaves, spec = _flatten_batch(batch)
    descs = []
    for a in leaves:
        a = _np.ascontiguousarray(_host_array(a))
        shm = shared_memory.SharedMemory(create=True,
                                         size=max(a.nbytes, 1))
        view = _np.ndarray(a.shape, a.dtype, buffer=shm.buf)
        view[...] = a
        descs.append((shm.name, a.shape, str(a.dtype)))
        del view
        shm.close()
        # ownership transfers to the parent (which unlinks after the copy);
        # without unregistering, this process's resource tracker would
        # whine about a "leaked" block it no longer owns
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
    return spec, descs


def _release_descs(descs):
    """Unlink produced-but-unconsumed shared-memory blocks."""
    from multiprocessing import shared_memory
    for name, _shape, _dtype in descs:
        try:
            shm = shared_memory.SharedMemory(name=name)
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass


def _rebuild_batch(spec, descs, host=False):
    """Parent side: attach each block, copy it out (as numpy for a device
    feed, else as an NDArray on the current device), release."""
    from multiprocessing import shared_memory

    from ...ndarray import array
    leaves = []
    for name, shape, dtype in descs:
        shm = shared_memory.SharedMemory(name=name)
        try:
            view = _np.ndarray(tuple(shape), _np.dtype(dtype),
                               buffer=shm.buf)
            leaf = view.copy()
            del view
            leaves.append(leaf if host else array(leaf))
        finally:
            shm.close()
            shm.unlink()
    return _unflatten_batch(spec, iter(leaves))
