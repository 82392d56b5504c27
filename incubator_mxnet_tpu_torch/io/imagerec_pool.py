"""Persistent decode pool with ring-slot handoff for ImageRecordIter (the
PyTorch port's counterpart of `incubator_mxnet_tpu/io/imagerec_pool.py`).

A persistent producer over a bounded ring of preallocated batch slots
(`MXNET_IMAGEREC_LOOKAHEAD` batches decoded ahead of the consumer), in one
of two modes:

  * **threads** (`MXNET_IO_WORKERS=0`, default): one persistent
    dispatcher thread feeds whole batches to the in-process native
    thread pool (imagerec.cc) — no process boundary, slots are plain
    numpy arrays.
  * **processes** (`MXNET_IO_WORKERS=N`): N persistent bare-subprocess
    workers (`io/_shm_worker.py`) each decode a contiguous shard of every
    batch straight into a `multiprocessing.shared_memory` ring slot — no
    per-batch spawn, no pickling of image arrays, and the PIL/pure-Python
    fallback scales across cores (≙ the decode-thread pool of the
    reference's iter_image_recordio_2.cc). Worker launch failure falls
    back to threads mode with a structured log.

Page-locked slots: with `pin=True` (a consumer on the card) the ring is
page-locked once, so the consumer's host-to-card copy from a slot is a
real asynchronous DMA on its side stream: threads mode allocates its
slots pinned, processes mode registers the shared-memory segment with
`cudaHostRegister` (and unregisters it before the segment is unlinked).

Slot lifecycle: `submit(batch)` may only reuse a slot the consumer has
`release`d; a release can carry a `fence` (the CUDA event recorded after
the copy FROM the slot) and the producer waits on it before rewriting —
the card's read of slot memory completes before the decode that would
clobber it (a CPU consumer copies before the release, so it passes none).

Worker death is never silent: a died worker is restarted (its in-flight
shard commands re-sent — the record indices still sit in the slot's shm
index region) up to a bounded number of CONSECUTIVE times
(`MXNET_PREFETCH_RESTARTS`, the `io.device_feed` semantics), then the
original failure (worker stderr tail) re-raises in the consumer's
`next()`.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import subprocess
import sys
import threading
import time
import weakref

import numpy as _np

from ..base import MXNetError, get_env
from ..fault import _log_event

__all__ = ["DecodePool"]

# every live pool closes at interpreter exit, BEFORE CPython freezes
# daemon threads: a dispatcher frozen inside a native read_batch while the
# reader's C++ thread pool tears down is how "terminate called without an
# active exception" happens at shutdown
_LIVE_POOLS = weakref.WeakSet()
_ATEXIT_ARMED = [False]


def _close_live_pools():
    for pool in list(_LIVE_POOLS):
        try:
            pool.close()
        except Exception:
            pass


class _Batch:
    __slots__ = ("batch_id", "slot", "n", "event", "failed", "error",
                 "pending_shards", "seed")

    def __init__(self, batch_id, slot, n, seed):
        self.batch_id = batch_id
        self.slot = slot
        self.n = n
        self.seed = seed
        self.event = threading.Event()
        self.failed = 0
        self.error = None
        self.pending_shards = 0


class DecodePool:
    """See module docstring. `reader` is a NativeImageRecordFile (threads
    mode and `advise`) or None (PIL in-process fallback uses workers or
    the synchronous path in ImageRecordIter instead)."""

    def __init__(self, rec_path, hw, capacity, out_u8, resize, rand_crop,
                 rand_mirror, mean, std, label_width, reader=None,
                 workers=0, lookahead=2, shm_mb=None, max_restarts=None,
                 pin=False):
        self._rec_path = rec_path
        self._h, self._w = int(hw[0]), int(hw[1])
        self._cap = int(capacity)
        self._out_u8 = bool(out_u8)
        self._resize = int(resize)
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._mean = list(mean) if mean is not None else None
        self._std = list(std) if std is not None else None
        self._label_width = int(label_width)
        self._reader = reader
        self._lookahead = max(1, int(lookahead))
        self._n_slots = self._lookahead + 1
        self._max_restarts = (get_env("MXNET_PREFETCH_RESTARTS", 3, typ=int)
                              if max_restarts is None else int(max_restarts))
        self._lock = threading.Lock()
        self._batches = {}          # batch_id -> _Batch
        self._slot_free = [True] * self._n_slots
        self._slot_fence = [None] * self._n_slots
        self._closed = False
        self._itemsize = 1 if out_u8 else 4
        self._img_dtype = _np.uint8 if out_u8 else _np.float32
        self._pin = bool(pin)
        self._registered = None     # the cudaHostRegister'ed shm address

        _LIVE_POOLS.add(self)
        if not _ATEXIT_ARMED[0]:
            _ATEXIT_ARMED[0] = True
            atexit.register(_close_live_pools)
        self._workers = []
        self._proc_mode = False
        if workers > 0:
            try:
                self._start_proc_mode(int(workers), shm_mb)
                self._proc_mode = True
            except Exception as e:
                _log_event("io.imagerec_pool_fallback",
                           error=f"{type(e).__name__}: {e}", mode="threads")
                self._start_thread_mode()
        else:
            self._start_thread_mode()

    # -- slot plumbing ---------------------------------------------------
    def _slot_arrays(self, s):
        return self._slots[s]

    def _alloc_plain_slots(self):
        slots = []
        for _ in range(self._n_slots):
            slots.append((
                self._image_buffer(),
                _np.empty((self._cap, self._label_width), _np.float32),
                _np.empty((self._cap,), _np.int64)))
        with self._lock:        # published before any producer thread runs
            self._slots = slots
            self._shm = None

    def _image_buffer(self):
        """One slot's image array: page-locked under `pin` (a numpy view of
        a pinned tensor, which the view keeps alive)."""
        shape = (self._cap, self._h, self._w, 3)
        if not self._pin:
            return _np.empty(shape, self._img_dtype)
        import torch
        return torch.empty(shape, dtype=torch.uint8 if self._out_u8
                           else torch.float32, pin_memory=True).numpy()

    def _register(self, shm):
        """Page-lock the shared-memory segment once (cudaHostRegister), so
        copies from its slots run as asynchronous DMA."""
        import ctypes

        import torch
        addr = ctypes.addressof(ctypes.c_char.from_buffer(shm.buf))
        rc = torch.cuda.cudart().cudaHostRegister(addr, shm.size, 0)
        if int(rc) != 0:
            raise MXNetError(f"cudaHostRegister of the decode ring "
                             f"({shm.size >> 20} MB) failed: error {int(rc)}")
        self._registered = addr

    def _unregister(self):
        if self._registered is not None:
            import torch
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None

    # -- threads mode ----------------------------------------------------
    def _start_thread_mode(self):
        if self._reader is None:
            raise MXNetError("imagerec thread mode needs the native reader")
        self._alloc_plain_slots()
        with self._lock:
            self._queue = collections.deque()
        self._cv = threading.Condition(self._lock)
        self._thread = threading.Thread(target=self._thread_main,
                                        daemon=True,
                                        name="mx-imagerec-dispatch")
        self._thread.start()

    def _thread_main(self):
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                job = self._queue.popleft()
            images, labels, indices = self._slot_arrays(job.slot)
            idx = indices[:job.n]
            try:
                if self._out_u8:
                    _, _, failed = self._reader.read_batch_u8(
                        idx, (self._h, self._w, 3), resize=self._resize,
                        rand_crop=self._rand_crop,
                        rand_mirror=self._rand_mirror, seed=job.seed,
                        label_width=self._label_width,
                        out_images=images[:job.n],
                        out_labels=labels[:job.n])
                else:
                    _, _, failed = self._reader.read_batch(
                        idx, (self._h, self._w, 3), resize=self._resize,
                        rand_crop=self._rand_crop,
                        rand_mirror=self._rand_mirror, seed=job.seed,
                        mean=self._mean, std=self._std,
                        label_width=self._label_width,
                        out_images=images[:job.n],
                        out_labels=labels[:job.n])
                job.failed = int(failed)
            except BaseException as e:
                job.error = e
            job.event.set()

    # -- process mode ----------------------------------------------------
    def _start_proc_mode(self, n_workers, shm_mb):
        from multiprocessing import shared_memory
        if shm_mb is None:
            shm_mb = get_env("MXNET_IO_SHM_MB", 256, typ=int)
        img_b = self._cap * self._h * self._w * 3 * self._itemsize
        lab_b = self._cap * self._label_width * 4
        idx_b = self._cap * 8
        self._slot_bytes = (img_b, lab_b, idx_b)
        slot_total = img_b + lab_b + idx_b
        budget = int(shm_mb) * (1 << 20)
        if slot_total * 2 > budget:
            raise MXNetError(
                f"MXNET_IO_SHM_MB={shm_mb} cannot hold 2 ring slots of "
                f"{slot_total >> 20} MB (batch {self._cap} x "
                f"{self._h}x{self._w}x3 {'u8' if self._out_u8 else 'f32'})"
                f" — raise it or lower batch/lookahead")
        self._n_slots = max(2, min(self._n_slots, budget // slot_total))
        self._lookahead = min(self._lookahead, self._n_slots - 1)
        self._slot_free = [True] * self._n_slots
        self._slot_fence = [None] * self._n_slots
        shm = shared_memory.SharedMemory(
            create=True, size=slot_total * self._n_slots)
        if self._pin:
            try:
                self._register(shm)
            except BaseException:
                shm.unlink()
                shm.close()
                raise
        slots = []
        for s in range(self._n_slots):
            base = s * slot_total
            slots.append((
                _np.ndarray((self._cap, self._h, self._w, 3),
                            self._img_dtype, shm.buf, base),
                _np.ndarray((self._cap, self._label_width), _np.float32,
                            shm.buf, base + img_b),
                _np.ndarray((self._cap,), _np.int64, shm.buf,
                            base + img_b + lab_b)))
        native_dir = ""
        if self._reader is not None:     # .so built + fresh: workers CDLL it
            native_dir = os.path.dirname(os.path.abspath(
                sys.modules[type(self._reader).__module__].__file__))
        with self._lock:        # published before any collector thread runs
            self._shm = shm
            self._slots = slots
            self._worker_cfg = {
                "shm_name": shm.name, "h": self._h, "w": self._w,
                "label_width": self._label_width,
                "slot_capacity": self._cap, "n_slots": self._n_slots,
                "out": "u8" if self._out_u8 else "f32",
                "resize": self._resize, "rand_crop": self._rand_crop,
                "rand_mirror": self._rand_mirror, "mean": self._mean,
                "std": self._std, "rec_path": self._rec_path,
                "native_dir": native_dir, "native_threads": 1,
            }
            self._restarts_left = self._max_restarts
            self._respawning = 0
        self._proc_cv = threading.Condition(self._lock)
        spawned = []
        try:
            for wid in range(n_workers):
                spawned.append(self._spawn_worker(wid))
        except Exception:
            # partial startup: kill what spawned and unlink the segment
            # NOW — the threads-mode fallback allocates fresh plain slots
            # and would silently orphan this shm in /dev/shm
            for st in spawned:
                try:
                    st["proc"].kill()
                except Exception:
                    pass
            with self._lock:
                self._slots = None
                self._shm = None
            self._unregister()
            try:
                shm.unlink()
            except Exception:
                pass
            try:
                shm.close()
            except Exception:
                pass
            raise
        with self._lock:
            self._workers.extend(spawned)
            self.worker_backend = spawned[-1]["backend"] if spawned else None

    def _spawn_worker(self, wid):
        import tempfile
        worker_py = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "_shm_worker.py")
        # the worker imports no torch; an empty device list keeps anything
        # it loads off the card all the same
        env = dict(os.environ, PYTHONUNBUFFERED="1", CUDA_VISIBLE_DEVICES="")
        # stderr spools to an unlinked temp FILE, not a pipe: libjpeg
        # warnings ("Corrupt JPEG data: ...") go there per record, and a
        # worker blocking on a full 64KB stderr pipe mid-decode would hang
        # the consumer forever; the file is unbounded and seekable for the
        # death-diagnostic tail
        stderr_f = tempfile.TemporaryFile()
        proc = subprocess.Popen(
            [sys.executable, worker_py], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=stderr_f, text=True,
            env=env)
        proc.stdin.write(json.dumps(self._worker_cfg) + "\n")
        proc.stdin.flush()
        ready = json.loads(proc.stdout.readline())
        if not ready.get("ready"):
            raise MXNetError(f"imagerec worker {wid} failed to start: "
                             f"{ready}")
        state = {"proc": proc, "wid": wid, "outstanding": {},
                 "dead": False, "backend": ready.get("backend"),
                 "stderr_file": stderr_f}
        t = threading.Thread(target=self._collect, args=(state,),
                             daemon=True, name=f"mx-imagerec-collect-{wid}")
        state["thread"] = t
        t.start()
        return state

    def _collect(self, state):
        proc = state["proc"]
        for line in proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            with self._lock:
                key = (msg.get("batch"), msg.get("start"))
                state["outstanding"].pop(key, None)
                job = self._batches.get(msg.get("batch"))
                if job is None:      # stale reply from a pre-reset epoch
                    continue
                if "stages" in msg:
                    from . import _note_worker_stages
                    _note_worker_stages(msg["stages"])
                if "error" in msg:
                    if job.error is None:
                        job.error = MXNetError(
                            f"imagerec worker error: {msg['error']}")
                else:
                    job.failed += int(msg.get("failed", 0))
                    self._restarts_left = self._max_restarts
                # the event only fires once EVERY shard has resolved
                # (success or error): wait()/reset() must not run while a
                # sibling worker is still writing into the slot
                job.pending_shards -= 1
                if job.pending_shards <= 0:
                    job.event.set()
        # EOF: worker died (or quit during close). Never silent: an IDLE
        # death (no in-flight shard — e.g. the OOM killer between batches)
        # is respawned and logged too, or the pool would quietly run
        # degraded until the last worker died.
        with self._lock:
            if self._closed or state.get("quitting"):
                return
            state["dead"] = True
            outstanding = dict(state["outstanding"])
            err_tail = self._stderr_tail(state)
            do_restart = self._restarts_left > 0
            if do_restart:
                self._restarts_left -= 1
                self._respawning += 1   # submit() waits instead of raising
                #                         "all workers dead" mid-respawn
                from . import IO_STATS, _IO_STATS_LOCK
                with _IO_STATS_LOCK:
                    IO_STATS["worker_restarts"] += 1
                _log_event("io.imagerec_restart",
                           worker=state["wid"], error=err_tail[-200:],
                           restarts_left=self._restarts_left,
                           inflight_shards=len(outstanding))
        if do_restart:
            # spawn OUTSIDE the lock: a fresh worker costs ~0.2 s (python +
            # numpy start) and must not stall submit()/release() or the
            # other collectors while the remaining workers are healthy
            try:
                new_state = self._spawn_worker(state["wid"])
            except Exception as e:
                with self._lock:
                    self._respawning -= 1
                    self._proc_cv.notify_all()
                    self._fail_outstanding(
                        outstanding,
                        MXNetError(f"imagerec worker {state['wid']} died "
                                   f"and restart failed: {e}; stderr: "
                                   f"{err_tail}"))
                return
            with self._lock:
                # the fresh worker re-decodes the in-flight shards (record
                # indices are still in the slot shm regions: nothing lost).
                # Register BEFORE the write and swallow a broken pipe, like
                # submit(): if this worker is already dead too, ITS
                # collector's EOF path re-sends (or fails) under the same
                # budget — a write raise here would kill this collector
                # with _respawning stuck and the job hung forever
                for (batch_id, start), cmd in outstanding.items():
                    new_state["outstanding"][(batch_id, start)] = cmd
                    try:
                        new_state["proc"].stdin.write(json.dumps(cmd) + "\n")
                    except OSError:
                        pass
                try:
                    new_state["proc"].stdin.flush()
                except OSError:
                    pass
                self._workers[self._workers.index(state)] = new_state
                self._respawning -= 1
                self._proc_cv.notify_all()
        elif outstanding:
            with self._lock:
                self._fail_outstanding(outstanding, MXNetError(
                    f"imagerec worker {state['wid']} died "
                    f"(restart budget exhausted); stderr: {err_tail}"))
        else:
            _log_event("io.imagerec_worker_dead",
                       worker=state["wid"], error=err_tail[-200:],
                       restarts_left=0)

    @staticmethod
    def _stderr_tail(state):
        try:
            f = state["stderr_file"]
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 2000))
            return f.read().decode("utf-8", "replace")
        except Exception:
            return ""

    def _fail_outstanding(self, outstanding, error):
        # each dead shard will never reply: account it resolved (failed),
        # so the job's event still only fires once sibling workers' shards
        # have also resolved (they may still be writing into the slot)
        for (batch_id, _), _cmd in outstanding.items():
            job = self._batches.get(batch_id)
            if job is None:
                continue
            if job.error is None:
                job.error = error
            job.pending_shards -= 1
            if job.pending_shards <= 0:
                job.event.set()

    # -- producer API ----------------------------------------------------
    def submit(self, batch_id, indices, seed):
        """Schedule decode of `indices` into the ring (consumer thread;
        non-blocking except for the slot-reuse fence). The caller enforces
        the lookahead bound, so a free slot always exists."""
        indices = _np.ascontiguousarray(indices, dtype=_np.int64)
        n = len(indices)
        slot = batch_id % self._n_slots
        with self._lock:
            if not self._slot_free[slot]:
                raise MXNetError(f"slot {slot} not released (lookahead "
                                 f"bound violated)")
            fence = self._slot_fence[slot]
            self._slot_fence[slot] = None
            self._slot_free[slot] = False
        if fence is not None:
            # the card's copy from this slot must finish before the rewrite
            fence.synchronize()
        if self._reader is not None:
            try:
                self._reader.advise(indices)
            except Exception:
                pass
        job = _Batch(batch_id, slot, n, seed)
        images, labels, idx_region = self._slot_arrays(slot)
        idx_region[:n] = indices
        with self._lock:
            self._batches[batch_id] = job
            if self._proc_mode:
                live = [w for w in self._workers if not w["dead"]]
                deadline = time.monotonic() + 60
                while not live and self._respawning > 0:
                    # a collector is mid-respawn: wait for the fresh
                    # worker instead of failing spuriously
                    rem = deadline - time.monotonic()
                    if rem <= 0 or not self._proc_cv.wait(timeout=rem):
                        break
                    live = [w for w in self._workers if not w["dead"]]
                if not live:
                    # release what this submit claimed, or the NEXT call
                    # masks the real failure as "slot not released" and
                    # reset() blocks on an event that can never fire
                    self._slot_free[slot] = True
                    self._batches.pop(batch_id, None)
                    raise MXNetError("all imagerec workers dead")
                shards = self._shard(n, len(live))
                job.pending_shards = len(shards)
                for w, (start, count) in zip(live, shards):
                    cmd = {"op": "decode", "batch": batch_id, "slot": slot,
                           "start": start, "count": count,
                           "seed": seed}
                    # registered BEFORE the write: if the pipe is already
                    # broken, the collector's EOF path re-sends this cmd
                    # on the restarted worker
                    w["outstanding"][(batch_id, start)] = cmd
                    try:
                        w["proc"].stdin.write(json.dumps(cmd) + "\n")
                        w["proc"].stdin.flush()
                    except OSError:
                        pass
            else:
                self._queue.append(job)
                self._cv.notify()
        return job

    @staticmethod
    def _shard(n, k):
        """Contiguous split of n records over <=k workers (non-empty)."""
        k = min(k, n) or 1
        base, rem = divmod(n, k)
        shards, start = [], 0
        for i in range(k):
            cnt = base + (1 if i < rem else 0)
            shards.append((start, cnt))
            start += cnt
        return shards

    def wait(self, job):
        """Block until `job`'s slot is fully decoded; re-raise the ORIGINAL
        producer/worker failure in the consumer. Returns
        (images_view, labels_view, failed)."""
        job.event.wait()
        if job.error is not None:
            # every shard has resolved (the event contract), so the slot
            # can return to the ring — a later submit must hit the REAL
            # error path again, not "slot not released"
            with self._lock:
                self._batches.pop(job.batch_id, None)
                self._slot_free[job.slot] = True
            raise job.error
        images, labels, _ = self._slot_arrays(job.slot)
        return images[:job.n], labels[:job.n], job.failed

    def release(self, job, fence=None):
        """Return `job`'s slot to the ring. `fence`: the CUDA event of the
        copy from the slot — the producer waits on it before rewriting."""
        with self._lock:
            self._batches.pop(job.batch_id, None)
            self._slot_fence[job.slot] = fence
            self._slot_free[job.slot] = True

    def reset(self):
        """Abandon in-flight batches (epoch reset): cancel queued-not-
        started jobs, then wait for running decodes to quiesce (their
        replies still resolve through `self._batches`) so a new epoch's
        decode cannot race a stale shard into the same slot."""
        with self._lock:
            if not self._proc_mode:
                for job in self._queue:     # never started: nothing writes
                    self._batches.pop(job.batch_id, None)
                    job.event.set()
                self._queue.clear()
            abandoned = list(self._batches.values())
        for job in abandoned:
            if not job.event.wait(timeout=30):
                # falling through would mark the slot free while the stale
                # decode still writes into it — two epochs' pixels
                # interleaved in one delivered batch, silently
                raise MXNetError(
                    "imagerec pool reset timed out after 30s waiting for "
                    f"an in-flight decode (batch {job.batch_id}; worker "
                    "wedged?)")
        with self._lock:
            self._batches.clear()
            self._slot_free = [True] * self._n_slots
            self._slot_fence = [None] * self._n_slots

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not self._proc_mode:
                self._cv.notify_all()
        for w in self._workers:
            w["quitting"] = True
            try:
                w["proc"].stdin.write('{"op": "quit"}\n')
                w["proc"].stdin.flush()
            except Exception:
                pass
        for w in self._workers:
            try:
                w["proc"].wait(timeout=5)
            except Exception:
                w["proc"].kill()
            try:
                w["stderr_file"].close()
            except Exception:
                pass
        t = getattr(self, "_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)   # dispatcher out of native code before exit
        if getattr(self, "_registered", None) is not None:
            try:        # before the segment is unmapped
                self._unregister()
            except Exception:
                pass
        if getattr(self, "_shm", None) is not None:
            with self._lock:
                self._slots = None  # drop slot views: shm.close() refuses
                #                     while ndarrays still export its buffer
            try:
                # unlink FIRST (shm_unlink on the name): even if close()
                # raises BufferError on a still-exported view, the segment
                # must not outlive the pool in /dev/shm
                self._shm.unlink()
            except Exception:
                pass
            try:
                self._shm.close()
            except Exception:
                pass
            self._shm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def n_slots(self):
        return self._n_slots

    @property
    def lookahead(self):
        return self._lookahead

    @property
    def mode(self):
        return "processes" if self._proc_mode else "threads"
