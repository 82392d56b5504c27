"""Slotted KV-cache pool for the continuous-batching decode engine.

Counterpart of `incubator_mxnet_tpu/serve/kv_pool.py`:

  * ONE pair of fixed-shape device tensors carved at startup — `k`/`v`
    of shape `(max_slots + 1, layers, max_len, heads, head_dim)`. Each
    admitted request claims one row (its whole `max_len` page); row
    `max_slots` is the GARBAGE ROW, the write target of inactive lanes.
  * The step programs update the slabs IN PLACE (indexed assignment into
    `pool.k`/`pool.v`), where the JAX package donates the buffers and
    swaps in the program's outputs; the tensors are never reallocated
    while the engine serves.
  * Claim/free is host bookkeeping under one lock.
  * A freed slot's rows are NOT zeroed: the attention masks clamp every
    read to `[0, cur_len]` of the current request. `poison()` and
    `poison_slot()` let tests prove it.

Float slabs only (float32, bfloat16, float16): int8 KV with per-position
scales is not ported yet and raises `ServeError`.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError, get_env, torch_dtype
from ..device import resolve_device
from .batcher import ServeError

__all__ = ["SlotsFullError", "KVCachePool"]


class SlotsFullError(ServeError):
    """`claim()` found no free KV slot: the pool is at capacity."""


class KVCachePool:
    """Preallocated KV-cache slab on a device + slot claim/free bookkeeping.

    ::

        pool = KVCachePool(max_slots=8, layers=2, max_len=128,
                           heads=4, head_dim=16, device="cpu")
        slot = pool.claim()          # 0 <= slot < max_slots
        ...                          # step programs write pool.k/v in place
        pool.free(slot)

    `device` defaults to `cuda` and raises when no card is present.
    Buffer access is single-writer by the engine contract (one scheduler
    thread runs the steps); claim/free/free_count/in_use take the lock.
    """

    def __init__(self, max_slots=None, *, layers, max_len, heads,
                 head_dim, dtype="float32", device=None, allocate=True):
        self.max_slots = int(
            max_slots if max_slots is not None
            else get_env("MXNET_SERVE_MAX_SLOTS", 8, typ=int))
        if self.max_slots < 1:
            raise ServeError("KVCachePool needs max_slots >= 1")
        self.layers = int(layers)
        self.max_len = int(max_len)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.dtype = str(dtype)
        if self.dtype == "int8":
            raise ServeError(
                "int8 KV pools are not ported to PyTorch yet; use a float "
                "dtype")
        try:
            self.torch_dtype = torch_dtype(self.dtype)
        except MXNetError as e:
            raise ServeError(str(e)) from None
        self.device = resolve_device(device)
        # LIFO free list: a just-freed slot is re-claimed first, which is
        # exactly what the poison-fill reuse test needs to exercise
        self._free = list(range(self.max_slots - 1, -1, -1))
        self._claimed = set()
        self._lock = threading.Lock()
        self.k = self.v = None
        if allocate:
            self._allocate()

    # -- buffers -----------------------------------------------------------
    @property
    def shape(self):
        """Slab shape incl. the garbage row."""
        return (self.max_slots + 1, self.layers, self.max_len,
                self.heads, self.head_dim)

    @property
    def garbage_row(self):
        """Scatter target for a fixed-shape step's inactive lanes."""
        return self.max_slots

    def _allocate(self):
        self.k = torch.zeros(self.shape, dtype=self.torch_dtype,
                             device=self.device)
        self.v = torch.zeros(self.shape, dtype=self.torch_dtype,
                             device=self.device)

    def buffers(self):
        """The (k, v) slabs the step programs read and write in place."""
        return self.k, self.v

    def _itemsize(self):
        return torch.empty((), dtype=self.torch_dtype).element_size()

    def nbytes(self):
        """Size of the slab pair incl. the garbage row."""
        n = 1
        for d in self.shape:
            n *= d
        return 2 * n * self._itemsize()

    def bytes_per_slot(self):
        """Marginal device bytes one slot row costs (k + v pages)."""
        return (2 * self.layers * self.max_len * self.heads * self.head_dim
                * self._itemsize())

    def poison(self, value=1e9):
        """Overwrite the WHOLE slab with a sentinel. Test hook for the
        slot-reuse isolation contract: after poisoning, any read that
        escapes the `[0, cur_len]` mask shows up as the sentinel in the
        output. Never called on the serving path."""
        self.k.fill_(value)
        self.v.fill_(value)

    def poison_slot(self, slot, value=1e9):
        """`poison()` at slot granularity: overwrite ONE row of both slabs
        with the sentinel, leaving every other slot's live KV intact.
        Never called on the serving path."""
        slot = int(slot)
        if not 0 <= slot <= self.max_slots:
            raise ServeError(
                f"slot {slot} outside [0, {self.max_slots}]")
        self.k[slot].fill_(value)
        self.v[slot].fill_(value)

    # -- slot bookkeeping --------------------------------------------------
    def claim(self):
        """Take a free slot (int in [0, max_slots)); raises SlotsFullError
        when the pool is exhausted."""
        with self._lock:
            if not self._free:
                raise SlotsFullError(
                    f"all {self.max_slots} KV slots are claimed")
            slot = self._free.pop()
            self._claimed.add(slot)
            return slot

    def free(self, slot):
        """Return a slot. Double-free (or freeing an unclaimed slot) raises
        ServeError rather than silently handing one slot to two
        requests."""
        slot = int(slot)
        with self._lock:
            if slot not in self._claimed:
                raise ServeError(
                    f"KV slot {slot} is not claimed (double free?)")
            self._claimed.remove(slot)
            self._free.append(slot)

    def free_count(self):
        with self._lock:
            return len(self._free)

    def in_use(self):
        with self._lock:
            return sorted(self._claimed)

    def stats(self):
        """Plain-data snapshot of this pool's occupancy."""
        with self._lock:
            used = len(self._claimed)
        return {"max_slots": self.max_slots, "in_use": used,
                "free": self.max_slots - used,
                "dtype": self.dtype,
                "slab_bytes": self.nbytes() if self.k is not None else 0}
