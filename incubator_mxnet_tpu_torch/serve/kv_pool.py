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
  * The slab dtype is any float dtype (float32, bfloat16, float16),
    independent of the model's, or "int8": quantized storage, int8 codes
    plus one f32 dequant scale per written (row, layer, position) in
    `k_scale`/`v_scale` of `scale_shape`.
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
        # int8 = quantized storage: the slabs hold int8 codes, the paired
        # k_scale/v_scale buffers one f32 dequant factor per position
        self.quantized = self.dtype == "int8"
        if self.quantized:
            self.torch_dtype = torch.int8
        else:
            try:
                self.torch_dtype = torch_dtype(self.dtype)
            except MXNetError as e:
                raise ServeError(f"{e}, or 'int8'") from None
        self.device = resolve_device(device)
        # LIFO free list: a just-freed slot is re-claimed first, which is
        # exactly what the poison-fill reuse test needs to exercise
        self._free = list(range(self.max_slots - 1, -1, -1))
        self._claimed = set()
        self._lock = threading.Lock()
        self.k = self.v = None
        self.k_scale = self.v_scale = None
        if allocate:
            self._allocate()

    # -- buffers -----------------------------------------------------------
    @property
    def shape(self):
        """Slab shape incl. the garbage row."""
        return (self.max_slots + 1, self.layers, self.max_len,
                self.heads, self.head_dim)

    @property
    def scale_shape(self):
        """Per-position dequant-scale buffer shape (quantized pools)."""
        return (self.max_slots + 1, self.layers, self.max_len)

    @property
    def garbage_row(self):
        """Scatter target for a fixed-shape step's inactive lanes."""
        return self.max_slots

    def _allocate(self):
        self.k = torch.zeros(self.shape, dtype=self.torch_dtype,
                             device=self.device)
        self.v = torch.zeros(self.shape, dtype=self.torch_dtype,
                             device=self.device)
        if self.quantized:
            self.k_scale = torch.zeros(self.scale_shape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(self.scale_shape, dtype=torch.float32,
                                       device=self.device)

    def buffers(self):
        """The (k, v) arguments the step programs read and write in place:
        the slabs, or `(codes, scales)` pairs on a quantized pool."""
        if self.quantized:
            return (self.k, self.k_scale), (self.v, self.v_scale)
        return self.k, self.v

    def bytes_per_slot(self):
        """Marginal device bytes one slot row costs (k + v pages, plus
        their scale rows on a quantized pool)."""
        page = 2 * self.layers * self.max_len * self.heads * self.head_dim
        per = page * torch.empty((), dtype=self.torch_dtype).element_size()
        if self.quantized:
            per += 2 * self.layers * self.max_len * 4
        return per

    def nbytes(self):
        """Size of the slab pair (and scales) incl. the garbage row."""
        return (self.max_slots + 1) * self.bytes_per_slot()

    def slots_per_gb(self):
        """KV slots one GiB of device memory buys at this pool's shape."""
        return round((1 << 30) / self.bytes_per_slot(), 2)

    def poison(self, value=1e9):
        """Overwrite the WHOLE slab with a sentinel. Test hook for the
        slot-reuse isolation contract: after poisoning, any read that
        escapes the `[0, cur_len]` mask shows up as the sentinel in the
        output. On a quantized pool the codes are set to 1 and the SCALES
        to `value`, so a stale-scale read is as loud as a stale-code one.
        Never called on the serving path."""
        self._fill(slice(None), value)

    def poison_slot(self, slot, value=1e9):
        """`poison()` at slot granularity: overwrite ONE row of both slabs
        (and its scale rows on a quantized pool) with the sentinel, leaving
        every other slot's live KV intact. Never called on the serving
        path."""
        slot = int(slot)
        if not 0 <= slot <= self.max_slots:
            raise ServeError(
                f"slot {slot} outside [0, {self.max_slots}]")
        self._fill(slot, value)

    def _fill(self, rows, value):
        code = 1 if self.quantized else value
        self.k[rows] = code
        self.v[rows] = code
        if self.quantized:
            self.k_scale[rows] = value
            self.v_scale[rows] = value

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
                "slots_per_gb": self.slots_per_gb(),
                "slab_bytes": self.nbytes() if self.k is not None else 0}
