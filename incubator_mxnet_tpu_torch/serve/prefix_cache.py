"""Ref-counted shared-prefix KV cache for the continuous-batching engine.

Counterpart of `incubator_mxnet_tpu/serve/prefix_cache.py`, pure host
bookkeeping, the same rules:

  * Block quantization. Prefixes are cached at `prefix_block`-token
    granularity: an entry always holds `n_blocks * block` tokens, and a
    lookup can only hit on whole blocks (and only at an entry's own
    length).
  * Rolling hash + MANDATORY verify. The index key is a polynomial
    rolling hash of the block-quantized token prefix. A hash hit is
    NEVER trusted: the candidate entry's stored tokens are compared
    against the actual prompt block before any KV is reused. A mismatch
    is a collision — counted in `PREFIX_STATS["collisions"]` — and the
    lookup falls through to shorter prefixes / recompute.
  * Ref-counted pinning. `match(acquire=True)` increments the winning
    entry's refcount; the engine holds that ref for the lifetime of the
    request reading the entry's pool row and `release()`s it at retire.
    LRU eviction never reclaims an entry whose refcount > 0. Releasing an
    unheld entry is a typed `PrefixCacheError`.
  * Dedicated slots. The cache owns pool rows claimed once at engine
    startup, so admission capacity (`max_slots`) and cache capacity
    (`prefix_cache_slots`) are separate knobs.

Device KV movement is the engine's job (`CachedDecoder.copy_program()`,
whole-row copies in place); this module only keeps the index, under one
lock. Counters: `serve.metrics.PREFIX_STATS` (`prefix_stats()`).

Test hook: assigning `cache._hash_override = fn` replaces the rolling
hash with `fn(tokens) -> int` for BOTH insert and lookup, so a test can
force two distinct token blocks onto one hash value.
"""
from __future__ import annotations

import threading

import numpy as np

from .batcher import ServeError
from .metrics import PREFIX_STATS, _PREFIX_LOCK as _STATS_LOCK, prefix_stats

__all__ = ["PrefixCacheError", "PrefixCache", "PREFIX_STATS",
           "prefix_stats", "rolling_hash"]


class PrefixCacheError(ServeError):
    """Prefix-cache lifecycle misuse: releasing an entry that holds no
    reference (double release), or clearing a cache with live refs."""


# Polynomial rolling hash over token ids. The modulus is the Mersenne
# prime 2^61-1 (cheap host arithmetic, negligible accidental-collision
# rate); `+ 1` keeps leading token id 0 from hashing like an empty block.
_HASH_MOD = (1 << 61) - 1
_HASH_BASE = 1_000_003


def rolling_hash(tokens):
    """Hash of a full token sequence — the key `PrefixCache` indexes by."""
    h = 0
    for t in np.asarray(tokens).reshape(-1):
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


class _PrefixEntry:
    """One cached prefix: its verified tokens, the pool row holding its
    KV, and the pin/LRU bookkeeping. Host-only."""

    __slots__ = ("tokens", "row", "refs", "tick", "hash")

    def __init__(self, tokens, row, hash_):
        self.tokens = tokens      # np.int32 (n_blocks * block,) — verify set
        self.row = int(row)       # dedicated pool row holding the KV
        self.refs = 0             # in-flight requests reading `row`
        self.tick = 0             # LRU clock (monotonic touch counter)
        self.hash = hash_

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_PrefixEntry(len={self.tokens.size}, row={self.row}, "
                f"refs={self.refs})")


class PrefixCache:
    """Host-side index over dedicated KV-pool rows holding shared-prefix
    KV. All methods are thread-safe; the lock is a leaf (nothing under it
    calls out), so callers may hold engine locks around these calls."""

    def __init__(self, block, rows):
        block = int(block)
        if block < 1:
            raise ServeError(f"prefix_block must be >= 1, got {block}")
        self.block = block
        self._rows_free = [int(r) for r in rows]
        self.capacity = len(self._rows_free)
        self._lock = threading.Lock()
        self._by_hash = {}        # hash -> [_PrefixEntry] (collision chain)
        self._tick = 0
        self._hash_override = None  # test hook: fn(tokens) -> int

    # -- hashing ---------------------------------------------------------
    def _hash(self, tokens):
        fn = self._hash_override
        return fn(tokens) if fn is not None else rolling_hash(tokens)

    def _prefix_hashes(self, prompt, nblocks):
        """Hashes of `prompt[:i*block]` for i in 1..nblocks. Rolling: one
        pass over the prompt, not O(len²) — unless the test hook replaced
        the hash, in which case each prefix is hashed independently."""
        if self._hash_override is not None:
            return [self._hash_override(prompt[:i * self.block])
                    for i in range(1, nblocks + 1)]
        out = []
        h = 0
        for i in range(nblocks):
            for t in prompt[i * self.block:(i + 1) * self.block]:
                h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
            out.append(h)
        return out

    # -- lookup ----------------------------------------------------------
    def match(self, prompt, acquire=True):
        """Longest verified cached prefix of `prompt`.

        Returns `(entry, matched_len)` — `(None, 0)` on miss. The match is
        capped at `len(prompt) - 1` tokens: at least one suffix token must
        remain to prefill, because the first output token's logits come
        from processing the final prompt position. With `acquire=True`
        (the engine's admission path) a hit pins the entry (refcount+1;
        pair with `release()`) and the hit/miss/cached_tokens counters
        move; `acquire=False` is a free peek used for budget costing."""
        prompt = np.asarray(prompt).reshape(-1)
        nmax = (int(prompt.size) - 1) // self.block
        with self._lock:
            if nmax >= 1 and self._by_hash:
                hashes = self._prefix_hashes(prompt, nmax)
                for i in range(nmax, 0, -1):
                    chain = self._by_hash.get(hashes[i - 1])
                    if not chain:
                        continue
                    n = i * self.block
                    for entry in chain:
                        if entry.tokens.size != n:
                            continue
                        if not np.array_equal(entry.tokens, prompt[:n]):
                            # hash collision: NEVER reuse unverified KV
                            with _STATS_LOCK:
                                PREFIX_STATS["collisions"] += 1
                            continue
                        if acquire:
                            entry.refs += 1
                            self._tick += 1
                            entry.tick = self._tick
                            with _STATS_LOCK:
                                PREFIX_STATS["hits"] += 1
                                PREFIX_STATS["cached_tokens"] += n
                        return entry, n
            if acquire:
                with _STATS_LOCK:
                    PREFIX_STATS["misses"] += 1
            return None, 0

    # -- pinning ---------------------------------------------------------
    def release(self, entry):
        """Drop one reference acquired by `match(acquire=True)`. Releasing
        an unheld entry raises `PrefixCacheError` — a refcount that went
        negative would let eviction reclaim a row a request still reads."""
        with self._lock:
            if entry.refs <= 0:
                raise PrefixCacheError(
                    f"prefix entry (len={entry.tokens.size}, "
                    f"row={entry.row}) released with no live reference "
                    "(double release?)")
            entry.refs -= 1

    # -- publish ---------------------------------------------------------
    def insert(self, prompt):
        """Publish `prompt`'s block-quantized prefix.

        Returns the pool ROW the caller must copy the prefix KV into, or
        `None` when nothing was published (prefix shorter than one block,
        already cached — which refreshes its LRU tick — or no free row
        and every resident entry is pinned: eviction REFUSES refcount>0
        entries rather than reclaiming a row in use).

        The entry is indexed immediately; the engine's single scheduler
        thread dispatches the KV copy before any later wave can hit the
        entry, and device-stream ordering makes the copy land first."""
        prompt = np.asarray(prompt).reshape(-1)
        nblocks = int(prompt.size) // self.block
        if nblocks < 1:
            return None
        n = nblocks * self.block
        tokens = np.array(prompt[:n], copy=True)
        h = self._hash(tokens)
        with self._lock:
            for entry in self._by_hash.get(h, ()):
                if (entry.tokens.size == n
                        and np.array_equal(entry.tokens, tokens)):
                    self._tick += 1
                    entry.tick = self._tick
                    return None          # already cached: just touch LRU
            row = self._claim_row_locked()
            if row is None:
                return None
            entry = _PrefixEntry(tokens, row, h)
            self._tick += 1
            entry.tick = self._tick
            self._by_hash.setdefault(h, []).append(entry)
            return row

    def _claim_row_locked(self):
        if self._rows_free:
            return self._rows_free.pop()
        victim = None
        for chain in self._by_hash.values():
            for entry in chain:
                if entry.refs == 0 and (victim is None
                                        or entry.tick < victim.tick):
                    victim = entry
        if victim is None:
            return None                  # every entry pinned: refuse
        self._drop_entry_locked(victim)
        with _STATS_LOCK:
            PREFIX_STATS["evictions"] += 1
        return victim.row

    def _drop_entry_locked(self, entry):
        chain = self._by_hash.get(entry.hash, [])
        if entry in chain:
            chain.remove(entry)
        if not chain:
            self._by_hash.pop(entry.hash, None)

    # -- lifecycle -------------------------------------------------------
    def clear(self):
        """Drop every entry and reclaim its row (used after the engine's
        failure path reallocates the pool slab — the cached KV bytes are
        gone, so the index must go too). Refuses while any entry is
        pinned: the caller must release in-flight refs first."""
        with self._lock:
            held = sum(e.refs for c in self._by_hash.values() for e in c)
            if held:
                raise PrefixCacheError(
                    f"clear() with {held} live reference(s); release "
                    "in-flight requests first")
            for chain in self._by_hash.values():
                for entry in chain:
                    self._rows_free.append(entry.row)
            self._by_hash.clear()

    # -- introspection ---------------------------------------------------
    def entries(self):
        """Snapshot of resident entries for tests/diagnostics:
        `(prefix_len, row, refs)` tuples, LRU-oldest first."""
        with self._lock:
            flat = [e for c in self._by_hash.values() for e in c]
            flat.sort(key=lambda e: e.tick)
            return [(e.tokens.size, e.row, e.refs) for e in flat]

    def stats(self):
        with self._lock:
            flat = [e for c in self._by_hash.values() for e in c]
            return {
                "block": self.block,
                "capacity": self.capacity,
                "entries": len(flat),
                "resident_tokens": int(sum(e.tokens.size for e in flat)),
                "live_refs": int(sum(e.refs for e in flat)),
            }
