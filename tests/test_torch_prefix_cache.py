"""PyTorch port: the shared-prefix KV cache's bookkeeping
(`serve.prefix_cache.PrefixCache`) against the JAX package's.

Each scenario of tests/test_prefix_cache.py runs the same operation
sequence through both modules: every assertion of the JAX test holds for
each, and the two logs of what the operations returned (entry lengths,
rows, refcounts, counter deltas, typed errors) are equal. Host
bookkeeping only; the engine-level hits are in tests/test_torch_engine.py.
"""
import types

import numpy as np
import pytest

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.serve import prefix_cache as jpc
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.serve import prefix_cache as tpc

MODULES = {
    "jax": types.SimpleNamespace(
        PrefixCache=jpc.PrefixCache, PrefixCacheError=jpc.PrefixCacheError,
        prefix_stats=jpc.prefix_stats, rolling_hash=jpc.rolling_hash,
        ServeError=jserve.ServeError),
    "torch": types.SimpleNamespace(
        PrefixCache=tpc.PrefixCache, PrefixCacheError=tpc.PrefixCacheError,
        prefix_stats=tpc.prefix_stats, rolling_hash=tpc.rolling_hash,
        ServeError=tserve.ServeError),
}


def _prompt(*tokens):
    return np.asarray(tokens, dtype=np.int32)


def _delta(m, before):
    now = m.prefix_stats()
    return {k: now[k] - before[k] for k in now}


def scenario_rolling_hash(m, log):
    toks = [5, 9, 1, 7]
    assert m.rolling_hash(toks) == m.rolling_hash(np.asarray(toks))
    assert m.rolling_hash(toks) != m.rolling_hash([9, 5, 1, 7])
    assert m.rolling_hash([0]) != m.rolling_hash([])
    log += [m.rolling_hash(toks), m.rolling_hash(list(range(100)))]


def scenario_longest_verified_block_prefix(m, log):
    cache = m.PrefixCache(block=4, rows=[10, 11])
    p = _prompt(*range(1, 11))
    short_row = cache.insert(p[:4])
    row = cache.insert(p)
    assert {short_row, row} == {10, 11}
    assert [e[0] for e in cache.entries()] == [4, 8]
    before = m.prefix_stats()
    entry, n = cache.match(p)
    assert entry is not None and n == 8 and entry.refs == 1
    e2, n2 = cache.match(p[:8])
    assert n2 == 4 and e2.row == short_row
    d = _delta(m, before)
    assert d["hits"] == 2 and d["cached_tokens"] == 12
    cache.release(entry)
    cache.release(e2)
    before = m.prefix_stats()
    assert cache.match(_prompt(1, 2, 3)) == (None, 0)
    assert _delta(m, before)["misses"] == 1
    log += [short_row, row, cache.entries(), d]


def scenario_free_peek(m, log):
    cache = m.PrefixCache(block=2, rows=[0])
    cache.insert(_prompt(1, 2, 3, 4))
    before = m.prefix_stats()
    entry, n = cache.match(_prompt(1, 2, 3, 4, 5), acquire=False)
    assert n == 4 and entry.refs == 0
    assert _delta(m, before) == dict.fromkeys(before, 0)
    log += [n, entry.row]


def scenario_hash_collision_verified(m, log):
    cache = m.PrefixCache(block=4, rows=[7])
    cache._hash_override = lambda tokens: 42
    assert cache.insert(_prompt(1, 2, 3, 4)) == 7
    before = m.prefix_stats()
    assert cache.match(_prompt(9, 9, 9, 9, 5)) == (None, 0)
    d = _delta(m, before)
    assert d["collisions"] == 1 and d["misses"] == 1
    entry, n = cache.match(_prompt(1, 2, 3, 4, 5))
    assert n == 4 and entry.row == 7
    cache.release(entry)
    log += [d, n]


def scenario_collision_chain(m, log):
    cache = m.PrefixCache(block=2, rows=[0, 1])
    cache._hash_override = lambda tokens: 13
    ra = cache.insert(_prompt(1, 2))
    rb = cache.insert(_prompt(3, 4))
    assert ra is not None and rb is not None
    ea, na = cache.match(_prompt(1, 2, 9))
    eb, nb = cache.match(_prompt(3, 4, 9))
    assert na == nb == 2 and ea.row != eb.row
    cache.release(ea)
    cache.release(eb)
    log += [ra, rb, ea.row, eb.row]


def scenario_lru_evicts_only_unpinned(m, log):
    cache = m.PrefixCache(block=2, rows=[0, 1])
    assert cache.insert(_prompt(1, 2)) is not None
    assert cache.insert(_prompt(3, 4)) is not None
    ea, _ = cache.match(_prompt(1, 2, 9))
    before = m.prefix_stats()
    rc = cache.insert(_prompt(5, 6))
    assert rc is not None and _delta(m, before)["evictions"] == 1
    assert (2, ea.row, 1) in cache.entries()
    assert cache.match(_prompt(3, 4, 9)) == (None, 0)
    ec, _ = cache.match(_prompt(5, 6, 9))
    before = m.prefix_stats()
    assert cache.insert(_prompt(7, 8)) is None
    assert _delta(m, before)["evictions"] == 0
    log += [rc, cache.entries()]
    cache.release(ea)
    cache.release(ec)


def scenario_reinsert_touches_lru(m, log):
    cache = m.PrefixCache(block=2, rows=[0, 1])
    assert cache.insert(_prompt(1, 2)) is not None
    assert cache.insert(_prompt(3, 4)) is not None
    assert cache.insert(_prompt(1, 2)) is None
    assert cache.insert(_prompt(5, 6)) is not None
    assert cache.match(_prompt(1, 2, 9), acquire=False)[1] == 2
    assert cache.match(_prompt(3, 4, 9), acquire=False) == (None, 0)
    log += [cache.entries()]


def scenario_double_release_typed(m, log):
    cache = m.PrefixCache(block=2, rows=[0])
    cache.insert(_prompt(1, 2))
    entry, _ = cache.match(_prompt(1, 2, 3))
    cache.release(entry)
    with pytest.raises(m.PrefixCacheError, match="double release"):
        cache.release(entry)
    assert issubclass(m.PrefixCacheError, m.ServeError)
    log += [entry.refs]


def scenario_clear_refuses_with_live_refs(m, log):
    cache = m.PrefixCache(block=2, rows=[4, 5])
    cache.insert(_prompt(1, 2))
    entry, _ = cache.match(_prompt(1, 2, 3))
    with pytest.raises(m.PrefixCacheError, match="live reference"):
        cache.clear()
    cache.release(entry)
    cache.clear()
    assert cache.entries() == []
    log += [cache.insert(_prompt(1, 2)), cache.insert(_prompt(3, 4))]
    assert None not in log[-2:]


def scenario_stats_keys_and_reset(m, log):
    snap = m.prefix_stats()
    assert set(snap) == {"hits", "misses", "cached_tokens", "evictions",
                         "collisions"}
    m.prefix_stats(reset=True)
    assert all(v == 0 for v in m.prefix_stats().values())
    log += [sorted(snap)]


def scenario_cache_stats_snapshot(m, log):
    cache = m.PrefixCache(block=4, rows=[0, 1, 2])
    cache.insert(_prompt(*range(1, 9)))
    entry, _ = cache.match(_prompt(*range(1, 10)))
    st = cache.stats()
    assert st == {"block": 4, "capacity": 3, "entries": 1,
                  "resident_tokens": 8, "live_refs": 1}
    cache.release(entry)
    assert cache.stats()["live_refs"] == 0
    log += [st]


def scenario_block_validation(m, log):
    with pytest.raises(m.ServeError, match="prefix_block"):
        m.PrefixCache(block=0, rows=[0])
    cache = m.PrefixCache(block=3, rows=[0])
    log += [cache.insert(_prompt(1, 2)), cache.capacity, cache.block]


SCENARIOS = {n[len("scenario_"):]: f for n, f in sorted(globals().items())
             if n.startswith("scenario_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_operations_same_results_as_jax(name):
    logs = {}
    for mod_name, m in MODULES.items():
        logs[mod_name] = []
        SCENARIOS[name](m, logs[mod_name])
    assert logs["torch"] == logs["jax"]


def test_port_imports_its_own_copy():
    assert tpc.PrefixCache is not jpc.PrefixCache
    assert tserve.PrefixCache is tpc.PrefixCache
    assert tserve.prefix_stats is tpc.prefix_stats
    assert tpc.PREFIX_STATS is not jpc.PREFIX_STATS
