"""PyTorch port: the KV slot pool (`serve.kv_pool.KVCachePool`).

Counterparts of the KV-slot lifecycle tests of tests/test_continuous.py
and the int8-pool tests of tests/test_decode.py: claim/free with typed
exhaustion and double-free, concurrent claim/free, the int8 pool's
buffers and sizes against the JAX package's pool, and the poison-fill
isolation contract (a reused slot cannot read a prior tenant's KV, codes
or scales), here through the port's engine on the CPU.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import MXNetError, resolve_device, serve

torch.set_num_threads(1)

CFG = dict(vocab=64, embed=32, layers=2, heads=4, head_dim=8, max_len=48)


def _pool(**kw):
    args = dict(max_slots=3, layers=1, max_len=8, heads=2, head_dim=4,
                device="cpu")
    args.update(kw)
    return serve.KVCachePool(**args)


def test_claim_free_and_typed_exhaustion():
    pool = _pool(allocate=False)
    slots = [pool.claim() for _ in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert pool.free_count() == 0
    with pytest.raises(serve.SlotsFullError):
        pool.claim()
    assert issubclass(serve.SlotsFullError, serve.ServeError)
    pool.free(slots[0])
    assert pool.free_count() == 1
    with pytest.raises(serve.ServeError, match="double free"):
        pool.free(slots[0])
    st = pool.stats()
    assert st["in_use"] == 2 and st["free"] == 1 and st["max_slots"] == 3


def test_concurrent_claim_free_hammer():
    """Threads churn claim/free under a short switch interval; no slot is
    ever handed to two holders and the counts balance."""
    pool = _pool(max_slots=4, allocate=False)
    errs, held_twice = [], []
    lock = threading.Lock()
    held = set()

    def hammer(tid):
        rng = np.random.RandomState(tid)
        try:
            for _ in range(300):
                try:
                    s = pool.claim()
                except serve.SlotsFullError:
                    continue
                with lock:
                    if s in held:
                        held_twice.append(s)
                    held.add(s)
                if rng.rand() < 0.5:
                    time.sleep(0)
                with lock:
                    held.discard(s)
                pool.free(s)
        except BaseException as e:   # pragma: no cover - diagnostics
            errs.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert not held_twice, f"slots double-claimed: {held_twice}"
    assert pool.free_count() == 4 and pool.in_use() == []


def test_slab_shape_bytes_and_garbage_row():
    pool = _pool(dtype="bfloat16")
    assert pool.k.shape == pool.v.shape == (4, 1, 8, 2, 4) == pool.shape
    assert pool.k.dtype == torch.bfloat16 and pool.k.device.type == "cpu"
    assert pool.garbage_row == 3
    assert pool.bytes_per_slot() == 2 * 1 * 8 * 2 * 4 * 2
    assert pool.nbytes() == 4 * pool.bytes_per_slot()
    assert pool.stats()["slab_bytes"] == pool.nbytes()
    k, v = pool.buffers()
    assert k is pool.k and v is pool.v


def test_poison_and_poison_slot():
    pool = _pool()
    pool.poison(7.0)
    assert torch.all(pool.k == 7.0) and torch.all(pool.v == 7.0)
    pool.poison(0.0)
    pool.poison_slot(1, 5.0)
    assert torch.all(pool.k[1] == 5.0) and torch.all(pool.v[1] == 5.0)
    assert torch.all(pool.k[[0, 2, 3]] == 0.0)
    with pytest.raises(serve.ServeError, match="outside"):
        pool.poison_slot(4)


def test_int8_and_unknown_dtypes_raise_typed():
    """int8 is a storage dtype now (codes + scales); a dtype that is
    neither a float the port stores nor int8 still raises typed."""
    pool = _pool(dtype="int8")
    (k, ks), (v, vs) = pool.buffers()
    assert k.dtype == v.dtype == torch.int8 and pool.quantized
    assert ks.dtype == vs.dtype == torch.float32
    with pytest.raises(serve.ServeError, match="dtype"):
        _pool(dtype="float64")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_pool_shapes_and_sizes_match_jax_pool(dtype):
    from incubator_mxnet_tpu import serve as jserve
    kw = dict(layers=3, max_len=40, heads=4, head_dim=8)
    jp = jserve.KVCachePool(5, dtype=dtype, **kw)
    tp = serve.KVCachePool(5, dtype=dtype, device="cpu", **kw)
    assert tp.shape == jp.shape and tp.quantized == jp.quantized
    assert tuple(tp.k.shape) == tuple(jp.k.shape)
    if dtype == "int8":
        assert tp.scale_shape == jp.scale_shape
        assert tuple(tp.k_scale.shape) == tuple(jp.k_scale.shape)
    assert tp.nbytes() == jp.nbytes()
    assert tp.bytes_per_slot() == jp.bytes_per_slot()
    assert tp.slots_per_gb() == jp.slots_per_gb()
    st = tp.stats()
    assert st["slots_per_gb"] == jp.stats()["slots_per_gb"]
    assert st["slab_bytes"] == jp.stats()["slab_bytes"]


def test_int8_poison_writes_codes_and_scales_per_slot():
    pool = _pool(dtype="int8")
    pool.poison(7.0)
    assert torch.all(pool.k == 1) and torch.all(pool.v == 1)
    assert torch.all(pool.k_scale == 7.0) and torch.all(pool.v_scale == 7.0)
    pool.poison(0.0)
    pool.poison_slot(1, 5.0)
    assert torch.all(pool.k_scale[1] == 5.0) and torch.all(pool.v[1] == 1)
    assert torch.all(pool.k_scale[[0, 2, 3]] == 0.0)
    assert torch.all(pool.v_scale[[0, 2, 3]] == 0.0)


def test_cuda_pool_without_card_raises():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(MXNetError, match="cuda"):
        serve.KVCachePool(max_slots=1, layers=1, max_len=8, heads=2,
                          head_dim=4)


def test_slot_reuse_cannot_read_prior_request_cache():
    """Poison-fill + value check: fill the WHOLE slab with a sentinel,
    then run a request through a reused slot; the output must equal the
    fresh-pool reference. prefill_window < max_len, so the page is not
    fully rewritten at admission: only the mask protects its tail."""
    cfg = serve.DecoderConfig(**CFG)
    model = serve.CachedDecoder(cfg, seed=3, device="cpu")
    expect = model.reference_generate([1, 2, 3], 8, window=16)
    eng = serve.ContinuousEngine(model, max_slots=1, prefill_window=16,
                                 decode_steps=2).start()
    try:
        eng.generate([9, 8, 7, 6], 10, timeout=60)   # tenant 1 dirties slot 0
        assert eng.pool.in_use() == []
        eng.pool.poison(1e9)
        out = eng.generate([1, 2, 3], 8, timeout=60)
        long_out = eng.generate(list(range(1, 40)), 5, timeout=60)
    finally:
        eng.close()
    np.testing.assert_array_equal(
        out, expect, err_msg="reused slot leaked a prior tenant's cache")
    np.testing.assert_array_equal(
        long_out, model.reference_generate(list(range(1, 40)), 5, window=16),
        err_msg="a poisoned slab leaked into a chunked prefill")


def test_int8_slot_reuse_cannot_read_prior_codes_or_scales():
    """A whole int8 pool poisoned (codes 1, scales 1e9) after a tenant
    dirtied it: later requests through the speculative verify path, one
    of them chunked, read only what they wrote. Their tokens equal the
    JAX package's int8 reference."""
    from torch_port_utils import decoders
    jm, tm = decoders()
    work = [([1, 2, 3], 8), (list(range(1, 40)), 6), ([5, 9, 5, 9, 5], 10)]
    eng = serve.ContinuousEngine(tm, max_slots=2, prefill_window=16,
                                 decode_steps=2, draft_tokens=2,
                                 kv_dtype="int8").start()
    try:
        eng.generate([9, 8, 7, 6], 10, timeout=60)
        eng.pool.poison(1e9)
        outs = [eng.generate(p, m, timeout=60) for p, m in work]
    finally:
        eng.close()
    for (p, m), o in zip(work, outs):
        np.testing.assert_array_equal(
            o, jm.reference_generate(p, m, window=16, kv_dtype="int8"),
            err_msg=f"int8 poison leaked for a prompt of {len(p)} tokens")
