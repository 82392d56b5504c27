"""PyTorch port: the continuous-batching engine (`serve.ContinuousEngine`)
on the CPU.

Counterparts of tests/test_continuous.py's engine tests: mixed ragged
traffic token-exact against the JAX package's scheduling-free
`reference_generate` over the same weights, `decode_steps` as pure
amortisation, eos and page-full accounting, queueing, deadline-aware
admission, typed rejection, drain and close, plus the typed refusal of
what this slice does not serve.
"""
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import serve
from torch_port_utils import CFG, decoders

torch.set_num_threads(1)

W = 16


@pytest.fixture(scope="module")
def pair():
    return decoders()


def _workload(n, seed=0, max_len=40, max_new_hi=20):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, CFG["vocab"],
                         size=rng.randint(2, max_len)).tolist(),
             int(rng.randint(1, max_new_hi))) for _ in range(n)]


def test_mixed_traffic_token_exact_vs_jax_reference(pair):
    """Ragged prompts (some longer than the window, so they stream in
    chunks) through 4 slots; every reply equals the JAX reference."""
    jm, tm = pair
    work = _workload(12, seed=0)
    before = serve.serve_stats()
    with serve.ContinuousEngine(tm, max_slots=4, decode_steps=3,
                                prefill_window=W) as eng:
        futs = [eng.submit(p, m) for p, m in work]
        outs = [f.result(timeout=120) for f in futs]
        st = eng.stats()
    for (p, m), o in zip(work, outs):
        np.testing.assert_array_equal(
            o, jm.reference_generate(p, m, window=W),
            err_msg=f"engine diverged for prompt of {len(p)} tokens")
        assert len(o) == min(m, CFG["max_len"] - len(p))   # or page-full
    after = serve.serve_stats()
    assert after["decode_retired"] - before["decode_retired"] == 12
    assert after["decode_tokens"] - before["decode_tokens"] \
        == sum(len(o) for o in outs) - 12    # first tokens come from prefill
    assert after["decode_prefill_tokens"] - before["decode_prefill_tokens"] \
        == sum(len(p) for p, _ in work)
    assert st["chunk_batches"] > 0 and st["decode_iterations"] > 0
    assert st["replies"] == 12 and st["pool"]["in_use"] == 0
    assert st["ttft_p50_ms"] is not None and st["tpot_p99_ms"] is not None
    assert st["device"] == "cpu"


def test_multi_step_decode_equals_single_step(pair):
    _, tm = pair
    work = _workload(6, seed=5)
    outs = {}
    for steps in (1, 4):
        with serve.ContinuousEngine(tm, max_slots=2, decode_steps=steps,
                                    prefill_window=W) as eng:
            outs[steps] = [eng.generate(p, m, timeout=120) for p, m in work]
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


def test_eos_mid_wave_keeps_exact_token_accounting(pair):
    jm, tm = pair
    prompt, max_new = [7, 3, 19], 16
    base = jm.reference_generate(prompt, max_new, window=W)
    eos = int(base[len(base) // 2])
    expect = jm.reference_generate(prompt, max_new, window=W, eos_id=eos)
    assert len(expect) < len(base)
    eng = serve.ContinuousEngine(tm, max_slots=2, decode_steps=8,
                                 prefill_window=W, eos_id=eos).start()
    try:
        out = eng.generate(prompt, max_new, timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    np.testing.assert_array_equal(out, expect)
    assert out[-1] == eos
    assert st["decode_tokens"] == len(out) - 1
    assert st["replies"] == 1 and st["pool"]["in_use"] == 0


def test_page_full_token_count_is_decode_steps_invariant():
    cfg = dict(CFG, max_len=12)
    jm, tm = decoders(cfg)
    prompt, max_new = [7, 3, 19], 30
    expect = jm.reference_generate(prompt, max_new)
    assert len(expect) == 12 - len(prompt)
    for steps in (1, 7):
        with serve.ContinuousEngine(tm, max_slots=2,
                                    decode_steps=steps) as eng:
            out = eng.generate(prompt, max_new, timeout=120)
        np.testing.assert_array_equal(
            out, expect, err_msg=f"decode_steps={steps} diverged at page-full")


def test_requests_queue_when_slots_full_then_complete(pair):
    _, tm = pair
    work = _workload(10, seed=9, max_len=12)
    with serve.ContinuousEngine(tm, max_slots=2, decode_steps=2,
                                prefill_window=W) as eng:
        futs = [eng.submit(p, m) for p, m in work]
        outs = [f.result(timeout=120) for f in futs]
        st = eng.stats()
    assert st["pool"]["in_use"] == 0 and st["replies"] == 10
    for (p, m), o in zip(work, outs):
        np.testing.assert_array_equal(o, tm.reference_generate(p, m,
                                                               window=W))


def test_deadline_aware_slot_grant_beats_fifo(pair):
    """With the pool held by a direct claim, a later request holding a
    deadline is granted the freed slot before an earlier deadline-less
    one."""
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=1, prefill_lanes=1,
                                 decode_steps=1).start()
    order = []
    lock = threading.Lock()
    try:
        held = eng.pool.claim()
        fifo = eng.submit([1, 2], 4)
        slo = eng.submit([3, 4], 4, deadline_ms=30000)

        def watch(name, fut):
            fut.result(timeout=120)
            with lock:
                order.append(name)

        ts = [threading.Thread(target=watch, args=(n, f))
              for n, f in (("fifo", fifo), ("slo", slo))]
        for t in ts:
            t.start()
        time.sleep(0.05)
        eng.pool.free(held)
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        eng.close()
    assert order and order[0] == "slo", order


def test_deadline_expires_while_waiting_for_slot(pair):
    _, tm = pair
    before = serve.serve_stats()["timeouts"]
    eng = serve.ContinuousEngine(tm, max_slots=1, prefill_lanes=1,
                                 decode_steps=1).start()
    try:
        held = eng.pool.claim()
        doomed = eng.submit([1, 2], 4, deadline_ms=15)
        with pytest.raises(serve.RequestTimeout, match="KV slot"):
            doomed.result(timeout=60)
        eng.pool.free(held)
        assert eng.generate([3, 3], 3, timeout=60).size == 3
    finally:
        eng.close()
    assert serve.serve_stats()["timeouts"] == before + 1


def test_queue_full_rejects_typed(pair):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=1, prefill_lanes=1,
                                 max_queue=2, decode_steps=1).start()
    try:
        futs = [eng.submit([5, 5], 30)]
        rejected = 0
        for _ in range(12):
            try:
                futs.append(eng.submit([1, 2], 2))
            except serve.QueueFullError as e:
                assert e.policy == "reject"
                rejected += 1
        assert rejected > 0
        for f in futs:
            f.result(timeout=120)
    finally:
        eng.close()
    assert eng.stats()["rejected"] == rejected


def test_close_drains_and_then_rejects(pair):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=2, prefill_window=W).start()
    futs = [eng.submit(p, m) for p, m in _workload(6, seed=2)]
    eng.close(drain=True)
    assert all(f.exception() is None for f in futs)
    with pytest.raises(serve.ServerClosed):
        eng.submit([1, 2], 4)


def test_submit_during_drain_raises_typed_replica_draining(pair):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=2, decode_steps=2).start()
    resident = eng.submit([1, 2, 3], 10)
    eng.begin_drain()
    assert eng.draining
    with pytest.raises(serve.ReplicaDraining, match="draining"):
        eng.submit([4], 2)
    assert resident.result(timeout=120).size == 10
    eng.close()
    assert not eng.draining
    with pytest.raises(serve.ServerClosed) as ei:
        eng.submit([4], 2)
    assert not isinstance(ei.value, serve.ReplicaDraining)


def test_close_without_drain_fails_waiting_requests(pair):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=1, prefill_lanes=1,
                                 decode_steps=1).start()
    held = eng.pool.claim()                 # nothing can be admitted
    waiting = eng.submit([3], 4)
    eng.close(drain=False, timeout=30)
    with pytest.raises(serve.ServerClosed, match="before admission"):
        waiting.result(timeout=1)
    eng.pool.free(held)


def test_step_failure_fails_in_flight_and_engine_keeps_serving(pair):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=2, decode_steps=2,
                                 prefill_window=W).start()
    real = eng._decode_prog

    def boom(*args):
        raise RuntimeError("transient failure")

    try:
        eng._decode_prog = boom
        f = eng.submit([1, 2, 3], 6)
        with pytest.raises(serve.ServeError, match="engine step failed"):
            f.result(timeout=60)
        eng._decode_prog = real
        out = eng.generate([4, 5], 5, timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    np.testing.assert_array_equal(out, tm.reference_generate([4, 5], 5,
                                                             window=W))
    assert st["errors"] == 1 and st["replies"] == 1
    assert st["pool"]["in_use"] == 0


@pytest.mark.parametrize("kw", [
    dict(draft_tokens=2), dict(kv_dtype="int8"), dict(prefix_cache_slots=2),
    dict(kv_dtype="bfloat16")], ids=lambda kw: f"{next(iter(kw))}")
def test_engine_refuses_unported_knobs(pair, kw):
    _, tm = pair
    with pytest.raises(serve.ServeError):
        serve.ContinuousEngine(tm, max_slots=1, **kw)


@pytest.mark.parametrize("env", [
    ("MXNET_SERVE_DRAFT_TOKENS", "1"), ("MXNET_SERVE_KV_DTYPE", "int8"),
    ("MXNET_SERVE_PREFIX_CACHE_SLOTS", "1")], ids=lambda e: e[0])
def test_engine_refuses_unported_env(pair, env, monkeypatch):
    _, tm = pair
    monkeypatch.setenv(*env)
    with pytest.raises(serve.ServeError, match="not ported"):
        serve.ContinuousEngine(tm, max_slots=1)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.5), dict(top_k=3), dict(top_p=0.5)],
    ids=lambda kw: next(iter(kw)))
def test_submit_refuses_sampling(pair, kw):
    _, tm = pair
    with serve.ContinuousEngine(tm, max_slots=1) as eng:
        with pytest.raises(serve.ServeError, match="greedy"):
            eng.submit([1, 2], 2, **kw)
        assert eng.generate([1, 2], 2, seed=7, timeout=60).size == 2


def test_knobs_resolve_arg_over_env_over_default(pair, monkeypatch):
    _, tm = pair
    eng = serve.ContinuousEngine(tm)
    assert (eng.max_slots, eng.decode_steps, eng.prefill_budget,
            eng.prefill_lanes, eng.max_queue, eng.default_deadline_s) \
        == (8, 4, 256, 8, 256, None)
    for name, val in (("MAX_SLOTS", "3"), ("DECODE_STEPS", "2"),
                      ("PREFILL_BUDGET", "64"), ("PREFILL_LANES", "2"),
                      ("MAX_QUEUE", "5"), ("DEADLINE_MS", "250")):
        monkeypatch.setenv(f"MXNET_SERVE_{name}", val)
    eng = serve.ContinuousEngine(tm)
    assert (eng.max_slots, eng.decode_steps, eng.prefill_budget,
            eng.prefill_lanes, eng.max_queue, eng.default_deadline_s) \
        == (3, 2, 64, 2, 5, 0.25)
    assert eng.pool.max_slots == 3
    eng = serve.ContinuousEngine(tm, max_slots=4, decode_steps=1,
                                 prefill_lanes=4, max_queue=9)
    assert (eng.max_slots, eng.decode_steps, eng.prefill_lanes,
            eng.max_queue) == (4, 1, 4, 9)
