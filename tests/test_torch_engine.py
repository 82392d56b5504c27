"""PyTorch port: the continuous-batching engine (`serve.ContinuousEngine`)
on the CPU.

Counterparts of tests/test_continuous.py's and tests/test_decode.py's
engine tests: mixed ragged traffic token-exact against the JAX package's
scheduling-free `reference_generate` over the same weights, `decode_steps`
as pure amortisation, eos and page-full accounting, queueing,
deadline-aware admission, typed rejection, drain and close; and the full
decode engine — sampled lanes, int8 KV, speculative decode and the
shared-prefix cache, alone and together — token-exact against the port's
1-slot `reference_generate` with the same knobs, greedy lanes also against
the JAX package's, with poisoned pools showing that no stale KV, code or
scale is reachable.
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


SHARED = list(range(3, 19))             # one 16-token prefix block
KNOB_WORK = [(SHARED + [30, 31], 6), ([5, 6, 7], 5), (SHARED + [32], 7),
             (SHARED + list(range(40, 52)), 6)]


def _serves_like_jax(jm, eng):
    """Serve KNOB_WORK one request at a time and hold every reply against
    the JAX reference with the engine's KV dtype; on a prefix-cache engine
    the first request publishes SHARED and the later ones sharing it are
    hits (`cached_prefix_len=16`)."""
    outs = [eng.generate(p, m, timeout=120) for p, m in KNOB_WORK]
    st = eng.stats()
    hits = 0
    for i, ((p, m), o) in enumerate(zip(KNOB_WORK, outs)):
        L = 16 if (eng.prefix_cache_slots and i > 0
                   and p[:16] == SHARED) else 0
        hits += L > 0
        np.testing.assert_array_equal(
            o, jm.reference_generate(p, m, window=W, kv_dtype=eng.kv_dtype,
                                     cached_prefix_len=L),
            err_msg=f"prompt {p} (cached {L})")
    assert st["prefix_hits"] == hits
    return st


def _knob_took_effect(st, name):
    if name == "draft_tokens":
        assert st["draft_tokens"] > 0
        assert st["draft_accepted"] + st["draft_rejected"] > 0
    elif name == "kv_dtype":
        assert st["pool"]["dtype"] in ("int8", "bfloat16")
    else:
        assert st["prefix_hits"] == 2 and st["prefix_cache"]["entries"] == 1


@pytest.mark.parametrize("kw", [
    dict(draft_tokens=2), dict(kv_dtype="int8"), dict(prefix_cache_slots=2),
    dict(kv_dtype="bfloat16")], ids=lambda kw: f"{next(iter(kw))}")
def test_engine_refuses_unported_knobs(pair, kw):
    """Each knob the first slice refused now builds an engine that serves,
    token-exact against the JAX reference (a bfloat16 pool under a float32
    model included)."""
    jm, tm = pair
    with serve.ContinuousEngine(tm, max_slots=2, prefill_window=W,
                                decode_steps=2, **kw) as eng:
        st = _serves_like_jax(jm, eng)
    _knob_took_effect(st, next(iter(kw)))
    if "kv_dtype" in kw:
        assert st["pool"]["dtype"] == kw["kv_dtype"]


@pytest.mark.parametrize("env", [
    ("MXNET_SERVE_DRAFT_TOKENS", "1"), ("MXNET_SERVE_KV_DTYPE", "int8"),
    ("MXNET_SERVE_PREFIX_CACHE_SLOTS", "1")], ids=lambda e: e[0])
def test_engine_refuses_unported_env(pair, env, monkeypatch):
    """Each env var the first slice refused now sets its knob, and the
    engine serves token-exact against the JAX reference."""
    jm, tm = pair
    monkeypatch.setenv(*env)
    with serve.ContinuousEngine(tm, max_slots=2, prefill_window=W,
                                decode_steps=2) as eng:
        st = _serves_like_jax(jm, eng)
    name = {"MXNET_SERVE_DRAFT_TOKENS": "draft_tokens",
            "MXNET_SERVE_KV_DTYPE": "kv_dtype",
            "MXNET_SERVE_PREFIX_CACHE_SLOTS": "prefix_cache_slots"}[env[0]]
    _knob_took_effect(st, name)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.5), dict(top_k=3), dict(top_p=0.5)],
    ids=lambda kw: next(iter(kw)))
def test_submit_refuses_sampling(pair, kw):
    """Each sampling parameter the first slice refused is served: the
    reply equals the 1-slot reference with the same parameters and seed
    (top_k or top_p alone, at temperature 0, stays greedy and equals the
    JAX reference too)."""
    jm, tm = pair
    before = serve.serve_stats()["decode_sampled_tokens"]
    with serve.ContinuousEngine(tm, max_slots=2) as eng:
        out = eng.generate([1, 2], 6, seed=7, timeout=60, **kw)
        assert eng.generate([1, 2], 2, seed=7, timeout=60).size == 2
    np.testing.assert_array_equal(
        out, tm.reference_generate([1, 2], 6, seed=7, **kw))
    sampled = serve.serve_stats()["decode_sampled_tokens"] - before
    if "temperature" in kw:
        assert sampled == out.size
    else:
        assert sampled == 0
        np.testing.assert_array_equal(out, jm.reference_generate([1, 2], 6))


def test_full_engine_mixed_traffic_exact(pair):
    """int8 KV, draft 2, prefix cache and half the requests sampled, all
    at once: a cold request publishes SHARED, then hits, cold prompts (one
    chunked) and a sampled/greedy mix are submitted together. Every reply
    equals the port's 1-slot reference with the same knobs; the greedy
    replies also equal the JAX reference."""
    jm, tm = pair
    rng = np.random.RandomState(3)
    work = [(SHARED + rng.randint(1, 64, n).tolist(), m)
            for n, m in ((3, 9), (20, 6), (1, 12), (9, 7))]
    work += [(rng.randint(1, 64, n).tolist(), m)
             for n, m in ((4, 10), (30, 8), (12, 5), (2, 11))]
    samp = [dict(temperature=0.8, top_k=8, seed=40 + i) if i % 2 else {}
            for i in range(len(work))]
    with serve.ContinuousEngine(tm, max_slots=3, prefill_window=W,
                                decode_steps=3, kv_dtype="int8",
                                draft_tokens=2, prefix_cache_slots=4,
                                prefix_block=8) as eng:
        eng.generate(SHARED + [30, 31], 4, timeout=120)     # publishes
        futs = [eng.submit(p, m, **kw) for (p, m), kw in zip(work, samp)]
        outs = [f.result(timeout=120) for f in futs]
        st = eng.stats()
    assert st["prefix_hits"] == 4 and st["prefix_misses"] == 5
    assert st["sampled_tokens"] > 0 and 0 < st["draft_acceptance"] <= 1
    assert st["pool"]["dtype"] == "int8" and st["pool"]["in_use"] == 4
    for i, ((p, m), kw, o) in enumerate(zip(work, samp, outs)):
        L = 16 if i < 4 else 0
        ref = dict(window=W, kv_dtype="int8", cached_prefix_len=L)
        np.testing.assert_array_equal(
            o, tm.reference_generate(p, m, **ref, **kw),
            err_msg=f"request {i} {kw}")
        if not kw:
            np.testing.assert_array_equal(
                o, jm.reference_generate(p, m, **ref),
                err_msg=f"request {i} vs the JAX reference")


def test_prefix_hit_bills_suffix_only(pair):
    jm, tm = pair
    shared = list(range(1, 25))               # 24 tokens = 3 blocks of 8
    with serve.ContinuousEngine(tm, max_slots=2, prefill_window=16,
                                prefix_block=8,
                                prefix_cache_slots=2) as eng:
        cold = eng.generate(shared + [30, 31], 6, timeout=120)
        before = serve.serve_stats()["decode_prefill_tokens"]
        hot = eng.generate(shared + [32, 33], 6, timeout=120)
        after = serve.serve_stats()["decode_prefill_tokens"]
        st = eng.stats()
    assert after - before == 2
    assert st["prefix_hits"] == 1 and st["prefix_hit_rate"] == 0.5
    assert st["prefill_cached_token_share"] > 0.4
    assert st["prefix_cache"]["entries"] == 1
    np.testing.assert_array_equal(
        cold, jm.reference_generate(shared + [30, 31], 6, window=16))
    np.testing.assert_array_equal(
        hot, jm.reference_generate(shared + [32, 33], 6, window=16,
                                   cached_prefix_len=24))


def test_int8_shared_prefix_poison_isolation(pair):
    """Poison every int8 row (codes 1, scales 1e9) except the cache's
    after the prefix is published: a later hit reads only the copied cache
    row (codes AND scales) and its own suffix, through the speculative
    verify, and equals the hit-path reference bit for bit."""
    jm, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=1, prefill_window=16,
                                 prefix_block=8, prefix_cache_slots=1,
                                 decode_steps=2, kv_dtype="int8",
                                 draft_tokens=2).start()
    try:
        shared = list(range(2, 18))           # 16 tokens = 2 blocks
        eng.generate(shared + [30], 6, timeout=120)    # publishes [0,16)
        cache_rows = set(eng.pool.in_use())
        assert len(cache_rows) == 1
        for s in range(eng.pool.max_slots + 1):        # incl. garbage
            if s not in cache_rows:
                eng.pool.poison_slot(s, 1e9)
        hot = eng.generate(shared + [31, 32], 6, timeout=120)
        assert eng.stats()["prefix_hits"] == 1
    finally:
        eng.close()
    ref = dict(window=16, kv_dtype="int8", cached_prefix_len=16)
    np.testing.assert_array_equal(
        hot, tm.reference_generate(shared + [31, 32], 6, **ref))
    np.testing.assert_array_equal(
        hot, jm.reference_generate(shared + [31, 32], 6, **ref),
        err_msg="a poisoned row leaked into an int8 shared-prefix hit")


def test_spec_page_end_clipped_writes_unreachable():
    """Near the page end the speculative chunk's write positions clip to
    max_len - 1 and repeat within one indexed assignment (which writer
    wins is undefined on CUDA). On a poisoned int8 pool, requests that run
    to a full page through draft 3 still equal the plain reference: no
    emitted token can reach the clipped positions."""
    cfg = dict(CFG, max_len=24)
    jm, tm = decoders(cfg)
    work = [(list(range(1, 14)), 30), ([4, 8, 4, 8, 4, 8, 4], 30)]
    with serve.ContinuousEngine(tm, max_slots=2, decode_steps=3,
                                draft_tokens=3, kv_dtype="int8") as eng:
        eng.pool.poison(1e9)
        outs = [eng.submit(p, m) for p, m in work]
        outs = [f.result(timeout=120) for f in outs]
    for (p, m), o in zip(work, outs):
        assert len(p) + len(o) == cfg["max_len"]      # ran to page full
        np.testing.assert_array_equal(
            o, jm.reference_generate(p, m, kv_dtype="int8"))


def test_spec_engine_eos_inside_draft_block(pair):
    jm, tm = pair
    prompt, max_new = [7, 3, 19], 16
    base = jm.reference_generate(prompt, max_new)
    eos = int(base[len(base) // 2])
    expect = jm.reference_generate(prompt, max_new, eos_id=eos)
    assert len(expect) < len(base)
    with serve.ContinuousEngine(tm, max_slots=2, decode_steps=3,
                                eos_id=eos, draft_tokens=2) as eng:
        out = eng.generate(prompt, max_new, timeout=120)
        st = eng.stats()
    np.testing.assert_array_equal(out, expect)
    assert out[-1] == eos and st["decode_tokens"] == len(out) - 1


def test_admission_budget_uses_post_cache_cost(pair):
    """A fully cached long prompt (1-token suffix) fits a nearly spent
    prefill budget and is admitted past an earlier cold prompt whose
    full-window cost does not.

    Both held slots come free in one step: they are freed under the
    engine's condition, which admission runs under, so no admission sees
    one free slot between the two frees. The order is the engine's own:
    the requests' prompts in the order `_admit_locked` granted them."""
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=2, prefill_lanes=2,
                                 prefill_window=16, prefix_block=8,
                                 prefix_cache_slots=1, prefill_budget=8,
                                 decode_steps=1).start()
    admit = eng._admit_locked
    granted = []

    def recording_admit():
        admitted, expired = admit()
        granted.extend(tuple(int(t) for t in r.prompt) for r in admitted)
        return admitted, expired

    try:
        shared = list(range(1, 17))
        eng.generate(shared + [20], 2, timeout=120)
        held = [eng.pool.claim(), eng.pool.claim()]
        eng._admit_locked = recording_admit
        named = {"first": [40, 41, 42, 43], "cold": list(range(30, 44)),
                 "hot": shared + [21]}
        futs = [eng.submit(p, 2) for p in named.values()]
        with eng._cv:
            for s in held:
                eng.pool.free(s)
        for f in futs:
            f.result(timeout=120)
    finally:
        eng.close()
    by_prompt = {tuple(p): n for n, p in named.items()}
    order = [by_prompt[p] for p in granted]
    assert sorted(order) == sorted(named), order
    assert order.index("hot") < order.index("cold"), order


def test_new_knobs_resolve_arg_over_env_over_default(pair, monkeypatch):
    _, tm = pair
    eng = serve.ContinuousEngine(tm, max_slots=2)
    assert (eng.draft_tokens, eng.kv_dtype, eng.prefix_block,
            eng.prefix_cache_slots, eng.prefix_cache_insert) \
        == (0, None, 16, 0, True)
    assert eng.pool.max_slots == 2 and eng.pool.dtype == "float32"
    for name, val in (("DRAFT_TOKENS", "3"), ("KV_DTYPE", "int8"),
                      ("PREFIX_BLOCK", "4"), ("PREFIX_CACHE_SLOTS", "2"),
                      ("PREFIX_CACHE_INSERT", "0")):
        monkeypatch.setenv(f"MXNET_SERVE_{name}", val)
    eng = serve.ContinuousEngine(tm, max_slots=2)
    assert (eng.draft_tokens, eng.kv_dtype, eng.prefix_block,
            eng.prefix_cache_slots, eng.prefix_cache_insert) \
        == (3, "int8", 4, 2, False)
    # the cache's rows come on top of the request slots, claimed up front
    assert eng.pool.max_slots == 4 and eng.pool.free_count() == 2
    eng = serve.ContinuousEngine(tm, max_slots=2, draft_tokens=1,
                                 kv_dtype="bfloat16", prefix_block=8,
                                 prefix_cache_slots=1,
                                 prefix_cache_insert=True)
    assert (eng.draft_tokens, eng.pool.dtype, eng.prefix_block,
            eng.pool.max_slots, eng.prefix_cache_insert) \
        == (1, "bfloat16", 8, 3, True)
    for bad in (dict(draft_tokens=-1), dict(prefix_block=0),
                dict(prefix_cache_slots=-1), dict(kv_dtype="float64")):
        with pytest.raises(serve.ServeError):
            serve.ContinuousEngine(tm, max_slots=1, **bad)
    started = serve.ContinuousEngine(tm, max_slots=1)
    for kw, what in ((dict(temperature=-0.5), "temperature"),
                     (dict(temperature=1.0, top_k=-1), "top_k"),
                     (dict(temperature=1.0, top_p=0.0), "top_p"),
                     (dict(temperature=1.0, top_p=1.5), "top_p")):
        with pytest.raises(serve.ServeError, match=what):
            started.submit([1, 2], 4, **kw)


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
