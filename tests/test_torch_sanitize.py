"""PyTorch port: mx.sanitize (the in-place check, the recompile sentinel,
the slot canary) on the port's programs, held against the JAX package's
`sanitize` where the two agree and pinning where they differ on purpose.

The JAX package's `tests/test_sanitize.py`, on the port and the same tiny
`CFG`: planted violations trip with typed errors, real clean loops stay
silent, everything is off by default with the program itself returned.
The port's "donation" mode checks in-place aliasing (a donated argument
overlapping another argument before the call; a donated argument not
updated in place after it); a live tensor passed again is NOT a
violation there (it is a use after donate in JAX), and there is no
reallocate case (the port's pool is never reallocated).

Every test runs inside `process_state_kept()` and `crash_hooks_restored()`,
with MXNET_SANITIZE and MXNET_TUNE_* put back.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import sanitize as jsanitize
from incubator_mxnet_tpu_torch import sanitize, serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serve.kv_pool import KVCachePool

from torch_port_utils import (CFG, crash_hooks_restored, decoders,
                              numpy_params, port_faults_cleared,
                              process_state_kept)

torch.set_num_threads(1)


@contextlib.contextmanager
def _env_restored():
    names = [k for k in os.environ
             if k.startswith("MXNET_TUNE_") or k == "MXNET_SANITIZE"]
    saved = {k: os.environ.pop(k) for k in names}
    try:
        yield
    finally:
        for k in [k for k in os.environ
                  if k.startswith("MXNET_TUNE_") or k == "MXNET_SANITIZE"]:
            os.environ.pop(k)
        os.environ.update(saved)


@pytest.fixture(autouse=True)
def _isolate():
    with process_state_kept(), crash_hooks_restored(), \
            port_faults_cleared(), _env_restored():
        sanitize.clear()
        try:
            yield
        finally:
            sanitize.clear()


def _prog(fn=None, donate=(0,)):
    """A wrapped two-argument program: `w -= g` in place by default."""
    if fn is None:
        def fn(w, g):
            w.sub_(g)
            return w
    return sanitize.maybe_wrap_donated(fn, donate, "step")


def _model(**kw):
    return serve.CachedDecoder(serve.DecoderConfig(**CFG), seed=3,
                               device="cpu", **kw)


# ---------------------------------------------------------------------------
# mode plumbing: off by default, zero-cost when off
# ---------------------------------------------------------------------------
def test_off_by_default_wrapper_is_identity():
    assert sanitize.modes() == frozenset()

    def f(x):
        return x
    assert sanitize.maybe_wrap_donated(f, (0,), "t") is f
    # the decoder's programs are only signature-counted when off
    model = _model()
    prog = model.decode_program(3)
    assert not isinstance(prog, sanitize._SanitizedProgram)
    assert prog._cache_size() == 0
    assert not sanitize.tracked_programs() or all(
        p is not prog for p in sanitize.tracked_programs())


@pytest.mark.parametrize("raw", ["donation, retrace", "all", "slot",
                                 " retrace ,", ""])
def test_mode_parsing_equals_the_jax_packages(monkeypatch, raw):
    monkeypatch.setenv("MXNET_SANITIZE", raw)
    assert sanitize.modes() == jsanitize.modes()


def test_mode_parsing(monkeypatch):
    monkeypatch.setenv("MXNET_SANITIZE", "donation, retrace")
    assert sanitize.modes() == frozenset({"donation", "retrace"})
    monkeypatch.setenv("MXNET_SANITIZE", "all")
    assert sanitize.modes() == frozenset({"donation", "retrace", "slot"})
    monkeypatch.setenv("MXNET_SANITIZE", "turbo")
    with pytest.raises(MXNetError, match="unknown mode"):
        sanitize.modes()


def test_scope_overrides_and_restores():
    assert not sanitize.enabled("donation")
    with sanitize.scope("donation"):
        assert sanitize.enabled("donation")
        assert not sanitize.enabled("slot")
    assert not sanitize.enabled("donation")
    with pytest.raises(MXNetError, match="unknown mode"):
        with sanitize.scope("donation,turbo"):
            pass
    assert sanitize.modes() == frozenset()


def test_surface_is_the_jax_packages():
    assert sorted(sanitize.__all__) == sorted(jsanitize.__all__)
    for name in ("DonationViolation", "RetraceViolation",
                 "SlotCanaryError"):
        assert issubclass(getattr(sanitize, name), MXNetError)


# ---------------------------------------------------------------------------
# donation mode: in-place aliasing
# ---------------------------------------------------------------------------
def test_aliased_donated_arguments_trip_before_any_write():
    with sanitize.scope("donation"):
        step = _prog()
        w = torch.ones(4)
        with pytest.raises(sanitize.DonationViolation) as ei:
            step(w, w)                   # the update would read itself
        msg = str(ei.value)
        assert "argument 0" in msg and "argument 1" in msg
        assert "`step`" in msg and "call 1" in msg
        assert torch.equal(w, torch.ones(4))         # nothing written
        # a view of the donated buffer aliases it too
        with pytest.raises(sanitize.DonationViolation):
            step(w, w[1:3])
        step(w, w.clone())                           # separate: silent


def test_copy_program_with_one_slab_twice_trips_before_any_write():
    with sanitize.scope("donation"):
        model = _model()
        pool = model.new_pool(2)
        pool.poison_slot(0, 5.0)
        k, v = pool.buffers()
        before = k.clone()
        cp = model.copy_program()
        rows = torch.tensor([0])
        with pytest.raises(sanitize.DonationViolation,
                           match="copy_slot_rows"):
            cp(k, k, rows, torch.tensor([1]))
        assert torch.equal(k, before)


def test_int8_slabs_are_checked_leaf_by_leaf():
    with sanitize.scope("donation"):
        model = _model()
        pool = model.new_pool(2, dtype="int8")
        (kc, ks), (vc, vs) = pool.buffers()
        cp = model.copy_program()
        with pytest.raises(sanitize.DonationViolation):
            cp((kc, ks), (vc, ks), torch.tensor([0]), torch.tensor([1]))
        cp((kc, ks), (vc, vs), torch.tensor([0]), torch.tensor([1]))


def test_a_program_that_writes_a_copy_trips():
    with sanitize.scope("donation"):
        step = _prog(lambda w, g: w - g)            # not in place
        w = torch.ones(4)
        with pytest.raises(sanitize.DonationViolation) as ei:
            step(w, torch.ones(4))
        assert "argument 0" in str(ei.value)
        assert "not written in place" in str(ei.value)


def test_a_program_that_swaps_the_storage_trips():
    def swap(w, g):
        w.set_(w - g)
        return w
    with sanitize.scope("donation"):
        step = _prog(swap)
        with pytest.raises(sanitize.DonationViolation,
                           match="no longer owns the storage"):
            step(torch.ones(4), torch.ones(4))


def test_a_write_through_data_needs_the_version_bump():
    def through_data(w, g):
        w.data.sub_(g)                      # hidden from the version
        return w

    def bumped(w, g):
        through_data(w, g)
        torch.autograd.graph.increment_version(w)
        return w
    with sanitize.scope("donation"):
        with pytest.raises(sanitize.DonationViolation):
            _prog(through_data)(torch.ones(4), torch.ones(4))
        w = torch.ones(4)
        _prog(bumped)(w, torch.ones(4))
        assert torch.equal(w, torch.zeros(4))


def test_a_live_tensor_passed_again_is_silent():
    """The deliberate difference from JAX's use-after-donate: the port's
    program updated `w` in place, so `w` IS the current buffer."""
    with sanitize.scope("donation"):
        step = _prog()
        w = torch.ones(4)
        for _ in range(4):
            step(w, torch.ones(4))
        assert float(w[0]) == -3.0


# ---------------------------------------------------------------------------
# retrace mode: the signature-counted sentinel
# ---------------------------------------------------------------------------
def test_counted_program_counts_distinct_signatures():
    prog = sanitize.counted(lambda x, n: x * n, key="k")
    prog(torch.ones(4), 2)
    prog(torch.ones(4), 3)                      # same signature
    assert prog._cache_size() == 1
    prog(torch.ones(4, dtype=torch.float64), 2)
    prog(torch.ones(8), 2)
    prog(torch.ones(8), 2.0)                    # a float, not an int
    assert prog._cache_size() == 4
    assert prog._last_sig[0] == "k"


def test_retrace_poll_noop_until_armed():
    with sanitize.scope("retrace"):
        step = _prog()
        step(torch.ones(4), torch.ones(4))
        sanitize.poll("never armed")


def test_retrace_growth_after_arm_trips_with_drift():
    with sanitize.scope("retrace"):
        step = _prog()
        step(torch.ones(4), torch.ones(4))
        sanitize.arm()
        sanitize.poll("steady")
        step(torch.ones(8), torch.ones(8))      # shape drift
        with pytest.raises(sanitize.RetraceViolation) as ei:
            sanitize.poll("steady")
        msg = str(ei.value)
        assert "`step`" in msg and "(4,)" in msg and "(8,)" in msg


def test_retrace_new_program_variant_after_arm_trips():
    with sanitize.scope("retrace"):
        step = _prog()
        step(torch.ones(4), torch.ones(4))
        sanitize.arm()
        late = _prog()
        late(torch.ones(2), torch.ones(2))
        with pytest.raises(sanitize.RetraceViolation, match="NEW program"):
            sanitize.poll("steady")


def test_steady_state_context_manager():
    with sanitize.scope("retrace"):
        step = _prog()
        step(torch.ones(4), torch.ones(4))
        with sanitize.steady_state("region"):
            step(torch.ones(4), torch.ones(4))
        with pytest.raises(sanitize.RetraceViolation):
            with sanitize.steady_state("region"):
                step(torch.ones(16), torch.ones(16))


# ---------------------------------------------------------------------------
# slot mode: the canary row
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int8"])
def test_slot_canary_silent_then_trips_on_corruption(dtype):
    pool = KVCachePool(2, layers=1, max_len=8, heads=2, head_dim=4,
                       dtype=dtype, device="cpu")
    canary = sanitize.SlotCanary(pool)
    canary.check("wave")
    canary.check("wave")
    pool.k[canary.slot] = 0           # a write through the slot masks
    with pytest.raises(sanitize.SlotCanaryError) as ei:
        canary.check("wave")
        canary.check("wave")
    assert f"slot {canary.slot}" in str(ei.value)
    assert "(k slab)" in str(ei.value)
    canary.rearm()
    canary.check("wave")
    canary.check("wave")
    assert canary.waves == 6
    canary.release()
    assert pool.free_count() == 2


# ---------------------------------------------------------------------------
# engine integration: silent on a clean loop, typed errors on breaches
# ---------------------------------------------------------------------------
def _engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("decode_steps", 3)
    return serve.ContinuousEngine(model, **kw)


def _workload(eng, n=6, rseed=0, longest=12, **sub):
    rng = np.random.RandomState(rseed)
    futs = [eng.submit(rng.randint(1, 64,
                                   size=rng.randint(2, longest)).tolist(),
                       int(rng.randint(1, 10)), **sub) for _ in range(n)]
    return [f.result(timeout=120) for f in futs]


def test_engine_clean_loop_silent_under_all_modes():
    with sanitize.scope("all"):
        model = _model()
        with _engine(model) as eng:
            assert eng._canary is not None
            assert isinstance(eng._decode_prog, sanitize._SanitizedProgram)
            outs = _workload(eng)
            assert all(len(o) >= 1 for o in outs)
            assert eng._canary.waves > 0
            assert eng.compile_cache_size() == eng._warm_cache_size
            assert eng.assert_no_retraces() == 0
        assert eng._canary is None and eng.pool.free_count() == 4


def test_engine_chunks_prefix_cache_and_sampling_silent_under_all_modes():
    """Every program the engine runs (the chunk extents, the row copy, the
    sampled decode) was warmed at its serving signatures."""
    with sanitize.scope("all"):
        model = _model()
        with _engine(model, prefill_window=8, prefix_cache_slots=2,
                     prefix_block=4) as eng:
            _workload(eng, n=6, longest=30)
            _workload(eng, n=4, longest=30, temperature=0.7, top_k=5)
            prompt = list(range(1, 21))
            eng.generate(prompt, 4, timeout=120)
            eng.generate(prompt, 4, timeout=120)        # a prefix hit
            st = eng.stats()
            assert st["chunk_batches"] > 0 and st["prefix_hits"] > 0
            assert eng.assert_no_retraces() == 0
            assert st["retraces_after_warmup"] == 0


def test_engine_speculative_decode_silent_under_all_modes():
    with sanitize.scope("all"):
        with _engine(_model(), draft_tokens=2) as eng:
            _workload(eng, n=4)
            assert eng.assert_no_retraces() == 0


def test_engine_slot_canary_catches_out_of_mask_write():
    with sanitize.scope("slot"):
        model = _model()
        with _engine(model) as eng:
            _workload(eng, n=2)
            errors = eng.stats()["errors"]
            # corrupt the canary row the way a mask-escaping store would;
            # a decode wave's check fails its requests with the typed
            # error within two waves, then the engine recovers
            eng.pool.k[eng._canary.slot] = 0.0
            f = eng.submit([1, 2, 3], 9)
            with pytest.raises(sanitize.SlotCanaryError):
                f.result(timeout=120)
            assert eng.stats()["errors"] == errors + 1
            out = eng.submit([4, 5, 6], 4).result(timeout=120)
            assert len(out) == 4
            assert bool((eng.pool.k[eng._canary.slot] == 1e9).all())


def test_engine_retrace_sentinel_catches_post_warmup_variant():
    with sanitize.scope("retrace"):
        model = _model()
        with _engine(model) as eng:
            _workload(eng, n=2)
            # a bypassing caller runs a prefill width the warmup never
            # saw
            side = model.new_pool(2)
            kb, vb = side.buffers()
            model.prefill(kb, vb, torch.ones((1, 7), dtype=torch.int32),
                          torch.full((1,), 7, dtype=torch.int32),
                          torch.zeros((1,), dtype=torch.int32))
            f = eng.submit([1, 2, 3], 6)
            with pytest.raises(sanitize.RetraceViolation,
                               match=r"prefill\[w=7\]"):
                f.result(timeout=120)
            # re-armed: the engine keeps serving
            assert len(eng.submit([4, 5, 6], 4).result(timeout=120)) == 4


def test_assert_no_retraces_without_the_sanitizer():
    model = _model()
    with _engine(model) as eng:
        warm = eng._warm_cache_size
        _workload(eng, n=3)
        assert eng.assert_no_retraces() == 0
        model.reference_generate([1, 2, 3], 2)    # a 1-lane signature
        assert eng.retraces_after_warmup() > 0
        with pytest.raises(MXNetError, match="retraced"):
            eng.assert_no_retraces()
    with sanitize.scope("all"):
        with _engine(_model()) as eng2:
            assert eng2._warm_cache_size == warm   # no mode dependence


def test_engine_tokens_equal_with_the_sanitizer_on_and_off():
    def run(**kw):
        with _engine(_model(), **kw) as eng:
            return (_workload(eng, n=6, rseed=4, longest=20) +
                    _workload(eng, n=3, rseed=5, temperature=0.9,
                              seed=11))
    off = run(prefill_window=8)
    with sanitize.scope("all"):
        on = run(prefill_window=8)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_sanitized_engine_greedy_tokens_equal_the_jax_reference():
    jm, _ = decoders()
    with sanitize.scope("all"):
        tm = serve.CachedDecoder(
            serve.DecoderConfig(**CFG),
            params=serve.params_from_jax(numpy_params(), "cpu"),
            device="cpu")
        prompts = [[3, 14, 15, 9], [2, 6, 5, 3, 5, 8, 9, 7], [11]]
        want = [np.asarray(jm.reference_generate(p, 6)) for p in prompts]
        with _engine(tm) as eng:
            got = [f.result(timeout=120)
                   for f in [eng.submit(p, 6) for p in prompts]]
            assert eng.assert_no_retraces() == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# FusedTrainStep: the step program over the weights and optimizer state
# ---------------------------------------------------------------------------
def _fused_step(seed=0):
    from incubator_mxnet_tpu_torch import gluon, optimizer
    from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu", in_units=4),
            gluon.nn.Dense(3, in_units=8))
    net.initialize(device="cpu", seed=seed)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    return net, FusedTrainStep(
        net, lambda n, x, y: loss_fn(n(x), y).sum(),
        optimizer.create("sgd", learning_rate=0.1, momentum=0.9))


def test_fused_train_step_silent_in_steady_state_and_equal():
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(6, 4).astype(np.float32))
    y = torch.as_tensor(rng.randint(0, 3, 6).astype(np.int32))
    net_off, off = _fused_step()
    with sanitize.scope("donation,retrace"):
        net_on, on = _fused_step()
        assert isinstance(on._prog, sanitize._SanitizedProgram)
        assert on._prog.name == "fused.train_step"
        on(x, y)                                     # the first signature
        with sanitize.steady_state("fused"):
            losses = [float(on(x, y)) for _ in range(3)]
        assert on._prog._cache_size() == 1
    off(x, y)
    want = [float(off(x, y)) for _ in range(3)]
    assert losses == want
    for (n, a), (_, b) in zip(sorted(net_on.collect_params().items()),
                              sorted(net_off.collect_params().items())):
        assert torch.equal(a.data(), b.data()), n


def test_fused_train_step_shape_drift_trips_the_sentinel():
    rng = np.random.RandomState(1)
    with sanitize.scope("retrace"):
        _, step = _fused_step()
        x = torch.as_tensor(rng.randn(6, 4).astype(np.float32))
        y = torch.as_tensor(rng.randint(0, 3, 6).astype(np.int32))
        step(x, y)
        with pytest.raises(sanitize.RetraceViolation,
                           match="fused.train_step"):
            with sanitize.steady_state("fused"):
                step(x[:4], y[:4])
