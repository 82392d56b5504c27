"""PyTorch port: `mx.telemetry.trace` (request tracing and the crash flight
recorder) held against the JAX package's, on the CPU.

Covered: TraceContext minting, children and the JSON round trip (a
context from either package reads in the other); attach / detach across
a thread; deterministic head sampling, the same 1-in-k sequence as the
JAX package's; the `trace` and `flightrec` stats groups; the flight
recorder's ring capacity and drop count, its SIGKILL-durable JSONL spool
and its dump file (the same event envelope as the JAX package's); no
files without MXNET_FLIGHTREC_DIR; the fault logger and the watchdog
feeding it; the crash hooks (atexit and SIGTERM) armed while a spool
directory is set, and put back after; the OOM excepthook; a serving
overload recorded and dumped; trace contexts crossing the device feed's
and the record iterator's thread hops; one trace per request through the
continuous engine.

Every test leaves the process as it found it
(`torch_port_utils.process_state_kept`); a test that arms hooks runs
inside `crash_hooks_restored`.
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.telemetry import trace as jtrace
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import trace as ttrace

from torch_port_utils import (CFG, crash_hooks_restored, decoders,
                              expire_port_trace_memo, process_state_kept)

torch.set_num_threads(1)

REC = os.path.join(os.path.dirname(__file__), "data", "tiny_imagerec.rec")


@pytest.fixture(autouse=True)
def _fresh_port_trace_env_memo():
    expire_port_trace_memo()
    yield
    expire_port_trace_memo()


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    with process_state_kept():
        yield


@pytest.fixture
def hooks():
    """Both packages' crash hooks and flight recorders put back after."""
    with crash_hooks_restored():
        yield


@pytest.fixture
def profiling():
    tprof._events.clear()
    tprof.start()
    yield tprof
    tprof.stop()
    tprof._events.clear()


def _set_env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, str(v))
    expire_port_trace_memo()
    jtrace._expire_env_memo()


# ---------------------------------------------------------------------------
# contexts and sampling
# ---------------------------------------------------------------------------
def test_context_mint_child_and_serialize_round_trip():
    root = ttrace.new_context("req.root")
    assert root is not None and root.parent_span_id is None
    assert root.span_id == root.trace_id
    child = ttrace.child_context(root, "req.stage")
    assert child.trace_id == root.trace_id
    assert child.span_id != root.span_id
    assert child.parent_span_id == root.span_id
    assert child.parent_name == "req.root"
    back = ttrace.TraceContext.from_dict(
        json.loads(json.dumps(child.to_dict())))
    assert (back.trace_id, back.span_id, back.parent_span_id,
            back.parent_name) == (child.trace_id, child.span_id,
                                  child.parent_span_id, child.parent_name)
    assert ttrace.TraceContext.from_dict(None) is None
    assert ttrace.TraceContext.from_dict({}) is None
    # the wire form is the JAX package's: each reads the other's
    jchild = jtrace.child_context(jtrace.new_context("j.root"), "j.stage")
    assert set(jchild.to_dict()) == set(child.to_dict())
    mine = ttrace.TraceContext.from_dict(jchild.to_dict())
    assert mine.to_dict() == jchild.to_dict()
    theirs = jtrace.TraceContext.from_dict(child.to_dict())
    assert theirs.to_dict() == child.to_dict()


def test_attach_detach_and_cross_thread_current_span():
    got = {}
    with ttel.span("consumer.step"):
        ctx = ttrace.current_context()
        assert ctx is not None and ctx.name == "consumer.step"

        def worker():
            got["fresh"] = ttel.current_span()
            token = ttrace.attach(ctx)
            got["name"] = ttel.current_span()
            ttrace.detach(token)
            got["after"] = ttel.current_span()
            with ttrace.attached(ctx):
                got["scoped"] = ttel.current_span()

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert got == {"fresh": None, "name": "consumer.step", "after": None,
                   "scoped": "consumer.step"}
    assert ttrace.current_context() is None


@pytest.mark.parametrize("rate", ["0", "0.3", "0.5", "1"])
def test_head_sampling_is_the_jax_packages_sequence(monkeypatch, rate):
    _set_env(monkeypatch, MXNET_TRACE_SAMPLE=rate)
    saved = jtrace._sample_n[0], ttrace._sample_n[0]
    jtrace._sample_n[0] = ttrace._sample_n[0] = 0
    try:
        jseq = [jtrace.new_context("x") is not None for _ in range(40)]
        tseq = [ttrace.new_context("x") is not None for _ in range(40)]
    finally:
        jtrace._sample_n[0], ttrace._sample_n[0] = saved
    assert tseq == jseq
    assert sum(tseq) == round(40 * float(rate))


def test_sampled_out_subtree_mints_no_ids(monkeypatch):
    _set_env(monkeypatch, MXNET_TRACE_SAMPLE="0")
    before = ttel.snapshot()["trace.sampled_out"]
    with ttel.span("sampled.out") as outer:
        with ttel.span("inner") as inner:
            assert ttrace.current_context() is None
    assert outer.context is None and inner.context is None
    assert ttel.snapshot()["trace.sampled_out"] == before + 1
    assert ttel.snapshot()['span.count{name="inner"}'] >= 1


def test_trace_and_flightrec_groups_are_the_jax_packages():
    assert set(ttrace.TRACE_STATS) == set(jtrace.TRACE_STATS)
    assert set(ttrace.FLIGHTREC_STATS) == set(jtrace.FLIGHTREC_STATS)
    before = ttel.snapshot()["trace.traces"]
    assert ttrace.new_context("group.probe") is not None
    assert ttel.snapshot()["trace.traces"] == before + 1
    ttel.flightrec_record("test", "group.probe")
    assert ttel.snapshot()["flightrec.events"] >= 1


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
def test_ring_capacity_and_dropped(monkeypatch, hooks):
    _set_env(monkeypatch, MXNET_FLIGHTREC_EVENTS=16)
    before = ttel.snapshot()["flightrec.dropped"]
    for i in range(40):
        ttel.flightrec_record("test", "ring", i=i)
    evs = ttel.flightrec_events()
    assert len(evs) == 16 and [e["i"] for e in evs] == list(range(24, 40))
    assert ttel.snapshot()["flightrec.dropped"] - before == 24


def test_spool_and_dump_carry_the_jax_packages_envelope(monkeypatch,
                                                        tmp_path, hooks):
    _set_env(monkeypatch, MXNET_FLIGHTREC_DIR=tmp_path / "t")
    ctx = ttrace.new_context("spool.req")
    with ttrace.attached(ctx):
        ttel.flightrec_record("fault", "io.probe", kind="kill", step=3)
    jtrace.FLIGHTREC._reset_for_tests()
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path / "j"))
    with jtrace.attached(jtrace.new_context("spool.req")):
        jtrace.flightrec_record("fault", "io.probe", kind="kill", step=3)
    spool = tmp_path / "t" / f"flightrec-{os.getpid()}.jsonl"
    lines = [json.loads(x) for x in spool.read_text().splitlines()]
    assert len(lines) == 1
    ev = lines[0]
    assert ev["kind"] == "fault" and ev["f_kind"] == "kill"
    assert ev["trace_id"] == ctx.trace_id and ev["step"] == 3
    jev = jtrace.flightrec_events()[-1]
    assert set(ev) == set(jev)
    path = ttel.flightrec_dump(reason="test")
    assert path == str(tmp_path / "t" / f"flightrec-{os.getpid()}.json")
    with open(path) as f:
        payload = json.load(f)
    jpath = jtrace.flightrec_dump(reason="test")
    with open(jpath) as f:
        jpayload = json.load(f)
    assert set(payload) == set(jpayload)
    assert payload["reason"] == "test" and payload["n_events"] == 1
    assert payload["events"][0]["name"] == "io.probe"


def test_no_files_without_a_spool_dir(monkeypatch, tmp_path, hooks):
    monkeypatch.delenv("MXNET_FLIGHTREC_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    ttel.flightrec_record("test", "no.dir")
    assert ttel.flightrec_maybe_dump("serve.overload") is None
    assert list(tmp_path.iterdir()) == []
    assert not ttrace.collector_active() or ttrace._profiler_running() \
        or os.environ.get("MXNET_TRACE_SAMPLE") is not None


def test_fault_log_events_feed_the_recorder(hooks):
    tfault._log_event("resilient.skipped_nonfinite", step=7)
    evs = [e for e in ttel.flightrec_events() if e["kind"] == "fault"]
    assert evs and evs[-1]["name"] == "resilient.skipped_nonfinite"
    assert evs[-1]["step"] == 7


def test_watchdog_timeout_records_and_dumps(monkeypatch, tmp_path, hooks):
    _set_env(monkeypatch, MXNET_FLIGHTREC_DIR=tmp_path)
    with pytest.raises(tfault.WatchdogTimeout):
        with tfault.watchdog(0.05, message="stalled step"):
            time.sleep(0.5)
    evs = [e for e in ttel.flightrec_events() if e["kind"] == "watchdog"]
    assert evs and evs[-1]["name"] == "stalled step"
    dump = tmp_path / f"flightrec-{os.getpid()}.json"
    assert any(e["kind"] == "watchdog"
               for e in json.loads(dump.read_text())["events"])


def test_crash_hooks_arm_only_with_a_spool_dir(monkeypatch, tmp_path,
                                               hooks):
    monkeypatch.delenv("MXNET_FLIGHTREC_DIR", raising=False)
    ttrace._atexit_armed[0] = ttrace._sigterm_armed[0] = False
    handler = signal.getsignal(signal.SIGTERM)
    ttel.install_crash_hooks()
    assert not ttrace._atexit_armed[0]
    assert signal.getsignal(signal.SIGTERM) is handler
    ttrace.FLIGHTREC._reset_for_tests()
    _set_env(monkeypatch, MXNET_FLIGHTREC_DIR=tmp_path)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    ttel.install_crash_hooks()
    ttel.install_crash_hooks()                  # idempotent
    assert ttrace._atexit_armed[0] and ttrace._sigterm_armed[0]
    assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL
    ttrace._atexit_dump()
    assert (tmp_path / f"flightrec-{os.getpid()}.json").exists()


def test_oom_excepthook_writes_the_black_box(monkeypatch, tmp_path, hooks,
                                             capsys):
    _set_env(monkeypatch, MXNET_MEM_OOM_DUMP=tmp_path)
    from incubator_mxnet_tpu_torch.inspect import memory as tmem
    # an earlier test of this process may have armed it (a Server does);
    # the `hooks` fixture puts the latch and the chain back
    tmem._hook_installed[0] = False
    prev = sys.excepthook
    ttel.mem_install_oom_hook()
    ttel.mem_install_oom_hook()                 # idempotent
    assert sys.excepthook is not prev
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")
    sys.excepthook(type(err), err, None)
    dump = tmp_path / f"oomdump-{os.getpid()}.json"
    rep = json.loads(dump.read_text())
    assert rep["reason"] == "uncaught" and "OutOfMemoryError" in rep["error"]
    assert "OutOfMemoryError" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the hooks in the ported modules
# ---------------------------------------------------------------------------
class _SlowModel:
    batch_sizes = [1]
    row_specs = [((4,), "float32")]
    single_output = True

    def run_batch(self, bucket, arrs):
        time.sleep(0.05)
        return (np.zeros((bucket, 1), np.float32),)

    def warmup(self):
        pass

    def compile_cache_size(self):
        return 1


@pytest.mark.parametrize("policy", ["shed", "reject"])
def test_serve_overload_records_and_dumps(monkeypatch, tmp_path, hooks,
                                          policy):
    _set_env(monkeypatch, MXNET_FLIGHTREC_DIR=tmp_path)
    ttrace._atexit_armed[0] = False
    with tserve.Server(_SlowModel(), max_queue=1, overload_policy=policy,
                       batch_timeout_ms=0.1) as srv:
        # the server armed its hooks: a spool dir is set
        assert ttrace._atexit_armed[0]
        futs = []
        for _ in range(8):
            try:
                futs.append(srv.submit(np.ones(4, np.float32)))
            except tserve.QueueFullError:
                pass
        for f in futs:
            try:
                f.result(timeout=30)
            except tserve.QueueFullError:
                pass
    kind = "serve.shed" if policy == "shed" else "serve.reject"
    assert any(e["kind"] == kind for e in ttel.flightrec_events())
    assert (tmp_path / f"flightrec-{os.getpid()}.json").exists()


def test_device_feed_stage_spans_nest_under_the_consumer_step(profiling):
    src = [np.full((2, 2), i, np.float32) for i in range(3)]
    with ttel.span("consumer.step") as step:
        out = [b.asnumpy() for b in tmx.io.DeviceFeed(iter(src), depth=2,
                                                      device="cpu")]
    assert len(out) == 3
    tid = step.context.trace_id
    stages = [e for e in profiling._events if e["name"] == "feed.stage"]
    feeds = [e for e in profiling._events if e["name"] == "io.feed"]
    assert len(stages) == 3 and len(feeds) == 3
    assert all(e["args"]["trace_id"] == tid for e in stages + feeds)
    assert all(e["args"]["parent"] == "consumer.step" for e in stages)


@pytest.mark.parametrize("workers", [0, 1])
def test_record_decode_lanes_join_the_consumer_trace(profiling, workers):
    # workers=0 decodes on the native thread pool, 1 in a shm worker
    it = tmx.io.ImageRecordIter(REC, data_shape=(32, 32, 3), batch_size=3,
                                resize=36, workers=workers, lookahead=1,
                                round_batch=False, device="cpu",
                                preprocess_threads=2)
    try:
        with ttel.span("train.step.rectest") as ep:
            # deeper than the lookahead: batches are submitted inside the
            # span (the construction-time submits predate it)
            for _ in range(4):
                it.next()
    finally:
        it.close()
    lanes = [e for e in profiling._events if e["name"] == "io.worker.decode"]
    assert lanes
    in_trace = [e for e in lanes
                if e["args"].get("trace_id") == ep.context.trace_id]
    assert in_trace and "worker" in in_trace[0]["args"]


def test_engine_one_trace_per_request(monkeypatch, profiling, hooks):
    _set_env(monkeypatch, MXNET_TRACE_SAMPLE=1)
    _, tm = decoders()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, CFG["vocab"], n).astype(np.int32)
               for n in (5, 9, 3)]
    with tserve.ContinuousEngine(tm, max_slots=2, decode_steps=2,
                                 prefill_window=8) as eng:
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, 4) for p in prompts]]
    assert all(len(o) == 4 for o in outs)
    ev = profiling._events
    reqs = [e for e in ev if e["name"] == "serve.request"]
    assert len(reqs) == 3
    ids = {e["args"]["trace_id"] for e in reqs}
    assert len(ids) == 3
    for name in ("serve.prefill", "serve.decode"):
        kids = [e for e in ev if e["name"] == name]
        assert len(kids) == 3 and {e["args"]["trace_id"]
                                   for e in kids} == ids
        assert all(e["args"]["parent"] == "serve.request" for e in kids)
    assert any(e["name"] == "serve.decode_batch" for e in ev)
    assert any(e["name"] == "serve.prefill_batch" for e in ev)
