"""PyTorch port: `mx.telemetry` and `mx.profiler` held against the JAX
package's, on the CPU, from the same calls.

Covered: the registry's semantics (counters, gauges, histograms, labels,
type collisions), an 8-thread hammer with exact counts, snapshot/reset
conservation, the Prometheus text of the same observations byte for byte
equal to the JAX package's, span nesting and a Chrome-trace round trip
(host events only on the CPU), `StepTimeline`'s stall attribution and MFU
against hand math, FLOP counts of `block_fwd_flops` / `model_flops`
against hand math (exact for a matrix product: FlopCounterMode counts 2
per multiply-add) and against the JAX package's XLA cost analysis (within
10%: XLA also counts the bias and the activations), `Server`'s timeline
with trace ids, the /metrics endpoint, and the stats groups (`serve`,
`io.imagerec`, `feed`, `dispatch`, `fused`) named and keyed as the JAX
package's after the same traffic.

Every test leaves the process as it found it: SIGTERM's handler,
`sys.excepthook`, the threads, the MXNET_* environment and both
registries (`torch_port_utils.process_state_kept`).
"""
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.telemetry.registry import Registry as JRegistry
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry.registry import \
    Registry as TRegistry

from torch_port_utils import (crash_hooks_restored, expire_port_trace_memo,
                              process_state_kept)

torch.set_num_threads(1)

CPU = tmx.cpu()
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
def port_profiler_clean():
    """The port's profiler with an empty buffer, stopped again after."""
    tprof._events.clear()
    tprof._device_events.clear()
    tprof._state["device_trace"] = False
    yield tprof
    tprof.stop()
    tprof._events.clear()


# ---------------------------------------------------------------------------
# registry semantics, the same calls on both packages' registries
# ---------------------------------------------------------------------------
def _observe(reg):
    c = reg.counter("demo.hits", help="demo hits")
    c.inc(3)
    c.inc()
    g = reg.gauge("demo.depth")
    g.set(2)
    g.inc(0.5)
    g.dec(3)
    h = reg.histogram("demo.lat_us", labels=("op",), buckets=(10.0, 100.0))
    for v in (5, 50, 500, 10.0, 0.25):
        h.labels(op="add").observe(v)
    h.labels(op='we"ird\\name\n').observe(1e20)
    lc = reg.counter("demo.calls", labels=("kind", "dev"))
    lc.labels(kind="a", dev=0).inc(2)
    lc.labels(dev="1", kind="b").inc(1.5)
    reg.gauge("demo.nan").set(float("nan"))
    reg.gauge("demo.inf").set(float("-inf"))
    reg.gauge("demo.big").set(1e16)
    reg.histogram("span.duration_us", labels=("name",)).labels(
        name="x").observe(123.456)
    grp = reg.stats_group("demo_grp", {"k": 0, "us": 0.0}, help="demo group")
    with grp._owner_lock:
        grp["k"] += 7
        grp["us"] += 1.25
    reg.stats_group("io.imagerec", {"batches": 3})
    return reg


def test_counter_gauge_histogram_semantics_match_jax():
    j, t = _observe(JRegistry()), _observe(TRegistry())
    js, ts = j.snapshot(), t.snapshot()
    assert set(ts) == set(js)
    for k, v in js.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(ts[k])
        else:
            assert ts[k] == v, k
    assert t.names() == j.names()
    assert json.loads(t.snapshot_json().replace("NaN", "0")) == \
        json.loads(j.snapshot_json().replace("NaN", "0"))


def test_prometheus_text_is_the_jax_packages_byte_for_byte():
    j, t = _observe(JRegistry()), _observe(TRegistry())
    assert t.prometheus_text() == j.prometheus_text()
    # and after a reset window
    j.snapshot(reset=True)
    t.snapshot(reset=True)
    assert t.prometheus_text() == j.prometheus_text()


def test_prometheus_golden_text():
    reg = TRegistry()
    reg.counter("demo.hits", help="demo hits").inc(3)
    reg.gauge("demo.depth").set(2)
    h = reg.histogram("demo.lat_us", labels=("op",), buckets=(10.0, 100.0))
    h.labels(op="add").observe(5)
    h.labels(op="add").observe(50)
    grp = reg.stats_group("demo_grp", {"k": 0}, help="demo group")
    grp["k"] += 7
    assert reg.prometheus_text() == """\
# TYPE mx_demo_depth gauge
mx_demo_depth 2
# HELP mx_demo_hits demo hits
# TYPE mx_demo_hits counter
mx_demo_hits 3
# TYPE mx_demo_lat_us histogram
mx_demo_lat_us_bucket{op="add",le="10"} 1
mx_demo_lat_us_bucket{op="add",le="100"} 2
mx_demo_lat_us_bucket{op="add",le="+Inf"} 2
mx_demo_lat_us_sum{op="add"} 55
mx_demo_lat_us_count{op="add"} 2
# HELP mx_demo_grp demo group
mx_demo_grp_k 7
"""


@pytest.mark.parametrize("package", ["jax", "port"])
def test_type_collisions_and_label_errors_as_jax(package):
    reg = JRegistry() if package == "jax" else TRegistry()
    reg.counter("t.x")
    with pytest.raises(ValueError):
        reg.gauge("t.x")
    with pytest.raises(ValueError):
        reg.counter("t.x", labels=("a",))
    lab = reg.counter("t.lab", labels=("a",))
    with pytest.raises(ValueError):
        lab.labels(b=1)
    with pytest.raises(ValueError):
        reg.counter("t.neg").inc(-1)


def test_eight_thread_hammer_exact_counts():
    reg = TRegistry()
    c = reg.counter("t.hammer")
    h = reg.histogram("t.hammer_lat")
    grp = reg.stats_group("hammer", {"hits": 0})
    N, T = 1000, 8
    barrier = threading.Barrier(T)

    def work():
        barrier.wait()
        for _ in range(N):
            c.inc()
            h.observe(1.0)
            with grp._owner_lock:
                grp["hits"] += 1

    threads = [threading.Thread(target=work) for _ in range(T)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.get() == N * T
    assert h.get()["count"] == N * T
    assert grp.snapshot()["hits"] == N * T


def test_snapshot_reset_conservation():
    reg = TRegistry()
    c = reg.counter("t.flow")
    g = reg.gauge("t.level")
    g.set(42)
    grp = reg.stats_group("win", {"n": 0})
    total, seen = 600, 0
    stop = threading.Event()

    def incs():
        for _ in range(total):
            c.inc()
            with grp._owner_lock:
                grp["n"] += 1
        stop.set()

    th = threading.Thread(target=incs)
    th.start()
    while not stop.is_set():
        s = reg.snapshot(reset=True)
        seen += s["t.flow"] + s["win.n"]
    th.join()
    s = reg.snapshot(reset=True)
    seen += s["t.flow"] + s["win.n"]
    assert seen == 2 * total
    assert reg.snapshot()["t.level"] == 42.0


def test_scalar_snapshot_and_metric_names_of_the_ported_layers():
    tmx.inspect.memory.MEM_CENSUS_RUNS.inc()
    snap = ttel.scalar_snapshot()
    assert snap["mem.census_runs"] >= 1
    assert not any(isinstance(v, dict) for v in snap.values())
    # the JAX package registers these as its modules load
    import incubator_mxnet_tpu.inspect.memory  # noqa: F401
    import incubator_mxnet_tpu.serve.fleet  # noqa: F401
    import incubator_mxnet_tpu.io  # noqa: F401
    names = set(ttel.REGISTRY.names())
    for name in ("span.duration_us", "span.count", "mem.peak_hbm_bytes",
                 "mem.plans", "mem.census_runs", "mem.tagged_bytes",
                 "mem.untagged_bytes", "mem.oom_dumps", "trace.traces",
                 "trace.spans", "trace.attaches", "trace.sampled_out",
                 "flightrec.events", "flightrec.dropped", "flightrec.dumps",
                 "serve.replica_state", "io.imagerec.read_ns",
                 "io.imagerec.decode_ns", "io.imagerec.augment_ns",
                 "io.imagerec.decoded_records"):
        assert name in names and name in jtel.REGISTRY.names(), name


# ---------------------------------------------------------------------------
# spans and the profiler
# ---------------------------------------------------------------------------
def test_span_nesting_and_chrome_trace_round_trip(tmp_path,
                                                  port_profiler_clean):
    prof = port_profiler_clean
    prof.start()
    try:
        with ttel.span("outer.step", step=1):
            assert ttel.current_span() == "outer.step"
            with ttel.span("inner.op"):
                assert ttel.current_span() == "inner.op"
                time.sleep(0.001)
        assert ttel.current_span() is None
    finally:
        prof.stop()
    path = str(tmp_path / "trace.json")
    prof.dump(filename=path)
    with open(path) as f:
        trace = json.load(f)
    by_name = {e["name"]: e for e in trace["traceEvents"]}
    assert by_name["inner.op"]["args"]["parent"] == "outer.step"
    assert by_name["outer.step"]["args"]["step"] == 1
    o, i = by_name["outer.step"], by_name["inner.op"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert i["args"]["trace_id"] == o["args"]["trace_id"]
    assert i["args"]["parent_span_id"] == o["args"]["span_id"]
    # the CPU has no device trace, and the dump says so
    assert trace["otherData"]["device_trace"] is False
    assert not any(e.get("pid") == 1 for e in trace["traceEvents"])
    tele = trace["otherData"]["telemetry"]
    assert tele['span.count{name="inner.op"}'] >= 1
    assert ttel.snapshot()['span.duration_us{name="inner.op"}'][
        "count"] >= 1


def test_span_closes_on_the_error_path(port_profiler_clean):
    prof = port_profiler_clean
    prof.start()
    try:
        with pytest.raises(RuntimeError):
            with ttel.span("outer.traced"):
                with ttel.span("inner.traced"):
                    raise RuntimeError("boom")
        assert ttel.current_span() is None
    finally:
        prof.stop()
    by = {e["name"]: e for e in prof._events}
    assert by["inner.traced"]["args"]["parent"] == "outer.traced"


def test_spans_disabled_by_env(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    expire_port_trace_memo()
    key = 'span.count{name="off.span"}'
    before = ttel.snapshot().get(key, 0)
    with ttel.span("off.span") as sp:
        pass
    assert sp.duration_us is None and sp.context is None
    assert ttel.snapshot().get(key, 0) == before


def test_profiler_state_events_and_dumps(port_profiler_clean):
    prof = port_profiler_clean
    assert prof.state() == "stop" and not prof.is_running()
    prof.set_config(filename="unused.json")
    prof.start()
    assert prof.state() == "run"
    dom = prof.Domain("d")
    with prof.Task("task.a", dom):
        pass
    with prof.Frame("frame.a", dom):
        pass
    with prof.Event("event.a"):
        pass
    with prof.profiler_scope("scope.a"):
        pass
    ctr = prof.Counter(dom, "ctr.a", 1)
    ctr.increment(2)
    ctr.decrement()
    prof.Marker(dom, "mark.a").mark()
    prof.pause()
    with prof.Task("task.paused"):
        pass
    prof.resume()
    prof.stop()
    names = [e["name"] for e in prof._events]
    for n in ("task.a", "frame.a", "event.a", "scope.a", "ctr.a",
              "mark.a"):
        assert n in names
    assert "task.paused" not in names
    assert [e["args"]["value"] for e in prof._events
            if e["name"] == "ctr.a"] == [3, 2]
    ttel.REGISTRY.counter("t.dumps_probe").inc(3)
    with ttel.span("dumps.span"):
        pass
    table = prof.dumps()
    assert "Span (telemetry)" in table and "Telemetry metric" in table
    assert "t.dumps_probe" in table and "task.a" in table
    j = json.loads(prof.dumps(format="json"))
    assert j["telemetry"]["t.dumps_probe"] == 3.0
    assert j["events"]["task.a"]["calls"] == 1
    prof.dumps(reset=True)
    assert prof._events == []
    prof._state["config"].pop("filename")


def test_record_event_timestamps_monotonic_across_threads():
    stamps = []
    t0 = tprof._now_us()
    th = threading.Thread(target=lambda: stamps.append(tprof._now_us()))
    th.start()
    th.join()
    assert t0 <= stamps[0] <= tprof._now_us()


def test_stats_shims_match_their_modules():
    from incubator_mxnet_tpu_torch.io import device_feed
    from incubator_mxnet_tpu_torch.ops import fused, registry
    from incubator_mxnet_tpu_torch.serve import metrics
    assert set(tprof.serve_stats()) == set(metrics.SERVE_STATS)
    assert set(tprof.feed_stats()) == set(device_feed.FEED_STATS) | {
        "occupancy_mean"}
    assert set(tprof.dispatch_stats()) == set(registry._STATS)
    assert set(tprof.fused_stats()) == set(fused.FUSED_STATS)
    assert set(tprof.io_stats()) >= set(tmx.io.IO_STATS)
    fused.FUSED_STATS.snapshot(reset=True)
    x = torch.randn(4, 3, 3, 8).to(memory_format=torch.channels_last)
    fused.avg_pool2d(x, (3, 3))
    st = tprof.fused_stats(reset=True)
    assert st["fallback_calls"] >= 1 and st["pallas_calls"] == 0
    assert tprof.fused_stats()["fallback_calls"] == 0


def test_device_peak_flops_is_none_on_the_cpu():
    assert ttel.device_peak_flops() is None
    assert ttel.device_peak_flops("cpu") is None


# ---------------------------------------------------------------------------
# FLOPs: hand math and the JAX package's count
# ---------------------------------------------------------------------------
def test_model_flops_matches_hand_counted_matmul():
    m, k, n = 32, 64, 16
    a, b = torch.ones(m, k), torch.ones(k, n)

    def mm(x, y):
        return x @ y

    assert ttel.model_flops(mm, a, b) == 2 * m * k * n
    assert ttel.model_flops(mm, a, b) == 2 * m * k * n      # memo hit
    assert ttel.cost_flops(mm, a, b) == 2 * m * k * n


def _dense_pair(bs=16, din=32, dout=64):
    w = np.random.RandomState(0).randn(dout, din).astype(np.float32)
    x = np.random.RandomState(1).rand(bs, din).astype(np.float32)
    jnet = jmx.gluon.nn.Dense(dout, in_units=din)
    jnet.initialize()
    jnet.weight.set_data(jmx.np.array(w))
    jx = jmx.np.array(x)
    jnet(jx)
    tnet = tmx.gluon.nn.Dense(dout, in_units=din).initialize(device=CPU)
    tx = tmx.np.array(x, device=CPU)
    tnet(tx)
    return jnet, jx, tnet, tx


def test_block_fwd_flops_dense_against_hand_math_and_jax():
    bs, din, dout = 16, 32, 64
    jnet, jx, tnet, tx = _dense_pair(bs, din, dout)
    got = ttel.block_fwd_flops(tnet, tx)
    assert got == 2 * bs * din * dout          # the product, exactly
    assert ttel.block_fwd_flops(tnet, tx) == got            # memoized
    want = jtel.block_fwd_flops(jnet, jx)      # XLA adds the bias
    assert abs(got - want) / want < 0.10


def test_block_fwd_flops_mlp_and_conv_against_jax():
    rng = np.random.RandomState(2)
    x = rng.rand(4, 8, 8, 3).astype(np.float32)

    def build(m, **kw):
        net = m.gluon.nn.HybridSequential()
        net.add(m.gluon.nn.Conv2D(16, 3, padding=1, layout="NHWC",
                                  in_channels=3),
                m.gluon.nn.Activation("relu"),
                m.gluon.nn.Flatten(),
                m.gluon.nn.Dense(32, activation="relu"),
                m.gluon.nn.Dense(10))
        net.initialize(**kw)
        return net

    jnet = build(jmx)
    jx = jmx.np.array(x)
    jnet(jx)
    tnet = build(tmx, device=CPU)
    tx = tmx.np.array(x, device=CPU)
    tnet(tx)
    got = ttel.block_fwd_flops(tnet, tx)
    hand = 2 * (4 * 8 * 8 * 16 * 3 * 3 * 3 + 4 * 1024 * 32 + 4 * 32 * 10)
    assert got == hand
    want = jtel.block_fwd_flops(jnet, jx)
    assert abs(got - want) / want < 0.10


def test_block_fwd_flops_needs_an_initialized_net():
    net = tmx.gluon.nn.Dense(4)
    net.initialize(device=CPU)
    with pytest.raises(tmx.MXNetError, match="initialized"):
        ttel.block_fwd_flops(net, tmx.np.ones((2, 3), device=CPU))


# ---------------------------------------------------------------------------
# StepTimeline
# ---------------------------------------------------------------------------
def test_steptimeline_mfu_and_stall_attribution():
    def slow_source():
        for i in range(4):
            time.sleep(0.02)
            yield np.full((4, 4), i, np.float32)

    flops, peak = 1e6, 1e9
    tl = ttel.StepTimeline(flops_per_step=flops, peak_flops=peak)
    for batch in tmx.io.DeviceFeed(slow_source(), depth=1, device="cpu"):
        with tl.step():
            float(batch.asnumpy().sum())
    rep = tl.report()
    assert rep["steps"] == 4
    assert rep["data_stall_us"] > 0 and 0 < rep["stall_pct"] <= 100
    assert rep["compute_us"] == pytest.approx(
        rep["total_us"] - rep["data_stall_us"] - rep["allreduce_us"],
        abs=1.0)
    hand = flops * rep["steps"] / (rep["total_us"] * 1e-6) / peak
    assert rep["mfu"] == pytest.approx(hand, rel=0.10)
    assert rep["mem_source"] == "host_rss" and rep["peak_hbm_bytes"] > 0
    # the same keys as the JAX package's report
    jtl = jtel.StepTimeline(flops_per_step=flops, peak_flops=peak)
    with jtl.step():
        pass
    assert set(rep) == set(jtl.report())


def test_steptimeline_without_peak_reports_no_mfu():
    tl = ttel.StepTimeline(flops_per_step=1e6)
    assert tl.peak_flops is None             # the CPU has no peak
    with tl.step():
        time.sleep(0.001)
    rep = tl.report()
    assert "mfu" not in rep and rep["achieved_flops_per_sec"] > 0


# ---------------------------------------------------------------------------
# serving: the timeline's trace ids, metrics_text and the HTTP endpoint
# ---------------------------------------------------------------------------
W = np.linspace(-1, 1, 6).reshape(3, 2).astype(np.float32)


def _servers():
    import jax.numpy as jnp
    tw = torch.from_numpy(W)
    return (jmx.serve.CallableModel(lambda x: jnp.tanh(x @ W), (1, 2),
                                    [((3,), "float32")]),
            tmx.serve.CallableModel(lambda x: torch.tanh(x @ tw), (1, 2),
                                    [((3,), "float32")], device="cpu"))


def test_server_timeline_carries_trace_ids_as_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_SAMPLE", "1")
    expire_port_trace_memo()
    jtel.trace._expire_env_memo()
    jm, tm = _servers()
    rows = {}
    with crash_hooks_restored():
        for name, serve, model in (("jax", jmx.serve, jm),
                                   ("port", tmx.serve, tm)):
            with serve.Server(model, batch_timeout_ms=1.0) as srv:
                for _ in range(4):
                    srv.predict(np.ones(3, np.float32), timeout=30)
                tl = srv.timeline()
                text = srv.metrics_text()
            rows[name] = tl["slowest"]
            assert tl["exec_ms"] > 0 and tl["queue_wait_ms"] >= 0
            assert tl["queue_wait_pct"] + tl["exec_pct"] == pytest.approx(
                100.0, abs=0.1)
            assert "mx_serve_batches" in text
            assert 'mx_server_queue_depth{server="serve"}' in text
    assert [set(r) for r in rows["port"]] == [set(r) for r in rows["jax"]]
    ids = [r["trace_id"] for r in rows["port"]]
    assert len(ids) == 4 and all(ids) and len(set(ids)) == 4


def test_metrics_http_endpoint():
    srv = ttel.start_metrics_server(0)
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "# TYPE mx_span_duration_us histogram" in body
        assert "mx_serve_requests" in body and "mx_dispatch_dispatch" in body
        js = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json",
            timeout=10).read().decode())
        assert "dispatch.dispatch" in js and "fused.pallas_calls" in js
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
    assert not srv.thread.is_alive()


def test_serve_metrics_text_is_the_registry():
    assert tmx.serve.metrics_text() == ttel.metrics_text()
    assert tmx.serve.start_metrics_server is ttel.start_metrics_server


# ---------------------------------------------------------------------------
# the stats groups after the same traffic
# ---------------------------------------------------------------------------
def _family(snap, fam):
    return {k: v for k, v in snap.items()
            if k.startswith(fam + ".") and "{" not in k}


def _delta(before, after, fam):
    a, b = _family(before, fam), _family(after, fam)
    return {k: b[k] - a.get(k, 0) for k in b}


def _traffic_serve(m, model):
    with m.serve.Server(model, batch_timeout_ms=50.0) as srv:
        futs = [srv.submit(np.full(3, i, np.float32)) for i in range(3)]
        for f in futs:
            f.result(timeout=30)
        srv.predict(np.ones(3, np.float32), timeout=30)


def _traffic_feed(m, **kw):
    src = [np.full((2, 2), i, np.float32) for i in range(3)]
    return [b.asnumpy() for b in m.io.DeviceFeed(iter(src), depth=2, **kw)]


def _traffic_imagerec(m, **kw):
    it = m.io.ImageRecordIter(REC, data_shape=(32, 32, 3), batch_size=5,
                              preprocess_threads=2, **kw)
    n = sum(1 for _ in it)
    it.close()
    return n


def _read_io_stats():
    """Both packages' `io_stats()`: the reader gives the decoder's stage
    gauges their children, and an unread gauge is left out of a snapshot,
    so a family compared across the two packages must have been read in
    both, whatever ran earlier in the process."""
    jmx.io.io_stats()
    tmx.io.io_stats()


def _registered(registry, fam):
    return {n for n in registry.names() if n.startswith(fam + ".")}


def test_stats_groups_match_jax_after_the_same_traffic():
    jm, tm = _servers()
    snaps = {}
    with crash_hooks_restored():
        for name, m, model, kw in (("jax", jmx, jm, {}),
                                   ("port", tmx, tm, {"device": "cpu"})):
            tel = jtel if name == "jax" else ttel
            before = tel.snapshot()
            _traffic_feed(m, **kw)
            fed = tel.snapshot()
            _traffic_serve(m, model)
            _traffic_imagerec(m, **kw)
            _read_io_stats()
            a = m.np.ones((2, 2), **kw) + 1
            (a * 2).asnumpy()
            snaps[name] = (before, fed, tel.snapshot())
    (jb, jf, ja), (tb, tf, ta) = snaps["jax"], snaps["port"]
    for fam in ("serve", "io.imagerec", "feed", "fused", "dispatch"):
        jkeys, tkeys = set(_family(ja, fam)), set(_family(ta, fam))
        jreg, treg = (_registered(jtel.REGISTRY, fam),
                      _registered(ttel.REGISTRY, fam))
        if fam == "dispatch":
            # the port keeps only the counters that mean something without
            # bulking (ROADMAP "Deliberate differences")
            assert tkeys and tkeys <= jkeys
            assert treg and treg <= jreg
        else:
            assert tkeys == jkeys, fam
            assert treg == jreg, fam
    jd, td = _delta(jb, ja, "serve"), _delta(tb, ta, "serve")
    for k in ("serve.requests", "serve.replies", "serve.batches",
              "serve.padded_rows", "serve.errors"):
        assert td[k] == jd[k], k
    # the feed's own traffic (the JAX package's record iterator also
    # stages through the feed's device_put, which moves its counters)
    jd, td = _delta(jb, jf, "feed"), _delta(tb, tf, "feed")
    for k in ("feed.batches_fed", "feed.batches_consumed", "feed.epochs",
              "feed.host_transfers", "feed.failures"):
        assert td[k] == jd[k], k
    jd, td = _delta(jb, ja, "io.imagerec"), _delta(tb, ta, "io.imagerec")
    for k in ("io.imagerec.batches", "io.imagerec.images",
              "io.imagerec.failed_records"):
        assert td[k] == jd[k], k
    assert _delta(tb, ta, "dispatch")["dispatch.dispatch"] >= 2
