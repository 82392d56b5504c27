"""PyTorch port: `mx.inspect.memory` and the profiler's memory lane held
against the JAX package's, on the CPU.

Covered: `tag` / `register` / `current_tag` and owner validation, the
weak-reference registry's life cycle, `census` attribution over CPU
tensors (storage bytes, a storage counted once), `census_diff`,
`leakcheck` catching a planted per-round leak and passing a clean loop,
`is_oom_error` on PyTorch's and the JAX package's errors (the same
verdicts as the JAX package's where both see the same message),
`on_oom` / `dump_oom` writing the black box (the JAX package's top-level
keys plus `memory_stats` on a card), the A2/A3/A10 refusals of the
program-reading functions, `read_memory_sample` and `MemoryMonitor` on
the host (whose `stop()` joins its thread), the `StepTimeline` memory
lane, and the report keys against the JAX package's.

Every test leaves the process as it found it
(`torch_port_utils.process_state_kept`).
"""
import gc
import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.inspect import memory as jmem
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.inspect import memory as mem

from torch_port_utils import (crash_hooks_restored, expire_port_trace_memo,
                              process_state_kept)

torch.set_num_threads(1)

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _fresh_port_trace_env_memo():
    expire_port_trace_memo()
    yield
    expire_port_trace_memo()


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    with process_state_kept():
        yield


# ---------------------------------------------------------------------------
# ownership and the census
# ---------------------------------------------------------------------------
def test_register_tag_and_census_attribution():
    a = torch.zeros(1000, dtype=torch.float32)          # 4000 bytes
    b = torch.zeros(64, 64, dtype=torch.bfloat16)       # 8192 bytes
    nd = tmx.np.zeros((10, 10), dtype="float32", device=CPU)
    mem.register({"w": a, "list": [nd]}, owner="trainer_state")
    with mem.tag("feed_slots"):
        assert mem.current_tag() == "feed_slots"
        assert mem.register(b) is b
        with mem.tag("inner"):
            assert mem.current_tag() == "inner"
        assert mem.current_tag() == "feed_slots"
    assert mem.current_tag() is None
    view = a[10:20]
    mem.register(view, owner="views")        # a's storage: counted once
    untagged = torch.ones(300)                                # noqa: F841
    c = mem.census(device="cpu")
    own = c["owners"]
    assert own["trainer_state"]["bytes"] == 4000 + 400
    assert own["trainer_state"]["count"] == 2
    assert own["feed_slots"]["bytes"] == 8192
    assert "bfloat16[64, 64]" in own["feed_slots"]["shapes"]
    assert "views" not in own
    assert c["tagged_bytes"] == 4000 + 400 + 8192
    assert c["untagged_bytes"] == c["total_bytes"] - c["tagged_bytes"] > 0
    assert list(own)[0] == max(own, key=lambda k: own[k]["bytes"])
    assert c["device"] == "cpu"
    # the JAX package's report keys, and its registry gauges moved
    assert set(c) - {"device"} == {"owners", "total_bytes", "tagged_bytes",
                                   "untagged_bytes", "tagged_fraction",
                                   "n_arrays"}
    snap = ttel.snapshot()
    assert snap["mem.tagged_bytes"] == c["tagged_bytes"]
    assert snap["mem.untagged_bytes"] == c["untagged_bytes"]
    assert snap["mem.census_runs"] >= 1


def test_register_owner_validation_and_weakref_lifecycle():
    for bad in ("Bad.Owner", "dots.here", "", None, 3):
        with pytest.raises(tmx.MXNetError):
            mem.register(torch.zeros(2), owner=bad)
    with pytest.raises(tmx.MXNetError, match="owner"):
        mem.register(torch.zeros(2))
    gc.collect()
    n0 = mem.registered_count()
    t = torch.zeros(16)
    mem.register(t, owner="short_lived")
    assert mem.registered_count() == n0 + 1
    del t
    gc.collect()
    assert mem.registered_count() == n0
    # odd leaves are skipped, never an error
    mem.register({"s": "text", "n": 3, "none": None}, owner="odd")


def test_parameters_register_through_their_block():
    net = tmx.gluon.nn.Dense(8, in_units=4)
    net.initialize(device=CPU)
    mem.register(net.collect_params(), owner="params")
    c = mem.census(device="cpu")
    assert c["owners"]["params"]["bytes"] == (8 * 4 + 8) * 4


def test_census_diff():
    a = {"owners": {"x": {"count": 1, "bytes": 10}},
         "total_bytes": 30, "untagged_bytes": 20}
    b = {"owners": {"x": {"count": 2, "bytes": 25},
                    "y": {"count": 1, "bytes": 5}},
         "total_bytes": 60, "untagged_bytes": 30}
    d = mem.census_diff(a, b)
    assert d == jmem.census_diff(a, b)
    assert d["owners"] == {"x": {"bytes": 15, "count": 1},
                           "y": {"bytes": 5, "count": 1}}
    assert d["total_bytes"] == 30 and d["untagged_bytes"] == 10


def test_leakcheck_catches_a_planted_leak_and_passes_a_clean_loop():
    leaked = []

    def leaky():
        leaked.append(torch.zeros(64 * 1024))       # 256 KiB a round

    with pytest.raises(mem.MemoryLeakError) as ei:
        mem.leakcheck(leaky, rounds=4, device="cpu")
    rep = ei.value.report
    assert rep["leak"] and rep["growth_bytes"] >= 3 * 256 * 1024
    leaked.clear()

    def clean():
        x = torch.zeros(64 * 1024)
        return float(x.sum())

    rep = mem.leakcheck(clean, rounds=4, device="cpu")
    assert not rep["leak"]
    assert set(rep) == {"rounds", "leak", "untagged_bytes", "total_bytes",
                        "baseline_untagged_bytes", "growth_bytes",
                        "growth_mb", "per_round_bytes"}
    with pytest.raises(tmx.MXNetError):
        mem.leakcheck(clean, rounds=1)


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------
OOM_CASES = [
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                  "allocate 1.00GiB"), True),
    (RuntimeError("resource exhausted: hbm"), True),
    (MemoryError(), True),
    (RuntimeError("allocation failure in pool"), True),
    (ValueError("shape mismatch"), False),
    (KeyError("x"), False),
    (None, False),
]


@pytest.mark.parametrize("i", range(len(OOM_CASES)))
def test_is_oom_error_as_jax(i):
    err, want = OOM_CASES[i]
    assert mem.is_oom_error(err) is want
    assert jmem.is_oom_error(err) is want


def test_is_oom_error_knows_torchs_errors():
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "80.00 GiB (GPU 0; 79.10 GiB total)")
    assert mem.is_oom_error(err)
    assert mem.is_oom_error(RuntimeError("CUDA out of memory."))
    assert not mem.is_oom_error(RuntimeError("CUDA error: misaligned "
                                             "address"))


def test_on_oom_dump_names_the_top_owner(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_MEM_OOM_DUMP", str(tmp_path))
    big = torch.zeros(256 * 1024)
    mem.register(big, owner="kv_pool")
    with crash_hooks_restored():
        ttel.flightrec_record("test", "before.oom")
        before = ttel.snapshot().get("mem.oom_dumps", 0)
        err = torch.OutOfMemoryError("CUDA out of memory.")
        path = mem.on_oom(err, where="unit")
        assert path == str(tmp_path / f"oomdump-{os.getpid()}.json")
        assert ttel.snapshot()["mem.oom_dumps"] == before + 1
        assert any(e["kind"] == "oom" for e in ttel.flightrec_events())
    with open(path) as f:
        rep = json.load(f)
    assert rep["reason"] == "unit" and "out of memory" in rep["error"]
    assert rep["memory_source"] == "host_rss"
    assert list(rep["census"]["owners"])  # the top owners by bytes
    assert rep["census"]["owners"]["kv_pool"]["bytes"] == 1024 * 1024
    assert any(e["name"] == "before.oom" for e in rep["flightrec"])
    # the JAX package's keys (a card adds device_memory, memory_stats)
    assert {"pid", "error", "census", "plans", "bytes_in_use",
            "memory_source", "flightrec", "reason"} <= set(rep)
    # not an OOM: nothing written; dumps off: nothing written
    assert mem.on_oom(ValueError("x")) is None
    monkeypatch.setenv("MXNET_MEM_OOM_DUMP", "0")
    assert mem.on_oom(err) is None
    assert ttel.mem_on_oom(err) is None


def test_mem_on_oom_never_raises(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("census broke")

    monkeypatch.setattr(mem, "on_oom", boom)
    assert ttel.mem_on_oom(MemoryError()) is None


@pytest.mark.parametrize("fn,queue", [
    (lambda: mem.memory_plan(object()), "A2/A3"),
    (lambda: mem.plan_from_compiled(object()), "A2/A3"),
    (lambda: mem.assert_donation({"source": "memory_analysis"}, 1), "A2/A3"),
    (lambda: mem.collective_memory_plans(), "A10"),
])
def test_program_reading_functions_name_their_queue(fn, queue):
    with pytest.raises(tmx.MXNetError, match=queue):
        fn()


def test_active_plans_table_is_bounded():
    saved = mem.active_plans()
    try:
        for i in range(40):
            mem.note_plan(f"p{i}", {"peak_bytes": i})
        plans = mem.active_plans()
        assert len(plans) == 32 and "p39" in plans and "p0" not in plans
    finally:
        with mem._plans_lock:
            mem._ACTIVE_PLANS.clear()
            mem._ACTIVE_PLANS.update(saved)


# ---------------------------------------------------------------------------
# the profiler's memory lane
# ---------------------------------------------------------------------------
def test_read_memory_sample_on_the_host():
    b, source = tprof.read_memory_sample()
    assert source == "host_rss" and b > 0
    assert tprof.read_memory_sample("cpu")[1] == "host_rss"


def test_memory_monitor_samples_and_joins_its_thread(fresh_peak):
    tprof._events.clear()
    mon = tprof.MemoryMonitor(interval=0.005).start()
    x = torch.zeros(1 << 20)
    import time
    time.sleep(0.05)
    mon.stop()
    assert mon._thread is None
    assert len(mon.samples) >= 2 and mon.source == "host_rss"
    assert mon.peak_bytes >= x.numel()
    lane = [e for e in tprof._events if e["name"] == "device_memory"]
    assert len(lane) == len(mon.samples) and lane[0]["ph"] == "C"
    assert lane[0]["args"]["source"] == "host_rss"
    with tprof.MemoryMonitor(interval=0.005) as mon2:
        pass
    assert mon2._thread is None
    tprof._events.clear()
    assert ttel.snapshot()["mem.peak_hbm_bytes"] >= mon.peak_bytes


def test_dump_storage_profile_needs_a_card(tmp_path):
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        tprof.dump_storage_profile(str(tmp_path / "m.pickle"))


@pytest.fixture
def fresh_peak():
    """The process-wide high-water cell behind mem.peak_hbm_bytes, from 0
    (the registry itself is put back by the autouse fixture)."""
    from incubator_mxnet_tpu_torch.telemetry import steptrace
    saved = steptrace._mem_peak_seen[0]
    steptrace._mem_peak_seen[0] = 0
    yield
    steptrace._mem_peak_seen[0] = saved


def test_steptimeline_memory_lane(fresh_peak):
    tl = ttel.StepTimeline()
    for _ in range(2):
        with tl.step():
            torch.zeros(1024).sum()
    rep = tl.report()
    assert rep["peak_hbm_bytes"] > 0 and rep["mem_source"] == "host_rss"
    assert ttel.snapshot()["mem.peak_hbm_bytes"] >= rep["peak_hbm_bytes"]


def test_registry_metrics_are_the_jax_packages():
    for name in ("mem.plans", "mem.census_runs", "mem.tagged_bytes",
                 "mem.untagged_bytes", "mem.oom_dumps"):
        tm = ttel.REGISTRY._metrics[name]
        from incubator_mxnet_tpu.telemetry import REGISTRY as jreg
        jm = jreg._metrics[name]
        assert (tm.kind, tm.help) == (jm.kind, jm.help)
    assert mem.MEM_PLANS.get() == 0 or mem.MEM_PLANS.get() >= 0
    x = np.zeros(3)
    assert mem.register(x, owner="numpy_leaf") is x     # skipped quietly
