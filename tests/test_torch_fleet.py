"""PyTorch port: `serve.Fleet` (supervisor + router) over
`serve.replica` processes, the cases of tests/test_fleet.py.

Stub replicas (`{"stub": true}` specs: a deterministic token function of
prompt and version) hold the router and supervisor: derived metrics ports,
prefix affinity, dispatch retry, SIGKILL failover, heartbeat-hung respawn,
a rolling swap that drops nothing, the swap fault and bounded respawns.
One real fleet of two CPU replicas at a tiny `DecoderConfig` must give
the tokens of the port's in-process `ContinuousEngine` built from the same
spec (greedy: exact). Every wait is bounded, and the fixtures kill the
children, which run with OMP_NUM_THREADS=1 and no card.
"""
import os
import signal
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import MXNetError, fault, serve
from incubator_mxnet_tpu_torch.serve import fleet as fleet_mod
from incubator_mxnet_tpu_torch.serve.replica import derive_metrics_port

torch.set_num_threads(1)

CHILD_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}


@pytest.fixture(scope="module", autouse=True)
def _child_env():
    """The replica processes inherit this environment: one OpenMP thread
    each (the suite runs several workers) and no card."""
    old = {k: os.environ.get(k) for k in CHILD_ENV}
    os.environ.update(CHILD_ENV)
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


CFG = dict(vocab=64, embed=32, layers=2, heads=4, head_dim=8, max_len=48)
ENGINE = {"max_slots": 4, "decode_steps": 2, "prefill_window": 16}
STUB_SPEC = {"version": "v1", "stub": True, "stub_delay_ms": 5.0}


def _stub_tokens(prompt, max_new, version):
    """The stub replica's token function (serve.replica._StubEngine)."""
    vtag = sum(version.encode()) % 997
    base = int(np.sum(prompt)) % 997
    return [(base * 31 + i + vtag) % 97 for i in range(max_new)]


def _free_port_base(n=2, tries=50):
    """A base port such that base..base+n-1 are all bindable now."""
    for _ in range(tries):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n >= 65500:
            continue
        ok = True
        for i in range(1, n):
            t = socket.socket()
            try:
                t.bind(("127.0.0.1", base + i))
            except OSError:
                ok = False
            finally:
                t.close()
            if not ok:
                break
        if ok:
            return base
    raise RuntimeError("no two consecutive free ports")


def _wait(pred, timeout, msg):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out after {timeout}s waiting for {msg}")


def _serving(fleet):
    return sum(1 for r in fleet.stats()["replicas"]
               if r["state"] == "serving")


def _kill_children(fleet):
    fleet.close(timeout=10)
    for h in fleet._replicas:
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()
            h.proc.wait(timeout=10)


@pytest.fixture(scope="module")
def stub_fleet(tmp_path_factory):
    """2 stub replicas with a fast heartbeat; MXNET_METRICS_PORT is set
    across start() only, so the children inherit it."""
    base = _free_port_base(2)
    wd = tmp_path_factory.mktemp("stub_fleet")
    old = os.environ.get("MXNET_METRICS_PORT")
    os.environ["MXNET_METRICS_PORT"] = str(base)
    try:
        fleet = serve.Fleet(STUB_SPEC, replicas=2, heartbeat_ms=100,
                            retry_budget=2, drain_timeout_ms=10000,
                            heartbeat_misses=2, max_restarts=2,
                            workdir=str(wd), spawn_timeout=120).start()
    finally:
        if old is None:
            os.environ.pop("MXNET_METRICS_PORT", None)
        else:
            os.environ["MXNET_METRICS_PORT"] = old
    yield fleet, base
    _kill_children(fleet)


def test_metrics_ports_derive_from_env_base_plus_index(stub_fleet):
    fleet, base = stub_fleet
    assert derive_metrics_port(None, 3) is None
    assert derive_metrics_port(9000, 3) == 9003
    ports = {r["replica"]: r["metrics_port"]
             for r in fleet.stats()["replicas"]}
    assert ports == {0: base, 1: base + 1}, ports
    for i, port in ports.items():
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "mx_serve_requests" in txt, f"replica {i} served no metrics"


def test_stub_fleet_serves_and_reports_live_replicas(stub_fleet):
    fleet, _ = stub_fleet
    futs = [fleet.submit([1, 2, 3], max_new_tokens=4) for _ in range(8)]
    for f in futs:
        assert f.result(timeout=30).tolist() == \
            _stub_tokens([1, 2, 3], 4, "v1")
    st = fleet.stats()
    assert st["replicas_live"] == 2 and st["version"] == "v1"
    assert {r["state"] for r in st["replicas"]} == {"serving"}
    assert "mx_fleet_replicas_live 2" in serve.metrics_text()


def test_prefix_affinity_pins_shared_prefix_to_one_replica(stub_fleet):
    fleet, _ = stub_fleet
    prompt = list(range(1, 21))               # 20 tokens = 1 block of 16
    before = serve.fleet_stats()["affinity_hits"]
    for _ in range(4):
        fleet.submit(prompt, max_new_tokens=2).result(timeout=30)
    assert serve.fleet_stats()["affinity_hits"] - before == 3
    before = serve.fleet_stats()["affinity_hits"]
    fleet.submit([1, 2, 3], max_new_tokens=2).result(timeout=30)
    fleet.submit([1, 2, 3], max_new_tokens=2).result(timeout=30)
    assert serve.fleet_stats()["affinity_hits"] == before


def test_dispatch_fault_is_retried_transparently(stub_fleet):
    fleet, _ = stub_fleet
    before = serve.fleet_stats()["retries"]
    with fault.scope("fleet.dispatch:1:error"):
        toks = fleet.submit([5, 6], max_new_tokens=3).result(timeout=30)
        assert fault.hits("fleet.dispatch") >= 1
    assert toks.tolist() == _stub_tokens([5, 6], 3, fleet.version)
    assert serve.fleet_stats()["retries"] >= before + 1


def test_sigkill_failover_reenqueues_inflight_onto_survivor(stub_fleet):
    fleet, _ = stub_fleet
    before = serve.fleet_stats()
    pid0 = fleet.stats()["replicas"][0]["pid"]
    futs = [fleet.submit([9, i], max_new_tokens=4) for i in range(16)]
    os.kill(pid0, signal.SIGKILL)
    for i, f in enumerate(futs):
        assert f.result(timeout=60).tolist() == \
            _stub_tokens([9, i], 4, fleet.version)
    after = serve.fleet_stats()
    assert after["failovers"] >= before["failovers"] + 1
    assert after["retries"] >= before["retries"] + 1
    _wait(lambda: _serving(fleet) == 2, 60, "respawn after SIGKILL")
    assert serve.fleet_stats()["respawns"] >= before["respawns"] + 1
    assert fleet.stats()["replicas"][0]["pid"] != pid0


def test_heartbeat_fault_declares_replica_hung_then_respawns(stub_fleet):
    fleet, _ = stub_fleet
    before = serve.fleet_stats()["respawns"]
    with fault.scope("fleet.heartbeat:1+:error"):
        _wait(lambda: serve.fleet_stats()["respawns"] >= before + 1,
              60, "hung-replica respawn")
        assert fault.hits("fleet.heartbeat") >= 2
    _wait(lambda: _serving(fleet) == 2, 60, "fleet recovery")
    toks = fleet.submit([3], max_new_tokens=2).result(timeout=30)
    assert toks.tolist() == _stub_tokens([3], 2, fleet.version)


def test_rolling_swap_drops_zero_requests_and_flips_version(stub_fleet):
    fleet, _ = stub_fleet
    before = serve.fleet_stats()
    stop, errors, served = threading.Event(), [], [0]

    def pump():
        while not stop.is_set():
            try:
                fleet.submit([2, 7], max_new_tokens=3).result(timeout=60)
                served[0] += 1
            except Exception as e:          # noqa: BLE001 - collected
                errors.append(e)

    t = threading.Thread(target=pump)
    t.start()
    try:
        fleet.swap(dict(STUB_SPEC, version="v2"))
    finally:
        stop.set()
        t.join(timeout=90)
    assert not errors, f"swap dropped {len(errors)}: {errors[:3]}"
    assert served[0] > 0
    assert fleet.version == "v2"
    assert all(r["version"] == "v2" for r in fleet.stats()["replicas"])
    after = serve.fleet_stats()
    assert after["swaps"] == before["swaps"] + 1
    assert after["drain_ms"] > before["drain_ms"]
    toks = fleet.submit([1], max_new_tokens=2).result(timeout=30)
    assert toks.tolist() == _stub_tokens([1], 2, "v2")
    # each drained replica logged its kernel launches (none: stubs)
    for i in range(2):
        with open(os.path.join(fleet._workdir, f"replica{i}.log")) as f:
            assert f"replica {i} launches {{}}" in f.read()


def test_swap_fault_aborts_typed_and_fleet_keeps_serving(stub_fleet):
    fleet, _ = stub_fleet
    with fault.scope("fleet.swap:1:error"):
        with pytest.raises(serve.FleetError, match="aborted at replica"):
            fleet.swap(dict(STUB_SPEC, version="v9"))
    assert fleet.version == "v2"
    _wait(lambda: _serving(fleet) == 2, 60, "recovery after swap abort")
    toks = fleet.submit([4], max_new_tokens=2).result(timeout=30)
    assert toks.tolist() == _stub_tokens([4], 2, "v2")


def test_compile_surface_raises_naming_a3(stub_fleet):
    fleet, _ = stub_fleet
    for fn in (fleet.retraces_after_warmup, fleet.assert_no_retraces):
        with pytest.raises(MXNetError, match="A3"):
            fn()


def test_profile_divergence_is_counted(stub_fleet):
    fleet, _ = stub_fleet
    before = serve.fleet_stats()["profile_divergence"]
    saved = [dict(h.hello) for h in fleet._replicas]
    try:
        for h, ph in zip(fleet._replicas, ("a", "b")):
            h.hello["profile_hash"] = ph
        assert fleet._check_profile_divergence()
    finally:
        for h, hello in zip(fleet._replicas, saved):
            h.hello = hello
    assert serve.fleet_stats()["profile_divergence"] == before + 1
    assert not fleet._check_profile_divergence()


# must stay LAST among the stub cases: replica 0 ends permanently failed
def test_respawn_fault_exhausts_bounded_restarts(stub_fleet):
    fleet, _ = stub_fleet
    pid0 = fleet.stats()["replicas"][0]["pid"]
    with fault.scope("fleet.respawn:1+:error"):
        os.kill(pid0, signal.SIGKILL)
        _wait(lambda: fleet.stats()["replicas"][0]["state"] == "failed",
              60, "replica 0 to exhaust its restart budget")
        assert fault.hits("fleet.respawn") >= 2
    assert fleet.stats()["replicas"][0]["consecutive_restarts"] > 2
    toks = fleet.submit([6], max_new_tokens=2).result(timeout=30)
    assert toks.tolist() == _stub_tokens([6], 2, fleet.version)
    assert serve.fleet_stats()["replicas_live"] == 1


def test_fleet_stats_and_replica_states_surface():
    snap = fleet_mod.fleet_stats()
    assert set(snap) == set(fleet_mod.FLEET_STATS)
    assert set(fleet_mod.REPLICA_STATES) == {"dead", "spawning", "serving",
                                             "draining", "failed"}


def test_real_cpu_fleet_matches_the_in_process_engine(tmp_path):
    spec = {"version": "v1", "config": CFG, "seed": 0, "engine": ENGINE,
            "device": "cpu"}
    prompts = [[3, 1, 4, 1], [5, 9, 2], [6, 5, 3, 5, 8], [2, 7],
               list(range(1, 21))]
    model = serve.CachedDecoder(serve.DecoderConfig(**CFG), seed=0,
                                device="cpu")
    with serve.ContinuousEngine(model, **ENGINE) as eng:
        want = [eng.submit(p, 6).result(timeout=120) for p in prompts]
        # what the replica's heartbeat reads: idle, no prefix cache
        assert eng.queue_depth() == (0, 0)
        assert eng.prefix_hit_count() == 0
    fleet = serve.Fleet(spec, replicas=2, heartbeat_ms=250,
                        workdir=str(tmp_path), spawn_timeout=120)
    try:
        fleet.start()
        futs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        for p, f, w in zip(prompts, futs, want):
            np.testing.assert_array_equal(
                f.result(timeout=120), w,
                err_msg=f"fleet output diverged for prompt {p}")
        reps = fleet.stats()["replicas"]
        assert all(r["warmup_s"] is not None and r["warmup_s"] > 0
                   for r in reps)
        assert all(r["metrics_port"] is None for r in reps)
    finally:
        _kill_children(fleet)
    for i in range(2):
        with open(tmp_path / f"replica{i}.log") as f:
            assert f"replica {i} launches" in f.read()


def test_replica_spec_without_a_card_raises():
    """A spec names no device: its engine goes to the card, and without
    one the replica fails to start rather than serve on the CPU."""
    from incubator_mxnet_tpu_torch.serve import replica
    with pytest.raises(MXNetError):
        replica._build_engine({"version": "v1", "config": CFG, "seed": 0})
