"""PyTorch port: mx.fault — fault injection, crash-consistent checkpoint
commits, retry / watchdog, the auto-resume training driver, and the fault
points wired through io, gluon.data and the decode engine, on the CPU.

The counterpart of each case of tests/test_fault.py that applies to one
process on one device (the halved-mesh resume, the kvstore points and the
estimator wait for the port's mesh, A10, and estimator, A4), from the same
inputs; plus the port's own: `engine.flush` never fires (the port runs every
op eagerly), the engine's `serve.enqueue` / `serve.execute` drills, a real
SIGKILL through tools/torch_crashtest.py (not slow-marked: a tiny LM, each
child ~5 s), and the in-place guard: a skipped or retried step of the LM
leaves its input state bit-equal. Fault rules are process-global in both
packages: every test here runs with the port's registry cleared and puts
both packages' state back (`torch_port_utils.port_faults_cleared`).
"""
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import checkpoint as ckpt
from incubator_mxnet_tpu_torch import fault
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch.models import transformer as tf

from torch_port_utils import port_faults_cleared

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _clean_faults():
    with port_faults_cleared():
        yield


# ---------------------------------------------------------------------------
# spec / registry
# ---------------------------------------------------------------------------
def test_spec_parsing():
    rules = fault.parse_spec(
        "checkpoint.save:2:ioerror, a.b:3+:stall:0.5 ,x:*:nan")
    assert [(r.point, r.at, r.persistent, r.kind) for r in rules] == [
        ("checkpoint.save", 2, False, "ioerror"),
        ("a.b", 3, True, "stall"),
        ("x", 1, True, "nan")]
    assert rules[1].arg == "0.5"
    with pytest.raises(mx.MXNetError):
        fault.parse_spec("missing.kind:1")
    with pytest.raises(mx.MXNetError):
        fault.parse_spec("p:1:frobnicate")


def test_spec_parsing_equals_jax():
    from incubator_mxnet_tpu import fault as jfault
    spec = "checkpoint.save:2:ioerror,a.b:3+:stall:0.5,x:*:nan,k:4:kill"
    assert [repr(r) for r in fault.parse_spec(spec)] == \
        [repr(r) for r in jfault.parse_spec(spec)]
    assert fault.POINTS == jfault.POINTS
    assert fault._KINDS == jfault._KINDS


def test_inject_nth_hit_only():
    fault.install("demo.point", "ioerror", at=2)
    fault.inject("demo.point")  # hit 1: no fire
    with pytest.raises(IOError):
        fault.inject("demo.point")  # hit 2
    fault.inject("demo.point")  # hit 3: non-persistent rule is done
    assert fault.hits("demo.point") == 3


def test_scope_restores_rules():
    with fault.scope("p:1:error"):
        assert len(fault.active_rules()) == 1
        with pytest.raises(fault.InjectedFault):
            fault.inject("p")
    assert fault.active_rules() == []
    fault.inject("p")  # disarmed


@pytest.mark.parametrize("kind,exc", [("ioerror", IOError),
                                      ("oserror", OSError),
                                      ("error", fault.InjectedFault),
                                      ("timeout", TimeoutError)])
def test_every_raising_kind(kind, exc):
    with fault.scope(f"p:1:{kind}"):
        with pytest.raises(exc, match="injected"):
            fault.inject("p")


def test_nan_kind_poisons_tensors_ndarrays_and_scalars():
    with fault.scope("p:*:nan"):
        t = fault.inject("p", torch.ones(3))
        assert isinstance(t, torch.Tensor) and torch.isnan(t).all()
        nd = fault.inject("p", mx.np.ones((2,), device=CPU))
        assert isinstance(nd, mx.NDArray) and np.isnan(nd.asnumpy()).all()
        assert np.isnan(fault.inject("p", 1.5))
        assert np.isnan(fault.inject("p", torch.tensor(2.0)))
        assert np.isnan(fault.inject("p", np.ones(2))).all()


def test_stall_kind_sleeps_and_returns_the_value():
    with fault.scope("p:1:stall:0.05"):
        t0 = time.time()
        assert fault.inject("p", 7) == 7
        assert time.time() - t0 >= 0.05


def test_env_spec_is_read_once_lazily(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_SPEC", "checkpoint.load:2:ioerror")
    # a fresh registry (as at import) reads the variable at the first use
    with fault._lock:
        fault._env_loaded = False
    assert [r.point for r in fault.active_rules()] == ["checkpoint.load"]
    fault.inject("checkpoint.load")
    with pytest.raises(IOError):
        fault.inject("checkpoint.load")
    # clear() disarms and does NOT re-read the variable
    fault.clear()
    assert fault.active_rules() == []


def test_engine_flush_never_fires():
    # the port's engine runs every op eagerly: there is no bulked segment
    # to flush, so an armed engine.flush rule is never hit
    with fault.scope("engine.flush:*:ioerror"):
        with mx.cpu():
            a = mx.np.ones((4,))
            b = (a + 1) * 2
            mx.waitall()
            b.wait_to_read()
        np.testing.assert_array_equal(b.asnumpy(), np.full(4, 4.0))
        assert fault.hits("engine.flush") == 0


def test_the_jax_fault_state_is_put_back():
    """The hygiene helper: rules armed in both packages inside the block
    are gone after it, and the JAX package's state is as before."""
    from incubator_mxnet_tpu import fault as jfault
    from torch_port_utils import jax_fault_restored
    before = (list(jfault._rules), dict(jfault._hit_counts),
              jfault._env_loaded)
    with port_faults_cleared():
        jfault.install("x.y", "ioerror")
        fault.install("x.y", "ioerror")
        with pytest.raises(IOError):
            jfault.inject("x.y")
        with pytest.raises(IOError):
            fault.inject("x.y")
    with jax_fault_restored():
        jfault.install("z", "error")
    assert (list(jfault._rules), dict(jfault._hit_counts),
            jfault._env_loaded) == before
    assert fault.active_rules() == []


# ---------------------------------------------------------------------------
# the environment-flag layer fault reads MXNET_FAULT_SPEC through
# ---------------------------------------------------------------------------
def test_env_flags_get_env_set_env_as_jax(monkeypatch):
    import incubator_mxnet_tpu as jmx
    # the JAX package registers a module's knobs when that module is first
    # imported, and the port registers some of the same knobs sooner: load
    # the JAX modules whose knobs the port has, so that both tables are
    # whole whatever ran earlier in the process
    import incubator_mxnet_tpu.serve  # noqa: F401
    import incubator_mxnet_tpu.inspect.report  # noqa: F401
    flags = mx.env_flags()
    jflags = jmx.env_flags()
    for name, entry in flags.items():       # type and default
        assert jflags[name][:2] == entry[:2], name
    for name in ("MXNET_PREFETCH_RESTARTS", "MXNET_DATALOADER_RETRIES",
                 "MXNET_DEVICE_FEED_DEPTH", "MXNET_PREFETCH_TO_DEVICE"):
        monkeypatch.delenv(name, raising=False)
        assert mx.get_env(name) == jmx.get_env(name) == flags[name][1]
    monkeypatch.setenv("MXNET_DATALOADER_RETRIES", "7")
    assert mx.get_env("MXNET_DATALOADER_RETRIES") == 7
    monkeypatch.setenv("MXNET_PREFETCH_TO_DEVICE", "0")
    assert mx.get_env("MXNET_PREFETCH_TO_DEVICE") is False
    assert mx.get_env("MXNET_UNREGISTERED_KNOB", "d") == "d"
    monkeypatch.delenv("MXNET_SET_ENV_PROBE", raising=False)
    mx.set_env("MXNET_SET_ENV_PROBE", 3)
    assert os.environ["MXNET_SET_ENV_PROBE"] == "3"
    monkeypatch.delenv("MXNET_SET_ENV_PROBE")


# ---------------------------------------------------------------------------
# crash-consistent checkpoints
# ---------------------------------------------------------------------------
def test_atomic_save_checkpoint_preserves_previous(tmp_path):
    p = ckpt.save_checkpoint(str(tmp_path / "c"), {"w": np.arange(4.)},
                             step=5)
    with fault.scope("checkpoint.save:1:ioerror"):
        with pytest.raises(IOError):
            ckpt.save_checkpoint(p, {"w": np.zeros(4)}, step=9)
    params, step = ckpt.load_checkpoint(p, device=CPU)
    assert step == 5
    np.testing.assert_array_equal(params["w"].asnumpy(), np.arange(4.))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_load_checkpoint_missing_raises_clear_error(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(mx.MXNetError, match="nope.npz"):
        ckpt.load_checkpoint(missing)
    # the raw path must be listed too
    with pytest.raises(mx.MXNetError, match="tried"):
        ckpt.load_checkpoint(missing)


def test_ioerror_mid_save_sharded_preserves_latest_step(tmp_path):
    d = str(tmp_path / "sh")
    ckpt.save_sharded(d, {"w": torch.arange(8.)}, step=1)
    assert ckpt.latest_step(d) == 1
    with fault.scope("checkpoint.save_sharded:1:ioerror"):
        with pytest.raises(IOError):
            ckpt.save_sharded(d, {"w": torch.zeros(8)}, step=2)
    # the crashed save is invisible: manifest still points at step 1 ...
    assert ckpt.latest_step(d) == 2 - 1
    tree, step = ckpt.load_sharded(d, device="cpu")
    assert step == 1
    np.testing.assert_array_equal(tree["w"].numpy(), np.arange(8.))
    # ... and the next save garbage-collects the orphaned partial
    ckpt.save_sharded(d, {"w": torch.full((8,), 3.0)}, step=3)
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert ckpt.latest_step(d) == 3


def test_sharded_retention_keep_last(tmp_path):
    d = str(tmp_path / "sh")
    for s in (1, 2, 3, 4):
        ckpt.save_sharded(d, {"w": torch.full((4,), float(s))}, step=s,
                          keep_last=2)
    assert ckpt.latest_step(d) == 4
    kept = sorted(n for n in os.listdir(d) if n.isdigit())
    assert kept == ["3", "4"]
    # evicted steps are gone from the manifest, not just the filesystem
    with open(os.path.join(d, ckpt.MANIFEST_NAME)) as f:
        assert [e["step"] for e in json.load(f)["committed"]] == [3, 4]
    tree, step = ckpt.load_sharded(d, device="cpu")
    assert step == 4
    np.testing.assert_array_equal(tree["w"].numpy(), np.full(4, 4.0))


def test_sharded_round_trip_keeps_kinds_dtypes_and_structure(tmp_path):
    d = str(tmp_path / "sh")
    g = torch.Generator().manual_seed(0)
    tree = {"layers": [{"w": torch.randn(3, 4, generator=g)},
                       {"w": torch.randn(3, 4, generator=g).bfloat16()}],
            "opt": (torch.zeros(2, dtype=torch.int32), np.arange(3.0)),
            "nd": mx.np.array(np.ones((2, 2), np.float32), device=CPU),
            "step": 7, "lr": 0.25, "none": None}
    ckpt.save_sharded(d, tree, step=5)
    got, step = ckpt.load_sharded(d, device="cpu")
    assert step == 5 and got["step"] == 7 and got["lr"] == 0.25 \
        and got["none"] is None
    assert isinstance(got["opt"], tuple) and isinstance(got["opt"][1],
                                                        np.ndarray)
    assert isinstance(got["nd"], mx.NDArray)
    for a, b in ((got["layers"][0]["w"], tree["layers"][0]["w"]),
                 (got["layers"][1]["w"], tree["layers"][1]["w"]),
                 (got["opt"][0], tree["opt"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(got["opt"][1], tree["opt"][1])
    # with a target: each leaf takes the target's dtype; a mismatch raises
    like = {**tree, "layers": [{"w": torch.zeros(3, 4, dtype=torch.float64)},
                               {"w": torch.zeros(3, 4)}]}
    got, _ = ckpt.load_sharded(d, target=like)
    assert got["layers"][0]["w"].dtype == torch.float64
    with pytest.raises(mx.MXNetError, match="shape"):
        ckpt.load_sharded(d, target={**like, "layers": [
            {"w": torch.zeros(4, 4)}, {"w": torch.zeros(3, 4)}]})
    with pytest.raises(mx.MXNetError, match="dict"):
        ckpt.load_sharded(d, target={"other": 1})


def test_atomic_output_commits_whole_files_only(tmp_path):
    target = tmp_path / "f.bin"
    target.write_bytes(b"old")
    with pytest.raises(RuntimeError):
        with fault.atomic_output(str(target)) as f:
            f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert target.read_bytes() == b"old"
    assert os.listdir(tmp_path) == ["f.bin"]       # no temp file left
    with fault.atomic_output(str(target), mode="w") as f:
        f.write("new")
    assert target.read_bytes() == b"new"


@pytest.mark.parametrize("loss,finite", [
    (None, True), (1.5, True), (float("inf"), False),
    (np.array([1.0, np.nan]), False), (torch.tensor(2.0), True),
    (torch.tensor([1.0, float("-inf")]), False),
    ([torch.tensor(1.0), 3.0], True), ([1.0, (2.0, float("nan"))], False),
    ("ndarray-nan", False), ("ndarray", True)])
def test_loss_is_finite_on_every_kind(loss, finite):
    if isinstance(loss, str):
        v = np.array([1.0, np.nan if loss.endswith("nan") else 2.0],
                     np.float32)
        loss = mx.np.array(v, device=CPU)
    assert fault.loss_is_finite(loss) is finite


def test_commit_gc_removes_atomic_output_orphans(tmp_path):
    # a SIGKILL between mkstemp and os.replace leaves a '.<name>*.tmp'
    # file; the next commit must garbage-collect it
    d = tmp_path / "npz"
    d.mkdir()
    orphan = d / ".ckpt-2.npzab12cd.tmp"
    orphan.write_bytes(b"partial")
    ckpt.save_checkpoint(str(d / "ckpt-1"), {"w": np.ones(2)}, step=1)
    ckpt.commit_step(str(d), 1, kind="npz", path="ckpt-1.npz")
    assert not orphan.exists()
    assert ckpt.latest_step(str(d)) == 1


def test_latest_step_legacy_dir_without_manifest(tmp_path):
    d = tmp_path / "legacy"
    (d / "7").mkdir(parents=True)
    (d / "12").mkdir()
    assert ckpt.latest_step(str(d)) == 12


def test_mesh_only_paths_raise_naming_a10(tmp_path):
    with pytest.raises(mx.MXNetError, match="A10"):
        ckpt.rescale_sharded(str(tmp_path), mesh=object(), specs=None)
    with pytest.raises(mx.MXNetError, match="A10"):
        fault.run_resilient(_step_fn, _state(), str(tmp_path / "m"), 2,
                            mesh=object())
    assert repr(ckpt.Repartition(4)) == "Repartition(numel=4, axis='dp')"


# ---------------------------------------------------------------------------
# retry / watchdog
# ---------------------------------------------------------------------------
def test_retrying_recovers_then_exhausts():
    calls = []

    @fault.retrying(max_attempts=3, backoff=0.001)
    def flaky(fail_times):
        calls.append(1)
        if len(calls) <= fail_times:
            raise IOError("transient")
        return "ok"

    assert flaky(2) == "ok"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(IOError):
        flaky(99)
    assert len(calls) == 3  # bounded


def test_retrying_on_retry_name_and_backoff_cap(caplog, monkeypatch):
    slept, seen = [], []
    monkeypatch.setattr(fault.time, "sleep", slept.append)

    @fault.retrying(max_attempts=5, backoff=0.5, max_backoff=1.0,
                    name="demo.fetch",
                    on_retry=lambda a, e: seen.append((a, str(e))))
    def always():
        raise TimeoutError("slow")

    with caplog.at_level(logging.INFO, logger="incubator_mxnet_tpu_torch"
                         ".fault"):
        with pytest.raises(TimeoutError):
            always()
    assert slept == [0.5, 1.0, 1.0, 1.0]
    assert seen == [(1, "slow"), (2, "slow"), (3, "slow"), (4, "slow")]
    msgs = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("fault.retry ") for m in msgs) == 4
    assert any(m.startswith("fault.retry_exhausted")
               and '"point": "demo.fetch"' in m for m in msgs)
    # attempts count calls: 0 is clamped to one call
    calls = []
    fault.retrying(max_attempts=0)(lambda: calls.append(1))()
    assert calls == [1]


def test_watchdog_aborts_stalled_region():
    t0 = time.time()
    with pytest.raises(fault.WatchdogTimeout):
        with fault.watchdog(0.2):
            time.sleep(5)
    assert time.time() - t0 < 2.0


def test_watchdog_noop_when_fast():
    with fault.watchdog(5.0):
        pass


def test_watchdog_nesting_restores_outer_timer():
    # an inner watchdog must not disarm the outer one (run_resilient's
    # per-step watchdog nests around a caller's)
    t0 = time.time()
    with pytest.raises(fault.WatchdogTimeout, match="outer"):
        with fault.watchdog(0.4, "outer"):
            with fault.watchdog(0.2):
                pass  # fast inner region
            time.sleep(5)  # outer deadline must still fire
    assert time.time() - t0 < 2.0


def test_watchdog_off_the_main_thread_is_cooperative():
    import threading
    out = []

    def body():
        try:
            with fault.watchdog(0.05):
                time.sleep(0.2)
        except fault.WatchdogTimeout as e:
            out.append(e)

    th = threading.Thread(target=body)
    th.start()
    th.join()
    assert len(out) == 1


# ---------------------------------------------------------------------------
# PrefetchingIter / DeviceFeed / DataLoader / ImageRecordIter failures
# ---------------------------------------------------------------------------
class _FlakyIter(tio.DataIter):
    """Yields `n` batches; raises `exc` when the cursor reaches `fail_at`
    (once per epoch unless `always`)."""

    def __init__(self, n=6, fail_at=None, exc=IOError, always=False):
        super().__init__(batch_size=2)
        self.n, self.fail_at, self.exc, self.always = n, fail_at, exc, always
        self.i = 0
        self.fired = False

    def reset(self):
        self.i, self.fired = 0, False

    def next(self):
        if (self.fail_at is not None and self.i == self.fail_at
                and (self.always or not self.fired)):
            self.fired = True
            raise self.exc(f"boom at {self.i}")
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return tio.DataBatch(
            data=[mx.np.array(np.full((2, 3), self.i), device=CPU)],
            label=None)


def test_prefetching_iter_reraises_worker_exception():
    # a non-transient worker death must raise in the consumer, not end the
    # epoch silently (the reference's thread just died)
    it = tio.PrefetchingIter(_FlakyIter(fail_at=2, exc=ValueError,
                                        always=True))
    got = []
    with pytest.raises(ValueError, match="boom"):
        for batch in it:
            got.append(batch)
    assert len(got) == 2


def test_prefetching_iter_restarts_on_transient_error():
    # one transient IOError mid-epoch: bounded in-place restart delivers
    # every remaining batch
    it = tio.PrefetchingIter(_FlakyIter(n=6, fail_at=3, exc=IOError))
    assert len(list(it)) == 6


def test_prefetching_iter_transient_budget_exhausts():
    it = tio.PrefetchingIter(_FlakyIter(n=6, fail_at=3, exc=IOError,
                                        always=True), max_restarts=2)
    with pytest.raises(IOError):
        list(it)


def test_prefetching_iter_normal_epoch_and_reset():
    src = _FlakyIter(n=4)
    it = tio.PrefetchingIter(src)
    assert len(list(it)) == 4
    it.reset()
    assert len(list(it)) == 4


def test_io_prefetch_injected_transient_fault_restarts_in_place(caplog):
    # the worker injects io.prefetch BEFORE each fetch; one transient hit
    # must burn a restart from the budget, not a batch from the source
    it = tio.PrefetchingIter(_FlakyIter(n=5))
    with caplog.at_level(logging.INFO,
                         logger="incubator_mxnet_tpu_torch.fault"):
        with fault.scope("io.prefetch:2:ioerror"):
            got = list(it)
            assert fault.hits("io.prefetch") >= 2  # the failed hit + retry
    assert len(got) == 5
    assert [b.data[0].asnumpy()[0, 0] for b in got] == [1, 2, 3, 4, 5]
    assert any(r.getMessage().startswith("io.prefetch_restart")
               for r in caplog.records)


def test_io_prefetch_persistent_fault_exhausts_restart_budget():
    it = tio.PrefetchingIter(_FlakyIter(n=5), max_restarts=1)
    with fault.scope("io.prefetch:*:ioerror"):
        with pytest.raises(IOError):
            list(it)


def _host_batches(n):
    return [(np.full((2, 3), i, np.float32), np.array([i, i], np.int32))
            for i in range(n)]


def test_io_device_feed_transient_fault_keeps_every_batch():
    clean = [tuple(t._t.clone() for t in b)
             for b in tio.DeviceFeed(_host_batches(5), device=CPU)]
    with fault.scope("io.device_feed:2:ioerror"):
        feed = tio.DeviceFeed(_host_batches(5), device=CPU, max_restarts=2)
        got = [tuple(t._t.clone() for t in b) for b in feed]
        feed.close()
    assert len(got) == len(clean) == 5
    assert all(torch.equal(a, b) for g, c in zip(got, clean)
               for a, b in zip(g, c))
    assert tio.feed_stats()["restarts"] >= 1


def test_io_device_feed_persistent_fault_raises_the_original_error():
    with fault.scope("io.device_feed:2+:ioerror"):
        feed = tio.DeviceFeed(_host_batches(5), device=CPU, max_restarts=2)
        with pytest.raises(IOError, match="io.device_feed"):
            list(feed)
        feed.close()


def test_io_imagerec_transient_fault_batches_bit_equal(tmp_path):
    rec = os.path.join(REPO, "tests", "data", "tiny_imagerec.rec")
    kw = dict(data_shape=(32, 32, 3), batch_size=4, resize=36,
              rand_crop=True, rand_mirror=True, seed=5, device="cpu",
              max_restarts=2)

    def epoch():
        it = tio.ImageRecordIter(rec, **kw)
        out = [(b.data[0]._t.clone(), b.label[0]._t.clone()) for b in it]
        it.close()
        return out

    clean = epoch()
    tio.io_stats(reset=True)
    with fault.scope("io.imagerec:2:ioerror"):
        got = epoch()
    assert tio.io_stats()["submit_restarts"] == 1
    assert len(got) == len(clean) >= 2
    assert all(torch.equal(a, c) and torch.equal(b, d)
               for (a, b), (c, d) in zip(got, clean))
    with fault.scope("io.imagerec:2+:ioerror"):
        with pytest.raises(IOError, match="io.imagerec"):
            epoch()


def test_dataloader_fetch_retries_transient_error():
    from incubator_mxnet_tpu_torch.gluon.data import DataLoader, ArrayDataset
    ds = ArrayDataset(np.arange(12, dtype=np.float32).reshape(6, 2))
    loader = DataLoader(ds, batch_size=2)
    with mx.cpu():
        with fault.scope("dataloader.fetch:2:ioerror"):  # transient: one hit
            batches = list(loader)
            assert fault.hits("dataloader.fetch") == 4
    assert len(batches) == 3
    np.testing.assert_array_equal(
        np.concatenate([b.asnumpy() for b in batches]),
        np.arange(12, dtype=np.float32).reshape(6, 2))


def test_dataloader_fetch_retry_budget_from_env(monkeypatch):
    from incubator_mxnet_tpu_torch.gluon.data import DataLoader, ArrayDataset
    monkeypatch.setenv("MXNET_DATALOADER_RETRIES", "2")
    ds = ArrayDataset(np.arange(8, dtype=np.float32).reshape(4, 2))
    loader = DataLoader(ds, batch_size=2)
    with mx.cpu():
        with fault.scope("dataloader.fetch:1+:ioerror"):
            with pytest.raises(IOError):
                list(loader)
            assert fault.hits("dataloader.fetch") == 2


def test_dataloader_stalled_worker_surfaces_timeout():
    from incubator_mxnet_tpu_torch.gluon.data import DataLoader

    class _StallDataset:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                time.sleep(3)
            return np.float32(i)

    loader = DataLoader(_StallDataset(), batch_size=2, num_workers=1,
                        timeout=0.5)
    t0 = time.time()
    with mx.cpu():
        with pytest.raises(mx.MXNetError, match="stalled"):
            list(loader)
    assert time.time() - t0 < 2.5  # surfaced, not hung on the worker join


# ---------------------------------------------------------------------------
# the decode engine's fault points
# ---------------------------------------------------------------------------
def _prompts(n, seed=3):
    from torch_port_utils import CFG
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG["vocab"], size=int(rng.randint(3, 12)))
            .tolist() for _ in range(n)]


def _serve_one_by_one(model, prompts, spec=None):
    from incubator_mxnet_tpu_torch import serve
    outs = []
    with serve.ContinuousEngine(model, max_slots=2, decode_steps=2,
                                prefill_window=16) as eng:
        with fault.scope(spec or ""):
            for p in prompts:
                try:
                    outs.append(eng.submit(p, 6).result(timeout=60))
                except Exception as e:      # the injected failures
                    outs.append(e)
            hits = fault.hits("serve.execute")
        st = eng.stats()
    return outs, hits, st


def test_serve_execute_fault_fails_its_wave_and_the_engine_serves_on():
    from torch_port_utils import decoders
    _, tm = decoders()
    prompts = _prompts(5)
    clean, _, _ = _serve_one_by_one(tm, prompts)
    got, hits, st = _serve_one_by_one(tm, prompts, "serve.execute:3:error")
    assert hits == 5          # one prefill wave a request, one at a time
    assert isinstance(got[2], fault.InjectedFault)
    assert "serve.execute" in str(got[2])
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[i], clean[i])
    assert st["errors"] == 1


def test_serve_enqueue_fault_fails_one_submit_only():
    from incubator_mxnet_tpu_torch import serve
    from torch_port_utils import decoders
    _, tm = decoders()
    prompts = _prompts(3, seed=4)
    clean, _, _ = _serve_one_by_one(tm, prompts)
    with serve.ContinuousEngine(tm, max_slots=2, decode_steps=2,
                                prefill_window=16) as eng:
        with fault.scope("serve.enqueue:1:ioerror"):
            with pytest.raises(IOError, match="serve.enqueue"):
                eng.submit(prompts[0], 6)
            outs = [eng.submit(p, 6).result(timeout=60) for p in prompts]
            assert fault.hits("serve.enqueue") == 4
        assert eng.stats()["errors"] == 0
    for o, c in zip(outs, clean):
        np.testing.assert_array_equal(o, c)


# ---------------------------------------------------------------------------
# run_resilient
# ---------------------------------------------------------------------------
def _state():
    w = (np.arange(32, dtype=np.float32).reshape(8, 4) + 1.0) / 10.0
    return {"w": torch.from_numpy(w)}


def _step_fn(state, step):
    w = state["w"]
    loss = (w * w).mean()
    return {"w": w * 0.9 + 0.01}, loss


def test_run_resilient_kill_resume_parity(tmp_path):
    state = _state()
    ref = fault.run_resilient(_step_fn, state, str(tmp_path / "ref"), 10,
                              ckpt_every=3)
    ref_w = ref.state["w"]
    # crash (injected, deterministic) at the 6th step, then resume: final
    # params must match the uninterrupted run exactly (the halved-mesh
    # half of the JAX test waits for the port's mesh, A10)
    d = str(tmp_path / "crash")
    fault.install("resilient.step", "error", at=6)
    with pytest.raises(fault.InjectedFault):
        fault.run_resilient(_step_fn, state, d, 10, ckpt_every=3,
                            max_step_retries=0)
    fault.clear()
    assert ckpt.latest_step(d) == 3  # last committed before the crash
    resumed = fault.run_resilient(_step_fn, state, d, 10, ckpt_every=3)
    assert resumed.resumed_from == 3
    assert resumed.saved_steps == [6, 9, 10]
    assert resumed.state["w"].dtype == torch.float32
    assert torch.equal(resumed.state["w"], ref_w)


def test_run_resilient_skips_nonfinite_loss(tmp_path):
    state = _state()
    fault.install("resilient.loss", "nan", at=2)
    run = fault.run_resilient(_step_fn, state, str(tmp_path / "n"), 5,
                              ckpt_every=100)
    assert run.skipped_nonfinite == 1
    # the poisoned step advanced the index but not the state: 4 updates
    w = state["w"].numpy()
    for _ in range(4):
        w = w * np.float32(0.9) + np.float32(0.01)
    np.testing.assert_allclose(run.state["w"].numpy(), w, rtol=1e-6)


def test_run_resilient_watchdog_fires_on_stalled_step(tmp_path):
    fault.install("resilient.step", "stall", at=2, arg=10)
    t0 = time.time()
    with pytest.raises(fault.WatchdogTimeout):
        fault.run_resilient(_step_fn, _state(), str(tmp_path / "w"), 5,
                            watchdog_seconds=0.3, max_step_retries=0)
    assert time.time() - t0 < 5.0


def test_run_resilient_step_retry_recovers(tmp_path):
    fault.install("resilient.step", "ioerror", at=2)  # transient: one hit
    run = fault.run_resilient(_step_fn, _state(), str(tmp_path / "r"), 4,
                              ckpt_every=100, max_step_retries=2,
                              retry_backoff=0.001)
    assert run.step == 4
    assert run.step_retries == 1


def test_run_resilient_npz_mode_resume(tmp_path):
    # host-local state goes through the same manifest protocol
    def step_fn(state, step):
        w = np.asarray(state["w"].asnumpy()
                       if hasattr(state["w"], "asnumpy") else state["w"])
        return {"w": w * 0.5}, float(w.sum())

    init = {"w": np.arange(6, dtype=np.float64)}
    d = str(tmp_path / "npz")
    fault.install("resilient.step", "error", at=4)
    with pytest.raises(fault.InjectedFault):
        fault.run_resilient(step_fn, init, d, 6, ckpt_every=2,
                            sharded=False, max_step_retries=0)
    fault.clear()
    run = fault.run_resilient(step_fn, init, d, 6, ckpt_every=2,
                              sharded=False)
    assert run.resumed_from == 2
    np.testing.assert_array_equal(run.state["w"],
                                  np.arange(6, dtype=np.float64) * 0.5 ** 6)


def test_run_resilient_persists_skip_counter_across_crash(tmp_path,
                                                          caplog):
    def step_fn(state, step):
        w = np.asarray(state["w"])
        return {"w": w * 0.5}, float(w.sum())

    init = {"w": np.arange(4, dtype=np.float64) + 1.0}
    d = str(tmp_path / "skip")
    fault.install("resilient.loss", "nan", at=2)   # skip at step 1
    fault.install("resilient.step", "error", at=5)  # die at step 4
    with pytest.raises(fault.InjectedFault):
        fault.run_resilient(step_fn, init, d, 8, ckpt_every=2,
                            sharded=False, max_step_retries=0)
    fault.clear()
    entry = ckpt.latest_entry(d)
    assert entry["step"] == 4
    assert entry["extra"]["resilient"]["skipped_nonfinite"] == 1
    with caplog.at_level(logging.INFO,
                         logger="incubator_mxnet_tpu_torch.fault"):
        run = fault.run_resilient(step_fn, init, d, 8, ckpt_every=2,
                                  sharded=False)
    assert run.resumed_from == 4
    # the counter CONTINUES from the committed value instead of resetting
    assert run.skipped_nonfinite == 1
    resumed = [r.getMessage() for r in caplog.records
               if "resilient.resumed" in r.getMessage()]
    assert resumed and '"skipped_nonfinite": 1' in resumed[0]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_run_resilient_rng_state_is_crash_consistent(tmp_path, kind):
    """With rng= passed, random draws replay identically after a crash:
    the RNG state is committed with each checkpoint and rewound to the
    restored step on resume (a numpy Generator, or the port's
    torch.Generator)."""
    def new_rng():
        return np.random.default_rng(42) if kind == "numpy" \
            else torch.Generator().manual_seed(42)

    def make_step(rng):
        def draw():
            return rng.standard_normal() if kind == "numpy" \
                else float(torch.randn((), generator=rng))

        def step_fn(state, step):
            w = np.asarray(state["w"])
            return {"w": w * 0.5 + draw()}, float(w.sum())
        return step_fn

    init = {"w": np.zeros(3, np.float64)}
    rng_ref = new_rng()
    ref = fault.run_resilient(make_step(rng_ref), init,
                              str(tmp_path / "ref"), 7, ckpt_every=2,
                              sharded=False, rng=rng_ref)
    d = str(tmp_path / "crash")
    rng_a = new_rng()
    fault.install("resilient.step", "error", at=6)
    with pytest.raises(fault.InjectedFault):
        fault.run_resilient(make_step(rng_a), init, d, 7, ckpt_every=2,
                            sharded=False, max_step_retries=0, rng=rng_a)
    fault.clear()
    # restart with a FRESH generator: its state must be rewound to the
    # committed step's snapshot, not the seed
    rng_b = new_rng()
    run = fault.run_resilient(make_step(rng_b), init, d, 7, ckpt_every=2,
                              sharded=False, rng=rng_b)
    assert run.resumed_from == 4
    np.testing.assert_array_equal(run.state["w"], ref.state["w"])


def test_rng_state_encode_roundtrip_every_kind():
    # RandomState (MT19937 tuple) and Generator (bit_generator dict)
    rs = np.random.RandomState(7)
    rs.randn(3)
    snap = fault.rng_state_encode(rs)
    rs2 = np.random.RandomState(0)
    fault.rng_state_restore(rs2, snap)
    np.testing.assert_array_equal(rs.randn(4), rs2.randn(4))

    gen = np.random.default_rng(9)
    gen.standard_normal(3)
    snap = fault.rng_state_encode(gen)
    assert json.loads(json.dumps(snap)) is not None   # JSON-safe
    gen2 = np.random.default_rng(0)
    fault.rng_state_restore(gen2, snap)
    np.testing.assert_array_equal(gen.standard_normal(4),
                                  gen2.standard_normal(4))

    # non-PCG bit generators carry ndarray state (MT19937's 624-word
    # key): the encode must still be JSON-safe and round-trip exactly
    mt = np.random.Generator(np.random.MT19937(5))
    mt.standard_normal(2)
    snap = fault.rng_state_encode(mt)
    snap = json.loads(json.dumps(snap))   # through a real JSON boundary
    mt2 = np.random.Generator(np.random.MT19937(0))
    fault.rng_state_restore(mt2, snap)
    np.testing.assert_array_equal(mt.standard_normal(3),
                                  mt2.standard_normal(3))

    # the port's streams: a torch.Generator
    tg = torch.Generator().manual_seed(11)
    torch.randn(5, generator=tg)
    snap = json.loads(json.dumps(fault.rng_state_encode(tg)))
    tg2 = torch.Generator().manual_seed(0)
    fault.rng_state_restore(tg2, snap)
    assert torch.equal(torch.randn(6, generator=tg),
                       torch.randn(6, generator=tg2))
    # kind mismatch is a loud error, not silent corruption
    with pytest.raises(mx.MXNetError, match="RandomState"):
        fault.rng_state_restore(np.random.default_rng(0),
                                fault.rng_state_encode(rs))
    with pytest.raises(mx.MXNetError, match="torch.Generator"):
        fault.rng_state_restore(np.random.default_rng(0),
                                fault.rng_state_encode(tg))


def test_rng_state_encode_matches_jax_for_numpy_kinds():
    from incubator_mxnet_tpu import fault as jfault
    for rng in (np.random.RandomState(3), np.random.default_rng(3)):
        assert fault.rng_state_encode(rng) == jfault.rng_state_encode(rng)


def test_checkpoint_load_injected_ioerror_is_side_effect_free(tmp_path):
    p = ckpt.save_checkpoint(str(tmp_path / "c"), {"w": np.arange(4.)},
                             step=3)
    with fault.scope("checkpoint.load:1:ioerror"):
        with pytest.raises(IOError):
            ckpt.load_checkpoint(p, device=CPU)
    # the failed load touched nothing: a plain retry returns the committed
    # checkpoint bit-exactly
    params, step = ckpt.load_checkpoint(p, device=CPU)
    assert step == 3
    np.testing.assert_array_equal(params["w"].asnumpy(), np.arange(4.))


# ---------------------------------------------------------------------------
# the in-place guard: the LM's step never writes its inputs
# ---------------------------------------------------------------------------
LM = tf.TransformerConfig(vocab_size=64, num_layers=1, d_model=16,
                          num_heads=2, d_ff=32, max_seq_len=8,
                          dtype="float32")


def _lm_state():
    params = tf.init_params(0, LM, device="cpu")
    mu, nu = tf.init_opt_state(params)
    return {"params": params, "mu": mu, "nu": nu}


def _lm_step(train=tf.make_train_step(LM)):
    def step_fn(state, step):
        r = np.random.RandomState(step)
        toks = torch.from_numpy(r.randint(0, LM.vocab_size, (2, 9)))
        p, (m, v), loss = train(state["params"], (state["mu"], state["nu"]),
                                {"tokens": toks}, step)
        return {"params": p, "mu": m, "nu": v}, loss
    return step_fn


def _leaves(tree):
    return tf._leaves(tree)


def _snapshot(state):
    return [t.clone() for t in _leaves(state)]


def _equal(state, snap):
    return all(torch.equal(a, b) for a, b in zip(_leaves(state), snap))


def test_nan_skipped_step_leaves_the_input_state_bit_equal(tmp_path):
    state = _lm_state()
    snap = _snapshot(state)
    fault.install("resilient.loss", "nan", at=1)
    run = fault.run_resilient(_lm_step(), state, str(tmp_path / "n"), 1,
                              ckpt_every=100)
    assert run.skipped_nonfinite == 1
    assert _equal(state, snap) and _equal(run.state, snap)
    # a full run of the other step from that state moves every param
    out, _ = _lm_step()(state, 0)
    assert _equal(state, snap)
    assert not any(torch.equal(a, b) for a, b in zip(
        _leaves(out["params"]), _leaves(state["params"])))


def test_retried_step_goes_on_from_the_untouched_state(tmp_path):
    clean = fault.run_resilient(_lm_step(), _lm_state(),
                                str(tmp_path / "clean"), 3, ckpt_every=100)
    inner = _lm_step()
    calls = []

    def flaky(state, step):
        out = inner(state, step)     # the whole step runs, then it fails
        calls.append(step)
        if len(calls) == 2:
            raise IOError("transient, after the step's work")
        return out

    state = _lm_state()
    snap = _snapshot(state)
    run = fault.run_resilient(flaky, state, str(tmp_path / "r"), 3,
                              ckpt_every=100, max_step_retries=1,
                              retry_backoff=0.001)
    assert run.step_retries == 1 and calls == [0, 1, 1, 2]
    assert _equal(state, snap)
    assert _equal(run.state, _snapshot(clean.state))


def test_lm_resume_after_injected_error_is_bit_equal(tmp_path):
    ref = fault.run_resilient(_lm_step(), _lm_state(), str(tmp_path / "a"),
                              7, ckpt_every=3)
    d = str(tmp_path / "b")
    fault.install("resilient.step", "error", at=6)
    with pytest.raises(fault.InjectedFault):
        fault.run_resilient(_lm_step(), _lm_state(), d, 7, ckpt_every=3,
                            max_step_retries=0)
    fault.clear()
    run = fault.run_resilient(_lm_step(), _lm_state(), d, 7, ckpt_every=3)
    assert run.resumed_from == 3
    assert _equal(run.state, _snapshot(ref.state))


# ---------------------------------------------------------------------------
# a real SIGKILL: tools/torch_crashtest.py on a tiny LM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,where,committed", [
    ("lm", "step", 6), ("lm", "save", 3), ("quad", "save", 3)])
def test_crashtest_sigkill_parity_quick(tmp_path, model, where, committed):
    # killed at the 7th step (steps 3 and 6 committed), or inside the 2nd
    # save (step 6's, after its data and before its commit: step 3 stands;
    # the LM's per-leaf save, or the npz save of the JAX tool's basic mode)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_crashtest.py"),
         "--device", "cpu", "--model", model, "--steps", "8",
         "--ckpt-every", "3", "--kill-at", "7", "--kill-in", where,
         "--dir", str(tmp_path)],
        capture_output=True, text=True, timeout=60,
        env={k: v for k, v in os.environ.items()
             if k != "MXNET_FAULT_SPEC"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "parity OK" in proc.stdout
    assert (f"latest committed step {committed} (expected {committed})"
            in proc.stdout)
