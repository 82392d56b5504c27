"""PyTorch port: `gluon.contrib.estimator` held against the JAX package's,
on the CPU, from the same calls.

Both packages fit the same small Dense net (the JAX net's values carried
into the port with `params_from_jax`) on the same seeded numpy batches
with SGD. Covered: parameters after `fit(epochs=2)` within 1e-5 (float32:
the same products and updates, summed in another order), train and
validation metrics within 1e-6, the handler event sequence (recorded by a
handler), `max_batch` and early stopping at the same epochs, the same
checkpoint file names, checkpoints that load across the two packages,
resume shortening the epoch budget, the checkpoint save retried on a
transient fault at `estimator.checkpoint` and raising on a persistent one,
the MXNET_PREFETCH_TO_DEVICE opt-in and opt-out, and `step_timeline`'s
keys and MFU.

Every test leaves the process as it found it (`process_state_kept`), with
the fault registries of both packages cleared and put back.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import profiler as jprof
from incubator_mxnet_tpu.gluon.contrib import estimator as jest
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.gluon.contrib import estimator as test

from torch_port_utils import (expire_port_trace_memo, port_faults_cleared,
                              process_state_kept)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
METRIC_TOL = 1e-6
N, D, BATCH, HIDDEN, CLASSES = 64, 8, 16, 16, 2


KNOBS = ("MXNET_PREFETCH_TO_DEVICE", "MXNET_TELEMETRY")


@contextlib.contextmanager
def _knobs_restored():
    """The knobs the tests set, unset inside and put back on exit."""
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        expire_port_trace_memo()


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    expire_port_trace_memo()
    with process_state_kept(), port_faults_cleared(), _knobs_restored(), \
            tmx.cpu():
        yield


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    return x, y


def _batches(m, seed=0):
    x, y = _data(seed)
    return [(m.np.array(x[i:i + BATCH]), m.np.array(y[i:i + BATCH]))
            for i in range(0, N, BATCH)]


def _pair():
    """(JAX net, port net) with the same values."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(HIDDEN, activation="relu", in_units=D),
             jgluon.nn.Dense(CLASSES, in_units=HIDDEN))
    jnet.initialize()
    tnet = tgluon.nn.HybridSequential()
    tnet.add(tgluon.nn.Dense(HIDDEN, activation="relu", in_units=D),
             tgluon.nn.Dense(CLASSES, in_units=HIDDEN))
    tnet.initialize(device="cpu")
    rng = np.random.RandomState(3)
    values = {}
    for name, p in jnet.collect_params().items():
        v = (0.3 * rng.randn(*p.shape)).astype(np.float32)
        p.set_data(jmx.np.array(v))
        values[name] = v
    tgluon.params_from_jax(tnet, values)
    return jnet, tnet


def _estimators(lr=0.1, **kw):
    jnet, tnet = _pair()
    je = jest.Estimator(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                        trainer=jgluon.Trainer(jnet.collect_params(), "sgd",
                                               {"learning_rate": lr}), **kw)
    te = test.Estimator(tnet, tgluon.loss.SoftmaxCrossEntropyLoss(),
                        trainer=tgluon.Trainer(tnet.collect_params(), "sgd",
                                               {"learning_rate": lr}), **kw)
    return je, te


def _values(net):
    return {n: np.asarray(p.data().asnumpy() if hasattr(p.data(), "asnumpy")
                          else p.data().detach().numpy(), np.float32)
            for n, p in net.collect_params().items()}


def _assert_params_close(je, te):
    jv, tv = _values(je.net), _values(te.net)
    assert sorted(jv) == sorted(tv)
    for name in jv:
        np.testing.assert_allclose(tv[name], jv[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _spy(mod, events):
    class Spy(mod.TrainBegin, mod.EpochBegin, mod.BatchBegin, mod.BatchEnd,
              mod.EpochEnd, mod.TrainEnd):
        def train_begin(self, estimator, *a, **kw):
            events.append("train_begin")

        def epoch_begin(self, estimator, *a, **kw):
            events.append("epoch_begin")

        def batch_begin(self, estimator, *a, **kw):
            events.append("batch_begin")

        def batch_end(self, estimator, *a, **kw):
            events.append("batch_end")

        def epoch_end(self, estimator, *a, **kw):
            events.append("epoch_end")

        def train_end(self, estimator, *a, **kw):
            events.append("train_end")
    return Spy()


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------
def test_module_surface_matches_jax():
    assert sorted(test.__all__) == sorted(jest.__all__)
    assert tgluon.contrib.estimator is test
    # defaults and priorities of the built-in handlers
    for name, args in (("MetricHandler", ([],)),
                       ("ValidationHandler", ([], None)),
                       ("LoggingHandler", ()),
                       ("StepTimelineHandler", ())):
        jh, th = getattr(jest, name)(*args), getattr(test, name)(*args)
        assert th.priority == jh.priority, name
    th, jh = test.StoppingHandler(), jest.StoppingHandler()
    assert (th.max_epoch, th.max_batch) == (jh.max_epoch, jh.max_batch)
    jnet, tnet = _pair()
    assert type(test.Estimator(tnet, None).trainer.optimizer).__name__ == \
        type(jest.Estimator(jnet, None).trainer.optimizer).__name__


# ---------------------------------------------------------------------------
# fit against the JAX package
# ---------------------------------------------------------------------------
def test_fit_two_epochs_matches_jax():
    je, te = _estimators()
    jevents, tevents = [], []
    je.fit(_batches(jmx), val_data=_batches(jmx, seed=1), epochs=2,
           event_handlers=[_spy(jest, jevents)])
    te.fit(_batches(tmx), val_data=_batches(tmx, seed=1), epochs=2,
           event_handlers=[_spy(test, tevents)])
    assert tevents == jevents
    assert jevents.count("batch_end") == 8 and jevents.count(
        "epoch_end") == 2
    _assert_params_close(je, te)
    for jm, tm in zip(je.train_metrics + je.val_metrics,
                      te.train_metrics + te.val_metrics):
        (jn, jval), (tn, tval) = jm.get(), tm.get()
        assert tn == jn
        assert tval == pytest.approx(jval, abs=METRIC_TOL), tn


def test_dataloader_fit_and_evaluate_match_jax():
    je, te = _estimators()
    x, y = _data()
    jdl = jgluon.data.DataLoader(jgluon.data.ArrayDataset(x, y),
                                 batch_size=BATCH)
    tdl = tgluon.data.DataLoader(tgluon.data.ArrayDataset(x, y),
                                 batch_size=BATCH)
    je.fit(jdl, epochs=2)
    te.fit(tdl, epochs=2)
    _assert_params_close(je, te)
    jres, tres = je.evaluate(jdl), te.evaluate(tdl)
    assert sorted(tres) == sorted(jres)
    for k in jres:
        assert tres[k] == pytest.approx(jres[k], abs=METRIC_TOL)


def test_max_batches_stops_inside_the_epoch():
    je, te = _estimators()
    jevents, tevents = [], []
    je.fit(_batches(jmx), batches=3, event_handlers=[_spy(jest, jevents)])
    te.fit(_batches(tmx), batches=3, event_handlers=[_spy(test, tevents)])
    assert tevents == jevents and tevents.count("batch_end") == 3
    _assert_params_close(je, te)


@pytest.mark.parametrize("patience", [0, 1])
def test_early_stopping_at_the_same_epoch(patience):
    # a learning rate that overshoots, so the loss stops improving
    je, te = _estimators(lr=4.0)
    jearly = jest.EarlyStoppingHandler(je.train_metrics[-1],
                                       patience=patience, mode="min")
    tearly = test.EarlyStoppingHandler(te.train_metrics[-1],
                                       patience=patience, mode="min")
    jevents, tevents = [], []
    je.fit(_batches(jmx), epochs=6,
           event_handlers=[jearly, _spy(jest, jevents)])
    te.fit(_batches(tmx), epochs=6,
           event_handlers=[tearly, _spy(test, tevents)])
    assert tearly.stopped_epoch == jearly.stopped_epoch
    assert tevents.count("epoch_end") == jevents.count("epoch_end")
    assert tevents == jevents


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_files_match_and_load_across_packages(tmp_path):
    je, te = _estimators()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jh = jest.CheckpointHandler(jdir, model_prefix="m", save_best=True,
                                monitor=je.train_metrics[-1])
    th = test.CheckpointHandler(tdir, model_prefix="m", save_best=True,
                                monitor=te.train_metrics[-1])
    assert (th.mode, th.best) == (jh.mode, jh.best) == ("min", np.inf)
    je.fit(_batches(jmx), epochs=2, event_handlers=[jh])
    te.fit(_batches(tmx), epochs=2, event_handlers=[th])
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert {"m-epoch1.params.npz", "m-epoch2.params.npz",
            "m-epoch2.params.npz.states", "m-best.params.npz",
            "m-best.json"} <= set(names)
    # the port's file into a fresh JAX net, the JAX file into a port net
    jfresh, tfresh = _pair()
    jfresh.load_parameters(os.path.join(tdir, "m-epoch2.params.npz"))
    tfresh.load_parameters(os.path.join(jdir, "m-epoch2.params.npz"))
    for name, v in _values(te.net).items():
        np.testing.assert_array_equal(_values(jfresh)[name], v)
    for name, v in _values(je.net).items():
        np.testing.assert_array_equal(_values(tfresh)[name], v)
    _assert_params_close(je, te)


def _resume_run(mod, m, d):
    """The JAX package's resume drill: 2 epochs, then a resumed fit with a
    3-epoch budget, then a fit without a resume handler."""
    def make():
        net = mod_gluon[mod].nn.Dense(1, in_units=3)
        if mod is test:
            net.initialize(device="cpu")
        else:
            net.initialize()
        return mod.Estimator(net, mod_gluon[mod].loss.L2Loss())
    x = np.random.RandomState(0).randn(8, 3).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 1).astype(np.float32)
    data = [(m.np.array(x[:4]), m.np.array(y[:4])),
            (m.np.array(x[4:]), m.np.array(y[4:]))]
    est = make()
    est.fit(data, epochs=2,
            event_handlers=[mod.CheckpointHandler(d, epoch_period=1)])
    est2 = make()
    est2.fit(data, epochs=3, event_handlers=[mod.CheckpointHandler(
        d, epoch_period=1, resume_from_checkpoint=True)])
    events = []
    est2.fit(data, epochs=1, event_handlers=[_spy(mod, events)])
    return (est2._resume_epoch, sorted(os.listdir(d)),
            events.count("epoch_end"))


mod_gluon = {jest: jgluon, test: tgluon}


def test_resume_shortens_the_epoch_budget_as_jax(tmp_path):
    got = _resume_run(test, tmx, str(tmp_path / "port"))
    want = _resume_run(jest, jmx, str(tmp_path / "jax"))
    assert got == want
    assert got[0] == 0 and "model-epoch3.params.npz" in got[1] \
        and "model-epoch4.params.npz" not in got[1] and got[2] == 1


class _FileNet:
    def save_parameters(self, path):
        with open(path, "w") as f:
            f.write("params")


class _FileEst:
    net = _FileNet()
    trainer = None


def test_checkpoint_save_retried_on_a_transient_fault(tmp_path):
    h = test.CheckpointHandler(str(tmp_path / "ckpts"), model_prefix="m")
    h.train_begin(_FileEst())
    with tfault.scope("estimator.checkpoint:1:ioerror"):
        h.epoch_end(_FileEst())          # the first attempt fails
        assert tfault.hits("estimator.checkpoint") >= 2
    assert os.path.exists(str(tmp_path / "ckpts" / "m-epoch1.params.npz"))


def test_checkpoint_save_raises_on_a_persistent_fault(tmp_path):
    results = {}
    for name, mod, fault in (("jax", jest, jfault), ("port", test, tfault)):
        h = mod.CheckpointHandler(str(tmp_path / name), model_prefix="m")
        h.train_begin(_FileEst())
        with fault.scope("estimator.checkpoint:1+:ioerror"):
            with pytest.raises(IOError):
                h.epoch_end(_FileEst())
            results[name] = fault.hits("estimator.checkpoint")
        assert not os.path.exists(str(tmp_path / name
                                      / "m-epoch1.params.npz"))
    assert results["port"] == results["jax"] == 3


# ---------------------------------------------------------------------------
# the device feed and the step timeline
# ---------------------------------------------------------------------------
def test_prefetch_env_opt_in_feeds_the_fit(monkeypatch):
    monkeypatch.setenv("MXNET_PREFETCH_TO_DEVICE", "1")
    counts = {}
    for name, m, mod, prof in (("jax", jmx, jest, jprof),
                               ("port", tmx, test, tprof)):
        je, te = _estimators()
        e = je if mod is jest else te
        prof.feed_stats(reset=True)
        e.fit(_batches(m)[:3], epochs=2)
        s = prof.feed_stats()
        counts[name] = (s["batches_consumed"], s["epochs"])
    assert counts["port"] == counts["jax"] == (6, 2)


def test_loader_opt_out_is_respected(monkeypatch):
    monkeypatch.setenv("MXNET_PREFETCH_TO_DEVICE", "1")
    x = np.random.rand(12, D).astype(np.float32)
    y = (np.random.rand(12) > 0.5).astype(np.int32)
    counts = {}
    for name, g, mod, prof in (("jax", jgluon, jest, jprof),
                               ("port", tgluon, test, tprof)):
        dl = g.data.DataLoader(g.data.ArrayDataset(x, y), batch_size=4,
                               prefetch_to_device=False)
        assert dl._prefetch_opt_out
        je, te = _estimators()
        e = je if mod is jest else te
        prof.feed_stats(reset=True)
        e.fit(train_data=dl, epochs=1)
        counts[name] = prof.feed_stats()["batches_consumed"]
    assert counts["port"] == counts["jax"] == 0


def test_step_timeline_keys_and_mfu_as_jax():
    peak = 1e9
    hand = 3 * (2 * BATCH * D * HIDDEN + 2 * BATCH * HIDDEN * CLASSES)
    reps = {}
    for name, m, mod in (("jax", jmx, jest), ("port", tmx, test)):
        je, te = _estimators()
        e = je if mod is jest else te
        e.fit(_batches(m), epochs=1, event_handlers=[
            mod.StepTimelineHandler(flops_per_batch=hand, peak_flops=peak)])
        reps[name] = e.step_timeline
    jrep, trep = reps["jax"], reps["port"]
    assert set(trep) == set(jrep)
    assert trep["steps"] == jrep["steps"] == N // BATCH
    assert trep["mfu"] == pytest.approx(
        hand * trep["steps"] / (trep["total_us"] * 1e-6) / peak, rel=0.10)


def test_step_timeline_auto_flops_counts_the_forward():
    je, te = _estimators()
    h = test.StepTimelineHandler(auto_flops=True, peak_flops=1e9)
    te.fit(_batches(tmx), epochs=1, event_handlers=[h])
    x = _batches(tmx)[0][0]
    flops = ttel.block_fwd_flops(te.net, x)
    # FlopCounterMode counts the two products, 2 per multiply-add
    assert flops == 2 * BATCH * D * HIDDEN + 2 * BATCH * HIDDEN * CLASSES
    assert h._tl.flops_per_step == 3 * flops
    rep = te.step_timeline
    assert rep["mfu"] == pytest.approx(
        3 * flops * rep["steps"] / (rep["total_us"] * 1e-6) / 1e9,
        rel=0.10)
    # on the CPU the card's peak is unknown: no MFU rather than a wrong one
    te2 = _estimators()[1]
    te2.fit(_batches(tmx), epochs=1,
            event_handlers=[test.StepTimelineHandler(auto_flops=True)])
    assert "mfu" not in te2.step_timeline


def test_telemetry_env_attaches_a_timeline(monkeypatch):
    for on, want in (("1", 4), ("0", None)):
        monkeypatch.setenv("MXNET_TELEMETRY", on)
        expire_port_trace_memo()
        te = _estimators()[1]
        te.fit(_batches(tmx), epochs=1)
        got = te.step_timeline["steps"] if te.step_timeline else None
        assert got == want, on
