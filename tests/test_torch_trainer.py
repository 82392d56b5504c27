"""PyTorch port: `gluon.Trainer`, the 18 optimizer rules and the 5
learning-rate schedulers against the JAX package, on the CPU.

Both packages train the same two-Parameter block from the same numpy
values through their own `autograd.record()` / backward / `Trainer.step`
loop. The block's loss, sum(c1 * w * w) + sum(c2 * b), has gradients
(2 c1 w and c2) that both packages compute exactly, so the comparison
holds each rule's arithmetic alone.

Tolerances: float32 weights after each of 3 steps to rtol 1e-5 (the rules
evaluate the same expressions; scalars such as 1 - beta1 round once to
float32 in JAX and in float64 first here), atol 1e-7 for values near 0;
scheduler values exactly (the same host arithmetic); multi-precision
16-bit weights to one step of their type (each side rounds its float32
master copy once).
"""
import pickle

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import lr_scheduler as jlr
from incubator_mxnet_tpu import optimizer as jopt

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import lr_scheduler as tlr
from incubator_mxnet_tpu_torch import optimizer as topt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
STEPS = 3
W_SHAPE, B_SHAPE = (4, 5), (5,)


class JQuad(jgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.weight = jgluon.Parameter(shape=W_SHAPE, name="weight")
        self.bias = jgluon.Parameter(shape=B_SHAPE, name="bias")

    def forward(self, c1, c2):
        w = self.weight.data()
        return (c1 * w * w).sum() + (c2 * self.bias.data()).sum()


class TQuad(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self._new_param("weight", W_SHAPE)
        self._new_param("bias", B_SHAPE)

    def forward(self, c1, c2):
        return (c1 * self.weight * self.weight).sum() \
            + (c2 * self.bias).sum()


def _values(seed):
    rng = np.random.RandomState(seed)
    return {"weight": rng.randn(*W_SHAPE).astype(np.float32),
            "bias": rng.randn(*B_SHAPE).astype(np.float32)}


def _coefs(seed, step):
    rng = np.random.RandomState(1000 * seed + step)
    return (rng.randn(*W_SHAPE).astype(np.float32),
            rng.randn(*B_SHAPE).astype(np.float32))


def quad_pair(seed=0, dtype=None):
    jnet, tnet = JQuad(), TQuad()
    jnet.initialize()
    tnet.initialize(device="cpu")
    vals = _values(seed)
    for name, p in jnet.collect_params().items():
        p.set_data(mx.np.array(vals[name]))
    tgluon.params_from_jax(tnet, vals)
    if dtype is not None:
        jnet.cast(dtype)
        tnet.cast(dtype)
    return jnet, tnet


def jax_steps(jnet, trainer, seed, steps=STEPS, batch=4, dtype=None,
              start=0):
    out = []
    for k in range(start, steps):
        c1, c2 = (mx.np.array(c) for c in _coefs(seed, k))
        if dtype is not None:
            c1, c2 = c1.astype(dtype), c2.astype(dtype)
        with jag.record():
            loss = jnet(c1, c2)
        loss.backward()
        trainer.step(batch)
        out.append({n: np.asarray(p.data().astype("float32").asnumpy())
                    for n, p in jnet.collect_params().items()})
    return out


def port_steps(tnet, trainer, seed, steps=STEPS, batch=4, dtype=None,
               start=0):
    out = []
    for k in range(start, steps):
        c1, c2 = (torch.from_numpy(c) for c in _coefs(seed, k))
        if dtype is not None:
            c1, c2 = c1.to(getattr(torch, dtype)), c2.to(getattr(torch,
                                                                  dtype))
        with tag.record():
            loss = tnet(c1, c2)
        tag.backward(loss)
        trainer.step(batch)
        out.append({n: p.data().detach().float().numpy().copy()
                    for n, p in tnet.collect_params().items()})
    return out


def assert_runs_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=rtol,
                                       atol=atol,
                                       err_msg=f"{what} step {k} {name}")


# every rule with knobs that reach its every branch
RULES = [
    ("sgd", {}), ("sgd", {"momentum": 0.9, "wd": 0.01}),
    ("signum", {"wd": 0.01, "wd_lh": 0.001}), ("signum", {"momentum": 0.0}),
    ("dcasgd", {"momentum": 0.9}), ("dcasgd", {}),
    ("nag", {"momentum": 0.9, "wd": 0.01}),
    ("adagrad", {"wd": 0.01}), ("adadelta", {"learning_rate": 0.5}),
    ("adam", {"wd": 0.01}), ("adamw", {"wd": 0.01}), ("adamax", {}),
    ("nadam", {}), ("adabelief", {"wd": 0.01}), ("ftml", {}),
    ("ftrl", {"wd": 0.01}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 1.5}),
    ("lars", {"wd": 0.01}), ("lars", {"momentum": 0.0}),
    ("lamb", {"wd": 0.01}),
    ("lamb", {"lower_bound": 0.5, "upper_bound": 2.0,
              "bias_correction": False}),
    ("lans", {"wd": 0.01}),
]


def test_every_rule_is_registered():
    ported = {n for n in topt._REGISTRY}
    assert ported == set(jopt._REGISTRY) and len(ported) == 18
    assert {n for n, _ in RULES} | {"sgld"} == ported


@pytest.mark.parametrize("name,kw", RULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(RULES)])
def test_rule_three_steps_match_jax(name, kw):
    kw = dict({"learning_rate": 0.05}, **kw)
    jnet, tnet = quad_pair(seed=3)
    want = jax_steps(jnet, jgluon.Trainer(jnet.collect_params(), name,
                                          dict(kw)), seed=3)
    got = port_steps(tnet, tgluon.Trainer(tnet.collect_params(), name,
                                          dict(kw)), seed=3)
    assert_runs_close(got, want, what=name)


def test_sgld_mean_update_matches_jax_without_noise(monkeypatch):
    """SGLD draws its noise from the port's torch.Generator (a deliberate
    difference, as dropout's): with the noise set to zero on both sides
    the update is the JAX package's."""
    import jax
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jax.numpy.zeros(
                            shape, dtype))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.zeros(
        a[0], dtype=k.get("dtype"), device=k.get("device")))
    jnet, tnet = quad_pair(seed=4)
    want = jax_steps(jnet, jgluon.Trainer(jnet.collect_params(), "sgld",
                                          {"learning_rate": 0.05}), seed=4)
    got = port_steps(tnet, tgluon.Trainer(tnet.collect_params(), "sgld",
                                          {"learning_rate": 0.05}), seed=4)
    assert_runs_close(got, want, what="sgld")


def test_sgld_noise_comes_from_the_port_generator():
    from incubator_mxnet_tpu_torch import random as trandom
    runs = []
    for _ in range(2):
        trandom.seed(5)
        _, tnet = quad_pair(seed=4)
        runs.append(port_steps(tnet, tgluon.Trainer(
            tnet.collect_params(), "sgld", {"learning_rate": 0.05}), seed=4))
    assert_runs_close(runs[0], runs[1], rtol=0, atol=0)
    _, tnet = quad_pair(seed=4)
    plain = port_steps(tnet, tgluon.Trainer(tnet.collect_params(), "sgd",
                                            {"learning_rate": 0.025}), seed=4)
    assert not np.allclose(runs[0][-1]["weight"], plain[-1]["weight"])


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_lr_mult_wd_mult_and_clip_gradient_match_jax(name):
    kw = {"learning_rate": 0.05, "wd": 0.02, "clip_gradient": 0.7}
    if name == "sgd":
        kw["momentum"] = 0.9
    jnet, tnet = quad_pair(seed=5)
    for net in (jnet, tnet):
        net.collect_params()["weight"].lr_mult = 0.5
        net.collect_params()["bias"].wd_mult = 0.0
    want = jax_steps(jnet, jgluon.Trainer(jnet.collect_params(), name,
                                          dict(kw)), seed=5)
    got = port_steps(tnet, tgluon.Trainer(tnet.collect_params(), name,
                                          dict(kw)), seed=5)
    assert_runs_close(got, want, what=name)
    # and the multipliers did act: without them the run differs
    _, tnet = quad_pair(seed=5)
    plain = port_steps(tnet, tgluon.Trainer(tnet.collect_params(), name,
                                            dict(kw)), seed=5)
    assert not np.allclose(plain[-1]["weight"], got[-1]["weight"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_multi_precision_matches_jax(name, dtype):
    kw = {"learning_rate": 0.05, "multi_precision": True}
    jnet, tnet = quad_pair(seed=6, dtype=dtype)
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw))
    ttr = tgluon.Trainer(tnet.collect_params(), name, dict(kw))
    want = jax_steps(jnet, jtr, seed=6, dtype=dtype)
    got = port_steps(tnet, ttr, seed=6, dtype=dtype)
    step = 2.0 ** (-8 if dtype == "bfloat16" else -11)
    assert_runs_close(got, want, rtol=2 * step, atol=1e-6, what=name)
    for p in tnet.collect_params().values():
        assert p.data().dtype == getattr(torch, dtype)
    master, _ = ttr._states[0]
    assert master.dtype == torch.float32
    np.testing.assert_array_equal(
        master.to(getattr(torch, dtype)).float().numpy(),
        tnet.collect_params()["weight"].data().detach().float().numpy())


def test_stale_gradient_raises_and_ignore_skips():
    _, tnet = quad_pair(seed=7)
    tr = tgluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    with pytest.raises(MXNetError, match="has not been updated by backward "
                       "since the last step; set ignore_stale_grad=True"):
        tr.step(1)
    port_steps(tnet, tr, seed=7, steps=1)
    before = {n: p.data().clone() for n, p in tnet.collect_params().items()}
    with pytest.raises(MXNetError, match="weight"):
        tr.step(1)                                  # consumed by the step
    tr.step(1, ignore_stale_grad=True)              # skips: a no-op
    for n, p in tnet.collect_params().items():
        assert torch.equal(p.data(), before[n])
    # a backward that reaches only the bias refreshes only the bias
    with tag.record():
        loss = (tnet.bias * 2.0).sum()
    tag.backward(loss)
    tr.step(1, ignore_stale_grad=True)
    assert torch.equal(tnet.weight, before["weight"])
    assert not torch.equal(tnet.bias, before["bias"])


def test_jax_stale_rule_is_the_same():
    jnet, _ = quad_pair(seed=7)
    tr = jgluon.Trainer(jnet.collect_params(), "sgd")
    with pytest.raises(mx.MXNetError, match="has not been updated by "
                       "backward since the last step"):
        tr.step(1)


def test_trainer_surface():
    _, tnet = quad_pair(seed=8)
    tr = tgluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore="device")
    assert tr.learning_rate == 0.1
    tr.set_learning_rate(0.2)
    assert tr.learning_rate == 0.2 and tr.optimizer.lr == 0.2
    tr.allreduce_grads()                            # one card: nothing
    port_steps(tnet, tr, seed=8, steps=1)
    with tag.record():
        loss = tnet(*(torch.from_numpy(c) for c in _coefs(8, 1)))
    tag.backward(loss)
    tr.update(2)
    assert tr.optimizer.num_update == 2
    with pytest.raises(MXNetError, match="ROADMAP A10"):
        tgluon.Trainer(tnet.collect_params(), "sgd", kvstore="dist_sync")
    with pytest.raises(MXNetError, match="invalid parameter"):
        tgluon.Trainer([tnet.weight], "sgd")
    with pytest.raises(MXNetError, match="optimizer_params must be None"):
        tgluon.Trainer(tnet.collect_params(), topt.SGD(), {"momentum": 0.9})
    sched = tlr.FactorScheduler(step=1, factor=0.5, base_lr=1.0)
    tr = tgluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.4, "lr_scheduler": sched})
    assert sched.base_lr == 0.4                     # learning_rate sets it
    with pytest.raises(MXNetError, match="lr_scheduler"):
        tr.set_learning_rate(0.1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_states_load_across_packages(writer, tmp_path):
    """Two Adam steps in one package, its weights and states saved; a
    fresh trainer of the other package loads them and takes the third
    step, which must equal the writer's own third step."""
    kw = {"learning_rate": 0.05, "wd": 0.01}
    jnet, tnet = quad_pair(seed=9)
    if writer == "jax":
        writer_tr = jgluon.Trainer(jnet.collect_params(), "adam", dict(kw))
        jax_steps(jnet, writer_tr, seed=9, steps=2)
        vals = {n: np.asarray(p.data().asnumpy())
                for n, p in jnet.collect_params().items()}
    else:
        writer_tr = tgluon.Trainer(tnet.collect_params(), "adam", dict(kw))
        port_steps(tnet, writer_tr, seed=9, steps=2)
        vals = {n: p.data().detach().numpy().copy()
                for n, p in tnet.collect_params().items()}
    f = str(tmp_path / "trainer.states")
    writer_tr.save_states(f)
    with open(f, "rb") as fh:
        payload = pickle.load(fh)
    assert sorted(payload) == ["index_count", "num_update", "states"]
    assert payload["num_update"] == 2 and sorted(payload["states"]) == [0, 1]
    if writer == "jax":
        reader_net = quad_pair(seed=9)[1]
        tgluon.params_from_jax(reader_net, vals)
        reader = tgluon.Trainer(reader_net.collect_params(), "adam",
                                dict(kw))
        reader.load_states(f)
        got = port_steps(reader_net, reader, seed=9, steps=3, start=2)
        want = jax_steps(jnet, writer_tr, seed=9, steps=3, start=2)
    else:
        reader_net = quad_pair(seed=9)[0]
        for n, p in reader_net.collect_params().items():
            p.set_data(mx.np.array(vals[n]))
        reader = jgluon.Trainer(reader_net.collect_params(), "adam",
                                dict(kw))
        reader.load_states(f)
        want = jax_steps(reader_net, reader, seed=9, steps=3, start=2)
        got = port_steps(tnet, writer_tr, seed=9, steps=3, start=2)
    assert reader.optimizer.num_update == 3
    assert_runs_close(got, want, what=f"{writer}-written states")


def test_updater_keeps_states_and_serializes():
    w = torch.ones(3)
    up = topt.get_updater(topt.create("adam", learning_rate=0.1))
    up(0, torch.full((3,), 0.5), w)
    up(0, torch.full((3,), 0.5), w)
    assert up.optimizer.num_update == 2 and len(up.states[0]) == 2
    blob = up.get_states()
    other = topt.get_updater(topt.create("adam", learning_rate=0.1))
    other.set_states(blob)
    np.testing.assert_array_equal(other.states[0][0].numpy(),
                                  up.states[0][0].numpy())
    jup = jopt.get_updater(jopt.create("adam", learning_rate=0.1))
    jup.set_states(blob)                   # the JAX package reads it too
    np.testing.assert_allclose(jup.states[0][1].asnumpy(),
                               up.states[0][1].numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = [
    ("LRScheduler", dict(base_lr=0.1, warmup_steps=4, warmup_begin_lr=0.01)),
    ("LRScheduler", dict(base_lr=0.1, warmup_steps=3,
                         warmup_mode="constant", warmup_begin_lr=0.02)),
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.1,
                             stop_factor_lr=0.01, warmup_steps=2)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3, base_lr=0.2)),
    ("PolyScheduler", dict(max_update=12, base_lr=1e-4, pwr=1,
                           warmup_steps=4)),
    ("PolyScheduler", dict(max_update=10, base_lr=0.1, pwr=2,
                           final_lr=0.001)),
    ("CosineScheduler", dict(max_update=15, base_lr=0.1, final_lr=0.001,
                             warmup_steps=3, warmup_begin_lr=0.0)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_values_equal_jax(name, kw):
    j = getattr(jlr, name)(**kw)
    t = getattr(tlr, name)(**kw)
    assert [t(n) for n in range(20)] == [j(n) for n in range(20)]


def test_scheduler_refusals_match_jax():
    for mod, err in ((jlr, mx.MXNetError), (tlr, MXNetError)):
        with pytest.raises(err, match="warmup_mode"):
            mod.LRScheduler(warmup_mode="cubic")
        with pytest.raises(err, match="step must be >= 1"):
            mod.FactorScheduler(step=0)
        with pytest.raises(err, match="increasing"):
            mod.MultiFactorScheduler(step=[3, 2])


def test_scheduled_trainer_rates_equal_jax():
    """A Trainer with a PolyScheduler: its learning_rate before each step
    and the weights after it, against the JAX package."""
    def sched(mod):
        return mod.PolyScheduler(max_update=12, base_lr=1e-2, pwr=1,
                                 warmup_steps=4)
    kw = {"learning_rate": 1e-2, "wd": 0.01, "epsilon": 1e-6}
    jnet, tnet = quad_pair(seed=10)
    jtr = jgluon.Trainer(jnet.collect_params(), "lamb",
                         dict(kw, lr_scheduler=sched(jlr)))
    ttr = tgluon.Trainer(tnet.collect_params(), "lamb",
                         dict(kw, lr_scheduler=sched(tlr)))
    for k in range(6):
        assert ttr.learning_rate == jtr.learning_rate
        want = jax_steps(jnet, jtr, seed=10 + k, steps=1)
        got = port_steps(tnet, ttr, seed=10 + k, steps=1)
        assert_runs_close(got, want, what=f"lamb step {k}")
