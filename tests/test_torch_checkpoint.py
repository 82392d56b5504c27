"""PyTorch port: checkpoints cross between the packages, both ways, on the
CPU.

`save_checkpoint` / `load_checkpoint`: an npz written by either package
(v2 escape-safe keys, a v1 file's legacy keys, a dict or a Block, with a
`.trainer` sidecar) loads in the other bit-exactly — a channels-last
convolution's weight kernel dims first in the file, as both write it.
`MANIFEST.json` written by either package's `commit_step` is read by the
other's `latest_entry` / `latest_step`. A JAX `gluon.Trainer` state saved
beside its net continues in the port (2 SGD-with-momentum and 2 Adam steps)
within 1e-6 (absolute; weights of magnitude ~1) of the JAX package's own
continuation (float32: both evaluate the same expressions on the same
values; Adam's scalars such as 1 - beta1 round once to float32 in JAX and
in float64 first in the port, as `test_torch_trainer.py` sets out).
"""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import checkpoint as jckpt
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import checkpoint as tckpt
from incubator_mxnet_tpu_torch import gluon as tgluon

from test_torch_trainer import jax_steps, port_steps, quad_pair
from torch_port_utils import jax_fault_restored, resnet_pair

torch.set_num_threads(1)

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _faults_untouched():
    with jax_fault_restored():
        yield


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "f64": rng.randn(5),                   # float64 stays exact
            "ids": rng.randint(0, 9, (4,)).astype(np.int32),
            "nested": {"a__b": rng.randn(2).astype(np.float32),
                       "c_d": rng.randn(2, 2).astype(np.float32),
                       "layers": [np.float32(1.5) * np.ones(3, np.float32),
                                  np.arange(4, dtype=np.float32)]}}


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k]
        g = g.asnumpy() if hasattr(g, "asnumpy") else np.asarray(g)
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_dict_crosses_bit_exact(writer, tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(path, tree, step=7)
        got, step = tckpt.load_checkpoint(path, as_numpy=True)
    else:
        tckpt.save_checkpoint(path, tree, step=7)
        got, step = jckpt.load_checkpoint(path, as_numpy=True)
    assert step == 7
    _assert_same(got, _flat(tree))


def test_npz_tensors_and_ndarrays_save_as_the_jax_package_reads(tmp_path):
    g = torch.Generator().manual_seed(1)
    t = torch.randn(3, 2, generator=g)
    tree = {"t": t, "bf16": t.bfloat16(),
            "nd": tmx.np.array(np.arange(4, dtype=np.float32), device=CPU)}
    path = tckpt.save_checkpoint(str(tmp_path / "c"), tree)
    got, step = jckpt.load_checkpoint(path, as_numpy=True)
    assert step is None
    np.testing.assert_array_equal(got["t"], t.numpy())
    # bfloat16 is written as float32 (exact), which numpy can hold
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], t.bfloat16().float().numpy())
    np.testing.assert_array_equal(got["nd"], np.arange(4, dtype=np.float32))
    # as NDArrays on a device: float64 narrows to float32 as in the JAX
    # package (as_numpy keeps it)
    nd, _ = tckpt.load_checkpoint(str(tmp_path / "c"), device=CPU)
    assert isinstance(nd["t"], tmx.NDArray) and nd["t"].dtype == np.float32


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_npz_v1_legacy_keys_decode_alike(reader, tmp_path):
    # v1 files (no __fmt__) mapped '/' to '__' in their keys
    path = str(tmp_path / "v1.npz")
    np.savez(path, __step__=np.asarray(4), layer__w=np.ones(2),
             head=np.zeros(3))
    mod = jckpt if reader == "jax" else tckpt
    got, step = mod.load_checkpoint(path, as_numpy=True)
    assert step == 4 and sorted(got) == ["head", "layer/w"]
    other = (tckpt if reader == "jax" else jckpt).load_checkpoint(
        path, as_numpy=True)[0]
    _assert_same(got, other)


def _trained_resnets():
    """A JAX and a port ResNet (NHWC, thumbnail stem) with the same values,
    each with a Trainer one SGD-momentum step along (states created)."""
    jnet, tnet = resnet_pair(thumbnail=True, seed=3)
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(kw))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(kw))
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    y = np.array([1, 7], np.float32)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    from incubator_mxnet_tpu import autograd as jag
    from incubator_mxnet_tpu_torch import autograd as tag
    with jag.record():
        L = jloss(jnet(jmx.np.array(x)), jmx.np.array(y))
    L.backward()
    jtr.step(2)
    with tag.record():
        L = tloss(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    tag.backward(L)
    ttr.step(2)
    return (jnet, jtr), (tnet, ttr), kw


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_block_with_trainer_sidecar_crosses(writer, tmp_path):
    (jnet, jtr), (tnet, ttr), kw = _trained_resnets()
    path = str(tmp_path / "net")
    if writer == "jax":
        jckpt.save_checkpoint(path, jnet, step=1, trainer=jtr)
        want = {k: np.asarray(p.data().asnumpy())
                for k, p in jnet.collect_params().items()
                if p._data is not None}
        fresh, _ = resnet_pair(thumbnail=True, seed=11)[1], None
        tr = tgluon.Trainer(fresh.collect_params(), "sgd", dict(kw))
        params, step = tckpt.load_checkpoint(path, net=fresh, trainer=tr,
                                             as_numpy=True)
        got = {k: fresh._file_layout(k, p._data)
               for k, p in fresh.collect_params().items()}
        assert tr.optimizer.num_update == jtr.optimizer.num_update == 1
    else:
        tckpt.save_checkpoint(path, tnet, step=1, trainer=ttr)
        want = {k: tnet._file_layout(k, p._data)
                for k, p in tnet.collect_params().items()}
        fresh = resnet_pair(thumbnail=True, seed=11)[0]
        tr = jgluon.Trainer(fresh.collect_params(), "sgd", dict(kw))
        params, step = jckpt.load_checkpoint(path, net=fresh, trainer=tr,
                                             as_numpy=True)
        got = {k: np.asarray(p.data().asnumpy())
               for k, p in fresh.collect_params().items()}
        assert tr._optimizer.num_update == 1
    assert step == 1
    # the file holds the writer's values in the JAX package's layout, and
    # the reader's net took each of them bit-exactly
    _assert_same(params, want)
    _assert_same(got, want)
    assert os.path.exists(path + ".npz.trainer")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_crosses(writer, tmp_path):
    d = str(tmp_path / "m")
    w, r = (jckpt, tckpt) if writer == "jax" else (tckpt, jckpt)
    extra = {"resilient": {"skipped_nonfinite": 2, "step_retries": 1}}
    for s in (2, 4, 6):
        w.save_checkpoint(os.path.join(d, f"ckpt-{s}"),
                          {"w": np.full(3, float(s))}, step=s)
        w.commit_step(d, s, kind="npz", path=f"ckpt-{s}.npz", keep_last=2,
                      extra=extra)
    entry = r.latest_entry(d)
    assert entry == {"step": 6, "kind": "npz", "path": "ckpt-6.npz",
                     "extra": extra}
    assert r.latest_step(d) == 6
    assert not os.path.exists(os.path.join(d, "ckpt-2.npz"))
    # the reader commits on top; the writer sees it
    r.commit_step(d, 8, kind="npz", path="ckpt-6.npz", keep_last=3)
    assert w.latest_step(d) == 8
    assert [e["step"] for e in w._read_manifest(d)["committed"]] == [4, 6, 8]


@pytest.mark.parametrize("rule,kw", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.05, "wd": 0.01})])
def test_jax_trainer_state_continues_in_the_port(rule, kw, tmp_path):
    """Two steps in the JAX package, then `save_checkpoint(net, trainer=)`;
    a fresh port net and Trainer load it and take 2 more steps, equal to
    the JAX package's own 2 more within 1e-6."""
    jnet, _ = quad_pair(seed=5)
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(kw))
    jax_steps(jnet, jtr, seed=5, steps=2)
    path = str(tmp_path / "quad")
    jckpt.save_checkpoint(path, jnet, step=2, trainer=jtr)
    tnet = quad_pair(seed=6)[1]
    ttr = tgluon.Trainer(tnet.collect_params(), rule, dict(kw))
    _, step = tckpt.load_checkpoint(path, net=tnet, trainer=ttr,
                                    as_numpy=True)
    assert step == 2 and ttr.optimizer.num_update == 2
    got = port_steps(tnet, ttr, seed=5, steps=4, start=2)
    want = jax_steps(jnet, jtr, seed=5, steps=4, start=2)
    for k, (g, w) in enumerate(zip(got, want)):
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=0,
                                       atol=1e-6,
                                       err_msg=f"{rule} step {k} {name}")
