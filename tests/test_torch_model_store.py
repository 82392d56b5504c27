"""PyTorch port: the local pretrained-weight store
(`gluon.model_zoo.model_store`) and `pretrained=True`, against the JAX
package's.

  * `save_params_file` writes the JAX package's bytes for the same arrays
    (float32, float16, bfloat16 (both write it as float32), int8, int64,
    0-d), and each package's reader reads the other's file to the same
    arrays, as well as hand-made records of the other kinds the reader
    takes (bfloat16 widened, V1, legacy, V3 "none", "arg:"/"aux:" names);
  * `resnet18_v1(pretrained=True, root=..., device="cpu")` holds exactly
    the values the JAX net loads from the same `.params` or `.npz` file,
    and its forward agrees with the JAX net's (1e-4: a ResNet-18 in
    float32, two libraries' convolutions);
  * a missing file raises the JAX package's message (C19: the port raised
    "not supported" before);
  * `auto_name_map` and `convert_params_to_npz` give the JAX package's
    results.
Every test runs inside `process_state_kept()`.
"""
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.gluon.model_zoo import model_store as jstore
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo import detection as tdet
from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from torch_port_utils import jax_values, port_values, process_state_kept

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept():
        yield


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f16": rng.randn(5).astype(np.float16),
        "i8": rng.randint(-128, 127, (2, 3, 2)).astype(np.int8),
        "i64": rng.randint(-2 ** 40, 2 ** 40, (4,)).astype(np.int64),
        "scalar": np.asarray(np.float32(2.5)),
        "u8": rng.randint(0, 255, (3,)).astype(np.uint8),
    }


def test_save_params_file_writes_the_jax_bytes(tmp_path):
    arrays = _arrays()
    bf16 = np.random.RandomState(1).randn(2, 3).astype(ml_dtypes.bfloat16)
    jfile, tfile = tmp_path / "j.params", tmp_path / "t.params"
    jstore.save_params_file(str(jfile), {**arrays, "bf16": bf16})
    tstore.save_params_file(str(tfile), {
        **arrays,
        "bf16": torch.from_numpy(bf16.view(np.int16)).view(torch.bfloat16)})
    assert tfile.read_bytes() == jfile.read_bytes()
    # tensors (and a non-contiguous view) write as the arrays do
    t2 = tmp_path / "t2.params"
    tstore.save_params_file(str(t2), {
        k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    j2 = tmp_path / "j2.params"
    jstore.save_params_file(str(j2), arrays)
    assert t2.read_bytes() == j2.read_bytes()
    view = np.arange(12, dtype=np.float32).reshape(3, 4).T
    tstore.save_params_file(str(t2), {"v": view})
    jstore.save_params_file(str(j2), {"v": view})
    assert t2.read_bytes() == j2.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_reads_the_others_file(writer, tmp_path):
    arrays = _arrays(2)
    path = str(tmp_path / "w.params")
    (jstore if writer == "jax" else tstore).save_params_file(path, arrays)
    for store in (jstore, tstore):
        got = store.load_params_file(path)
        assert list(got) == list(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)


def _record(magic, shape, flag, payload, legacy=False):
    """One hand-made ndarray record of the reference's format."""
    if legacy:
        head = struct.pack("<I", len(shape)) + struct.pack(
            f"<{len(shape)}I", *shape)
    elif magic == 0xF993FAC8:
        head = struct.pack("<Ii", magic, len(shape)) + struct.pack(
            f"<{len(shape)}q", *shape)
    else:
        head = struct.pack("<Iii", magic, 0, len(shape)) + struct.pack(
            f"<{len(shape)}q", *shape)
    return head + struct.pack("<iii", 1, 0, flag) + payload


def test_both_readers_agree_on_every_record_kind(tmp_path):
    bf = np.array([1.5, -2.25, 3e38, 1e-40], np.float32)
    bf_raw = (bf.view(np.uint32) >> 16).astype(np.uint16)
    f64 = np.array([[1.0, 2.0]], np.float64)
    recs = [
        _record(0xF993FAC9, (4,), 12, bf_raw.tobytes()),          # bf16
        _record(0xF993FAC8, (1, 2), 1, f64.tobytes()),            # V1
        _record(0, (3,), 4, np.arange(3, dtype=np.int32).tobytes(),
                legacy=True),                                     # legacy
        struct.pack("<Iii", 0xF993FACA, 0, -1),                   # V3 none
    ]
    names = ["arg:w", "aux:s", "arg:b", "aux:n"]
    blob = struct.pack("<QQQ", 0x112, 0, len(recs)) + b"".join(recs)
    blob += struct.pack("<Q", len(names)) + b"".join(
        struct.pack("<Q", len(n)) + n.encode() for n in names)
    path = tmp_path / "kinds.params"
    path.write_bytes(blob)
    for keep in (False, True):
        j = jstore.load_params_file(str(path), keep_prefixes=keep)
        t = tstore.load_params_file(str(path), keep_prefixes=keep)
        assert list(t) == list(j)
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(
        tstore.load_params_file(str(path))["w"],
        (bf_raw.astype(np.uint32) << 16).view(np.float32))
    # a truncated file and a foreign one are refused by both
    (tmp_path / "short.params").write_bytes(blob[:40])
    (tmp_path / "bad.params").write_bytes(b"\0" * 32)
    for name, what in (("short", "truncated"), ("bad", "bad magic")):
        with pytest.raises(MXNetError, match=what):
            tstore.load_params_file(str(tmp_path / f"{name}.params"))
        with pytest.raises(JMXNetError, match=what):
            jstore.load_params_file(str(tmp_path / f"{name}.params"))


def _resnet18_values(seed=3, layout="NCHW"):
    """Values of every ResNet-18 v1 parameter (the JAX net's shapes in
    `layout`): weights scaled by their fan-in, running variances and
    gammas near 1, so the activations stay near unit size."""
    jnet = jvision.resnet18_v1(layout=layout)
    jnet.initialize()
    shape = (1, 3, 32, 32) if layout == "NCHW" else (1, 32, 32, 3)
    jnet(jmx.np.zeros(shape))
    rng = np.random.RandomState(seed)
    out = {}
    for n, p in jnet.collect_params().items():
        v = rng.randn(*p.shape).astype(np.float32)
        if n.endswith("running_var") or n.endswith("gamma"):
            v = np.abs(v) * 0.1 + 1.0
        elif n.endswith("weight"):
            fan_in = p.shape[1] if len(p.shape) == 2 else (
                int(np.prod(p.shape[1:])) if layout == "NCHW"
                else int(np.prod(p.shape[:3])))
            v = v / np.sqrt(fan_in)
        else:
            v = v * 0.1
        out[n] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("fmt", ["params", "npz"])
def test_pretrained_resnet18_equals_the_jax_net(fmt, tmp_path):
    values = _resnet18_values()
    path = str(tmp_path / f"resnet18_v1.{fmt}")
    if fmt == "params":
        tstore.save_params_file(path, values)
    else:
        np.savez(path, **values)
    jnet = jvision.resnet18_v1(pretrained=True, root=str(tmp_path))
    tnet = tvision.resnet18_v1(pretrained=True, root=str(tmp_path),
                               device="cpu")
    got, want = port_values(tnet), jax_values(jnet)
    assert sorted(got) == sorted(want) == sorted(values)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    jout = jnet(jmx.np.array(x)).asnumpy()
    tout = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)


def test_pretrained_channels_last_resnet_loads_the_file_layout(tmp_path):
    """A channels-last net's file holds its convolutions' weights kernel
    dims first (the JAX package's layout); the port's net takes them in
    its own layout and holds the JAX net's values."""
    values = _resnet18_values(5, layout="NHWC")
    tstore.save_params_file(str(tmp_path / "resnet18_v1.params"), values)
    jnet = jvision.resnet18_v1(pretrained=True, root=str(tmp_path),
                               layout="NHWC")
    tnet = tvision.resnet18_v1(pretrained=True, root=str(tmp_path),
                               layout="NHWC", device="cpu")
    got, want = port_values(tnet), jax_values(jnet)
    for n in values:
        np.testing.assert_array_equal(got[n], values[n], err_msg=n)
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("make,name", [
    (lambda m, **k: m.resnet18_v1(**k), "resnet18_v1"),
    (lambda m, **k: m.get_model("mobilenet0.25", **k), "mobilenet0.25"),
    (lambda m, **k: m.vgg11_bn(**k), "vgg11_bn")],
    ids=["resnet18_v1", "mobilenet0.25", "vgg11_bn"])
def test_missing_weights_raise_the_jax_message(make, name, tmp_path):
    """C19: each constructor looks for `<root>/<name>.npz` / `.params` and
    raises the JAX package's message when neither is there."""
    with pytest.raises(JMXNetError) as jerr:
        make(jvision, pretrained=True, root=str(tmp_path))
    with pytest.raises(MXNetError) as terr:
        make(tvision, pretrained=True, root=str(tmp_path), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert f"no pretrained weights for {name!r}" in str(terr.value)


def test_get_model_file_prefers_npz_and_reads_mxnet_home(tmp_path,
                                                         monkeypatch):
    (tmp_path / "models").mkdir()
    for ext in (".params", ".npz"):
        (tmp_path / "models" / f"m{ext}").write_bytes(b"")
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert tstore.get_model_file("m") == jstore.get_model_file("m") \
        == str(tmp_path / "models" / "m.npz")
    os.remove(tmp_path / "models" / "m.npz")
    assert tstore.get_model_file("m").endswith("m.params")


def test_ssd_pretrained_reads_its_file(tmp_path):
    net = tdet.ssd_300_vgg16(classes=3, device="cpu")
    net(torch.zeros((1, 3, 300, 300)))
    values = port_values(net)
    values = {k: np.full_like(v, 0.25) for k, v in values.items()}
    tstore.save_params_file(str(tmp_path / "ssd_300_vgg16.params"), values)
    loaded = tdet.ssd_300_vgg16(classes=3, pretrained=True,
                                root=str(tmp_path), device="cpu")
    got = port_values(loaded)
    assert sorted(got) == sorted(values)
    assert all((v == 0.25).all() for v in got.values())


def test_auto_name_map_and_conversion_match_jax(tmp_path):
    """A reference-style checkpoint (flat scoped names in construction
    order, Module-era "arg:"/"aux:" groups) maps to the same structural
    names in both packages, and converts to the same npz."""
    values = _resnet18_values(6)
    jnet = jvision.resnet18_v1()
    jnet.initialize()
    jnet(jmx.np.zeros((1, 3, 32, 32)))
    aux = {n for n, p in jnet.collect_params().items()
           if p.grad_req == "null"}
    ref = {}
    for i, (n, v) in enumerate(values.items()):
        ref[("aux:" if n in aux else "arg:") + f"resnetv10_p{i}"] = v
    path = str(tmp_path / "ref.params")
    tstore.save_params_file(path, ref)
    tmap = tstore.auto_name_map(path, "resnet18_v1")
    jmap = jstore.auto_name_map(path, "resnet18_v1")
    assert tmap == jmap and len(tmap) == len(values)
    tnpz, jnpz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tstore.convert_params_to_npz(path, tnpz, tmap)
    jstore.convert_params_to_npz(path, jnpz, jmap)
    with np.load(tnpz) as t, np.load(jnpz) as j:
        assert sorted(t.files) == sorted(j.files) == sorted(values)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(MXNetError, match="unknown model-zoo"):
        tstore.auto_name_map(path, "resnet19_v1")
    with pytest.raises(MXNetError, match="architecture mismatch"):
        tstore.auto_name_map(path, "resnet34_v1")
