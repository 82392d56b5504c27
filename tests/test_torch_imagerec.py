"""PyTorch port: `io.ImageRecordIter` over `tests/data/tiny_imagerec.rec`
(12 JPEG records of 44-66 px) against the JAX package's, on the CPU.

Data, labels and pad are bit-equal (both packages decode through the same
augment spec: `native/imagerec.cc` and `io/_imagerec_common.py`, each
package its own copy) in every mode: the float32 and uint8 handoffs; random
crop, mirror, resize, mean/std; shuffle; round_batch on and off; two
epochs; the native thread pool, two shared-memory worker processes and the
PIL path. A corrupt record gives label -1 and zero pixels; transient
submit errors and a dying worker are restarted within their budget. The
card half (device_augment) is bit-equal to the JAX package's where no
draw decides (no mirror), and to the plain augment on the port's draws
otherwise.
"""
import os

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.ops import fused

torch.set_num_threads(1)

REC = os.path.join(os.path.dirname(__file__), "data", "tiny_imagerec.rec")
AUG = dict(rand_crop=True, rand_mirror=True, resize=40)
NORM = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.4,
            std_g=57.1, std_b=57.4)


def _native_available():
    from incubator_mxnet_tpu_torch.native import load_imagerec
    return load_imagerec() is not None


def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _pair(**kw):
    kw.setdefault("data_shape", (32, 32, 3))
    kw.setdefault("batch_size", 5)
    j = jio.ImageRecordIter(REC, **kw)
    t = tio.ImageRecordIter(REC, device="cpu", **kw)
    return j, t


def _assert_same(j, t, epochs=2):
    want, got = _batches(j, epochs), _batches(t, epochs)
    j.close()
    t.close()
    assert len(got) == len(want) > 0
    for (wd, wl, wp), (gd, gl, gp) in zip(want, got):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    return got


MODES = {
    "float32-center": {},
    "float32-augment": AUG,
    "float32-augment-norm": dict(AUG, **NORM),
    "float32-shuffle": dict(AUG, shuffle=True, seed=4),
    "float32-no-round-batch": dict(AUG, round_batch=False),
    "float32-legacy-shape": dict(AUG, data_shape=(3, 28, 30)),
    "uint8": dict(AUG, handoff="uint8"),
    "uint8-shuffle-big-batch": dict(AUG, handoff="uint8", shuffle=True,
                                    batch_size=16),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_thread_mode_batches_are_the_jax_packages(mode):
    if not _native_available():
        pytest.skip("libjpeg headers missing: no native decoder here")
    j, t = _pair(**MODES[mode])
    assert t.decode_route == "native"
    _assert_same(j, t)


@pytest.mark.parametrize("mode", ["float32-augment-norm", "uint8"])
def test_two_worker_processes_give_the_jax_packages_batches(mode):
    j, t = _pair(workers=2, **MODES[mode])
    assert t._pool.mode == "processes"
    assert t.decode_route.startswith("processes/")
    _assert_same(j, t)


@pytest.mark.parametrize("mode", ["float32-augment-norm",
                                  "uint8-shuffle-big-batch"])
def test_pil_path_gives_the_jax_packages_batches(mode):
    pytest.importorskip("PIL")
    j, t = _pair(**MODES[mode])
    j._force_python_fallback()
    t._force_python_fallback()
    assert t.decode_route == "python"
    _assert_same(j, t, epochs=1)


def test_corrupt_record_gives_label_minus_one(tmp_path):
    path = str(tmp_path / "bad.rec")
    w = trec.MXRecordIO(REC, "r")
    recs = [w.read() for _ in range(3)]
    w.close()
    h, _ = trec.unpack(recs[1])
    recs[1] = trec.pack(trec.IRHeader(0, 9.0, h.id, 0), b"\xff\xd8 broken")
    out = trec.MXRecordIO(path, "w")
    for r in recs:
        out.write(r)
    out.close()
    tio.io_stats(reset=True)
    kw = dict(data_shape=(24, 24, 3), batch_size=3)
    got = _batches(tio.ImageRecordIter(path, device="cpu", **kw))
    assert got[0][1][1, 0] == -1.0 and np.all(got[0][0][1] == 0)
    assert got[0][1][0, 0] != -1.0 and got[0][0][0].std() > 0
    assert tio.io_stats()["failed_records"] == 1
    want = _batches(jio.ImageRecordIter(path, **kw))
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_transient_submit_errors_restart_in_place(monkeypatch):
    if not _native_available():
        pytest.skip("libjpeg headers missing: no native decoder here")
    tio.io_stats(reset=True)
    t = tio.ImageRecordIter(REC, data_shape=(32, 32, 3), batch_size=5,
                            device="cpu", max_restarts=2, **AUG)
    real = t._pool.submit
    fails = iter([True, True, False, True, False])

    def flaky(*a, **k):
        if next(fails, False):
            raise OSError("flaky storage")
        return real(*a, **k)

    monkeypatch.setattr(t._pool, "submit", flaky)
    t.reset()
    got = _batches(t)
    want = _batches(jio.ImageRecordIter(REC, data_shape=(32, 32, 3),
                                        batch_size=5, **AUG), epochs=2)[3:]
    assert tio.io_stats()["submit_restarts"] == 3
    for (wd, wl, _), (gd, gl, _) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    # past the budget the original error surfaces
    monkeypatch.setattr(t._pool, "submit",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("gone for good")))
    with pytest.raises(OSError, match="gone for good"):
        t.reset()
    t.close()


def test_a_dying_worker_is_respawned_and_redecodes(monkeypatch):
    tio.io_stats(reset=True)
    monkeypatch.setenv("MXTPU_TEST_WORKER_DIE_BEFORE", "1")
    t = tio.ImageRecordIter(REC, data_shape=(32, 32, 3), batch_size=5,
                            device="cpu", workers=1, lookahead=1, **AUG)
    assert t._pool.mode == "processes"
    monkeypatch.delenv("MXTPU_TEST_WORKER_DIE_BEFORE")
    got = _batches(t)
    t.close()
    want = _batches(jio.ImageRecordIter(REC, data_shape=(32, 32, 3),
                                        batch_size=5, **AUG))
    assert tio.io_stats()["worker_restarts"] == 1
    for (wd, wl, _), (gd, gl, _) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_worker_death_past_the_budget_resurfaces(monkeypatch):
    monkeypatch.setenv("MXTPU_TEST_WORKER_DIE_BEFORE", "1")
    t = tio.ImageRecordIter(REC, data_shape=(32, 32, 3), batch_size=5,
                            device="cpu", workers=1, max_restarts=0)
    with pytest.raises(MXNetError, match="died"):
        _batches(t)
    t.close()


def test_device_augment_without_mirror_equals_the_jax_packages():
    kw = dict(AUG, rand_mirror=False, **NORM, device_augment=True,
              dtype="float32")
    j, t = _pair(**kw)
    want, got = _batches(j), _batches(t)
    j.close()
    t.close()
    for (wd, wl, wp), (gd, gl, gp) in zip(want, got):
        assert gd.dtype == wd.dtype == np.float32
        np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_augment_is_the_plain_augment_on_the_ports_draws(dtype):
    kw = dict(data_shape=(32, 32, 3), batch_size=4, **AUG, **NORM)
    t = tio.ImageRecordIter(REC, device="cpu", device_augment=True,
                            dtype=dtype, **kw)
    raw = tio.ImageRecordIter(REC, device="cpu", handoff="uint8",
                              **dict(kw, rand_mirror=False,
                                     **{k: 0.0 for k in NORM}))
    assert t._handoff_u8 and not t._host_mirror
    for cursor, (b, r) in enumerate(zip(t, raw)):
        u8 = r.data[0]._t
        draws = fused.augment_draws(t.augment_key(cursor * 4), 4, (32, 32),
                                    None, True, "cpu")
        want = fused._augment_apply(u8, *draws, None, t._mean, t._std,
                                    getattr(torch, dtype))
        assert torch.equal(b.data[0]._t, want)
    assert tio.io_stats()["device_augment_batches"] >= 3
    t.close()
    raw.close()


def test_knobs_and_refusals():
    with pytest.raises(MXNetError, match="RAW pixels"):
        tio.ImageRecordIter(REC, (32, 32, 3), 4, handoff="uint8",
                            mean_r=1.0, device="cpu")
    with pytest.raises(MXNetError, match="device_augment needs"):
        tio.ImageRecordIter(REC, (32, 32, 3), 4, handoff="float32",
                            device_augment=True, device="cpu")
    with pytest.raises(MXNetError, match="cuda"):
        tio.ImageRecordIter(REC, (32, 32, 3), 4)   # the card by default
    it = tio.ImageRecordIter(REC, (32, 32, 3), 5, device="cpu", lookahead=3,
                             round_batch=False)
    assert it._ahead == 3 and len(it) == 2 and it.num_records == 12
    it.close()
    with pytest.raises(MXNetError, match="A12"):
        tio.LibSVMIter("x.libsvm", (4,))
