"""PyTorch port: `gluon.utils` against the JAX package's.

`split_data` and `split_and_load` must give the JAX package's slices
exactly (they copy, they do not compute); `clip_global_norm` must return
the JAX package's norm and leave the arrays scaled as its arrays are,
within 1e-6 relative (float32 sums of squares in another order).
"""
import hashlib

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import utils as jutils

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon import utils as tutils

torch.set_num_threads(1)

RTOL = 1e-6


def _data(shape=(6, 4, 3), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("num_slice,batch_axis,even", [
    (3, 0, True), (2, 1, True), (4, 0, False), (1, 0, True)])
def test_split_data_matches_jax(num_slice, batch_axis, even):
    x = _data()
    want = [s.asnumpy() for s in jutils.split_data(
        mx.np.array(x), num_slice, batch_axis, even)]
    got = tutils.split_data(torch.from_numpy(x), num_slice, batch_axis,
                            even)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_split_data_refuses_an_uneven_split():
    with pytest.raises(MXNetError, match="evenly split"):
        tutils.split_data(torch.zeros(5, 2), 2)
    with pytest.raises(mx.MXNetError, match="evenly split"):
        jutils.split_data(mx.np.zeros((5, 2)), 2)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_split_and_load_matches_jax(n_dev):
    """One device gives [data] moved there (the JAX package's one-device
    case); several give one slice each, on its device."""
    x = _data()
    want = [s.asnumpy() for s in jutils.split_and_load(
        mx.np.array(x), [mx.cpu()] * n_dev)]
    got = tutils.split_and_load(x, ["cpu"] * n_dev)
    assert len(got) == len(want) == n_dev
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e3],
                         ids=["clips", "clips_less", "no_clip"])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(*s).astype(np.float32) * 0.3
              for s in ((4, 5), (7,), (2, 3, 3))]
    jarrs = [mx.np.array(a) for a in arrays]
    jnorm = float(jutils.clip_global_norm(jarrs, max_norm).asnumpy())
    tarrs = [torch.from_numpy(a.copy()) for a in arrays]
    tnorm = tutils.clip_global_norm(tarrs, max_norm)
    assert tnorm.dtype == torch.float32 and tnorm.dim() == 0
    assert float(tnorm) == pytest.approx(jnorm, rel=RTOL)
    for t, j, a in zip(tarrs, jarrs, arrays):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=RTOL,
                                   atol=0)
        if max_norm > jnorm:
            np.testing.assert_array_equal(t.numpy(), a)


def test_clip_global_norm_refuses_no_arrays():
    with pytest.raises(MXNetError, match="must not be empty"):
        tutils.clip_global_norm([], 1.0)


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert tutils.check_sha1(str(f), digest)
    assert jutils.check_sha1(str(f), digest)
    assert not tutils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError, match="network"):
        tutils.download("http://localhost/none")
