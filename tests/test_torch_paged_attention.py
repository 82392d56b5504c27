"""PyTorch port: paged attention's plain version against the JAX package,
and the device dispatch.

The port's `ops.fused.paged_attention_ref` (the CPU path of
`ops.fused.paged_attention`, and the oracle the CUDA kernel is held
against on the card by chip_smoke.py) must compute what the JAX package's
`paged_attention_ref` and its Pallas kernel (`paged_attention_fwd`, run in
interpret mode as tests/test_decode.py runs it) compute, from the same
numpy inputs. The CUDA kernel itself only runs on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu.ops import pallas_kernels as PK
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.ops import fused, kernels

torch.set_num_threads(1)

S, H, D, T, L = 4, 4, 8, 48, 2
WINDOW = 16
# f32 on both sides; only the summation order differs
ATOL = 1e-5


def _inputs(C, seed):
    rng = np.random.RandomState(seed)
    k = rng.randn(S + 1, L, T, H, D).astype(np.float32)
    v = rng.randn(S + 1, L, T, H, D).astype(np.float32)
    q = rng.randn(S, C, H, D).astype(np.float32)
    # ragged, including an empty lane and a lane at the page end
    lens = np.array([0, 7, T - 1, 16], dtype=np.int32)
    return q, k, v, lens


def _port(q, k, v, lens, layer, extent=None):
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if extent is not None:
        kt, vt = kt[:, :, :extent], vt[:, :, :extent]
    return fused.paged_attention(torch.from_numpy(q), kt, vt,
                                 torch.from_numpy(lens), layer).numpy()


@pytest.mark.parametrize("C", [1, 3, WINDOW])
def test_plain_matches_jax_reference(C):
    q, k, v, lens = _inputs(C, seed=C)
    want = np.asarray(jfused.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), 1))
    np.testing.assert_allclose(_port(q, k, v, lens, 1), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("C", [1, 3, WINDOW])
def test_plain_matches_pallas_kernel_interpret(C):
    q, k, v, lens = _inputs(C, seed=10 + C)
    want = PK.paged_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens), 1,
                                  interpret=True)
    assert want is not None
    np.testing.assert_allclose(_port(q, k, v, lens, 1), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("C", [1, WINDOW])
def test_extent_view_matches_jax_and_full_read(C):
    """A slab view cut on the position axis (the engine's extent ladder)
    reads in place; with every lane's lengths + C inside the cut it gives
    the full slab's result."""
    extent = 32
    q, k, v, lens = _inputs(C, seed=20 + C)
    lens = np.minimum(lens, extent - C).astype(np.int32)
    got = _port(q, k, v, lens, 0, extent=extent)
    want = np.asarray(jfused.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k[:, :, :extent]),
        jnp.asarray(v[:, :, :extent]), jnp.asarray(lens), 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _port(q, k, v, lens, 0), rtol=0,
                               atol=ATOL)


def test_plain_version_keeps_dtype_and_computes_in_f32():
    q, k, v, lens = _inputs(3, seed=30)
    qb = torch.from_numpy(q).bfloat16()
    kb = torch.from_numpy(k).bfloat16()
    vb = torch.from_numpy(v).bfloat16()
    out = fused.paged_attention(qb, kb, vb, torch.from_numpy(lens), 1)
    assert out.dtype == torch.bfloat16 and out.shape == qb.shape
    f32 = fused.paged_attention_ref(qb.float(), kb.float(), vb.float(),
                                    torch.from_numpy(lens), 1)
    # the only bf16 step is the final cast of an f32 result
    torch.testing.assert_close(out, f32.bfloat16(), rtol=0, atol=0)


def test_cpu_tensors_take_plain_version_and_never_launch():
    q, k, v, lens = _inputs(1, seed=40)
    kernels.reset_launch_counts()
    _port(q, k, v, lens, 1)
    assert kernels.paged_attention_launches == 0
    counts = kernels.launch_counts()
    assert counts["paged_attention"] == 0
    assert counts == dict.fromkeys(counts, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it launches or
    raises."""
    q, k, v, lens = _inputs(1, seed=50)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lens), 1)
    assert kernels.paged_attention_launches == 0

