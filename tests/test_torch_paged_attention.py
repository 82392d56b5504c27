"""PyTorch port: paged attention's plain version against the JAX package,
and the device dispatch.

The port's `ops.fused.paged_attention_ref` (the CPU path of
`ops.fused.paged_attention`, and the oracle the CUDA kernel is held
against on the card by chip_smoke.py) must compute what the JAX package's
`paged_attention_ref` and its Pallas kernel (`paged_attention_fwd`, run in
interpret mode as tests/test_decode.py runs it) compute, from the same
numpy inputs: float slabs, int8 slabs with per-position scales (the
kernel's quantized variant), and q and slab of different float dtypes.
The CUDA kernel itself only runs on the card.
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
# int8 slabs: the dequantized K/V reach |code * scale| <= 127 * 0.11 = 14,
# so scores and outputs are larger; f32 summation order on both sides
# (tests/test_decode.py holds the Pallas kernel to the same 2e-5)
INT8_TOL = dict(rtol=2e-5, atol=2e-5)


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



def _int8_inputs(C, seed):
    """int8 codes and f32 per-position scales, as tests/test_decode.py
    makes them, with ragged lengths including 0 and T - C."""
    rng = np.random.RandomState(seed)
    kc = rng.randint(-127, 128, (S + 1, L, T, H, D)).astype(np.int8)
    vc = rng.randint(-127, 128, (S + 1, L, T, H, D)).astype(np.int8)
    ks = (rng.rand(S + 1, L, T) * 0.1 + 0.01).astype(np.float32)
    vs = (rng.rand(S + 1, L, T) * 0.1 + 0.01).astype(np.float32)
    q = rng.randn(S, C, H, D).astype(np.float32)
    lens = np.array([0, 7, T - C, 16], dtype=np.int32)
    return q, kc, vc, ks, vs, lens


def _port_int8(q, kc, vc, ks, vs, lens, layer, extent=None):
    t = [torch.from_numpy(a) for a in (kc, vc, ks, vs)]
    if extent is not None:
        t = [a[:, :, :extent] for a in t]
    kt, vt, kst, vst = t
    return fused.paged_attention(torch.from_numpy(q), kt, vt,
                                 torch.from_numpy(lens), layer,
                                 k_scale=kst, v_scale=vst).numpy()


@pytest.mark.parametrize("C", [1, 3])
def test_int8_plain_matches_jax_reference_and_pallas_kernel(C):
    """The dequant `codes.float() * scale` before the score product, at a
    non-zero layer, against the JAX reference and the TPU kernel's
    quantized variant in interpret mode."""
    q, kc, vc, ks, vs, lens = _int8_inputs(C, seed=60 + C)
    got = _port_int8(q, kc, vc, ks, vs, lens, 1)
    jargs = [jnp.asarray(a) for a in (q, kc, vc)] + [jnp.asarray(lens), 1]
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = np.asarray(jfused.paged_attention_ref(*jargs, **jsc))
    np.testing.assert_allclose(got, want, **INT8_TOL)
    pallas = PK.paged_attention_fwd(*jargs, interpret=True, **jsc)
    assert pallas is not None
    np.testing.assert_allclose(got, np.asarray(pallas), **INT8_TOL)


def test_int8_extent_view_reads_codes_and_scales_in_place():
    """The chunk program's extent view cuts the codes AND the scales on
    the position axis; the read equals the JAX reference on the cut and
    the full-slab read."""
    extent, C = 32, 3
    q, kc, vc, ks, vs, lens = _int8_inputs(C, seed=70)
    lens = np.minimum(lens, extent - C).astype(np.int32)
    got = _port_int8(q, kc, vc, ks, vs, lens, 1, extent=extent)
    want = np.asarray(jfused.paged_attention_ref(
        *[jnp.asarray(a[:, :, :extent]) if a.ndim == 5 else jnp.asarray(a)
          for a in (q, kc, vc)], jnp.asarray(lens), 1,
        k_scale=jnp.asarray(ks[:, :, :extent]),
        v_scale=jnp.asarray(vs[:, :, :extent])))
    np.testing.assert_allclose(got, want, **INT8_TOL)
    np.testing.assert_allclose(got, _port_int8(q, kc, vc, ks, vs, lens, 1),
                               **INT8_TOL)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("bfloat16", "int8"), ("float32", "float16")])
def test_mixed_float_pairs_match_jax_reference(q_dtype, kv_dtype):
    """q of one dtype over a slab of another, as a pool whose kv_dtype
    differs from the model's gives it: f32 inside, the output in q's
    dtype. Where q is bfloat16 both sides round one f32 value, so they may
    part by one bf16 step (2^-8 of the value)."""
    import ml_dtypes
    q, k, v, lens = _inputs(3, seed=81)
    jdt = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
           "float32": np.float32}
    scales = {}
    if kv_dtype == "int8":
        _, k, v, ks, vs, _ = _int8_inputs(3, seed=82)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.astype(jdt[kv_dtype]), v.astype(jdt[kv_dtype])
    qj = q.astype(jdt[q_dtype])
    want = np.asarray(jfused.paged_attention_ref(
        jnp.asarray(qj), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        1, **{n: jnp.asarray(a) for n, a in scales.items()}))

    def tt(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a)

    got = fused.paged_attention(
        tt(qj), tt(k), tt(v), torch.from_numpy(lens), 1,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    assert got.dtype == (torch.bfloat16 if q_dtype == "bfloat16"
                         else torch.float32)
    got = got.float().numpy()
    want = want.astype(np.float32)
    if q_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_kernel_wrapper_refuses_int8_without_scales_and_float_with():
    """An int8 slab needs both scales and a float slab takes none: the
    wrapper raises before it looks at the device."""
    q, kc, vc, ks, vs, lens = _int8_inputs(1, seed=90)
    args = [torch.from_numpy(a) for a in (q, kc, vc)] + [
        torch.from_numpy(lens), 1]
    with pytest.raises(MXNetError, match="need k_scale and v_scale"):
        kernels.paged_attention_cuda(*args)
    with pytest.raises(MXNetError, match="need k_scale and v_scale"):
        kernels.paged_attention_cuda(*args, k_scale=torch.from_numpy(ks))
    fargs = [torch.from_numpy(a) for a in _inputs(1, seed=91)]
    with pytest.raises(MXNetError, match="float slabs take none"):
        kernels.paged_attention_cuda(
            fargs[0], fargs[1], fargs[2], fargs[3], 1,
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert kernels.launch_counts()["paged_attention_int8"] == 0
