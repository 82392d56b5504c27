"""PyTorch port: the float16 flash backward's operand split (B7, B8 on the
tensor cores) against the JAX package's `_flash_backward`.

The tensor-core sweeps take P and dS into their products as two float16
terms. In float16 they shift P by 2^15 and scale dS by a power of two per
output row first (`csrc/flash_attention.cu`; `attention.flash_bwd_split_ref`
emulates it on tensors: products and sums in float32). The same numpy
inputs, made from a seed, go through that emulation and through the JAX
`_flash_backward` with its Pallas kernels in interpret mode (as
tests/test_torch_flash_attention.py runs it), which computes dS in float32
and rounds dq, dk and dv to float16 once. dO is scaled over the range a
float16 backward sees: 2^-10 (no loss scaling), 2^-6, 1, 2^12 (a loss
scale).

Limits, the float16 ones chip_smoke.py holds the card's kernels to (the
bfloat16 limits scaled by float16's step, 2^-11 against 2^-8), each
relative to the output's own size: the largest error at most 1.25e-3 of
max |ref|, the rms error at most 6.25e-5 of rms |ref|. A plain two-term
split, without the row exponent, reads over the rms limit at 2^-10.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_attention as pa

from incubator_mxnet_tpu_torch.ops import attention

torch.set_num_threads(1)

MAX_REL = 1.25e-3
RMS_REL = 6.25e-5
BH, T, D = 2, 256, 64
SCALE = 1.0 / np.sqrt(D)
MAGNITUDES = (-10, -6, 0, 12)      # dO scaled by 2^m


def _inputs(causal, m):
    """float16 q, k, v, dO and the float32 lse and delta the forward gives
    them (the JAX forward in interpret mode)."""
    rng = np.random.RandomState(7 + causal)
    q, k, v, g = (rng.randn(BH, T, D).astype(np.float16) for _ in range(4))
    do = (g.astype(np.float32) * 2.0 ** m).astype(np.float16)
    o, lse = pa._flash_forward_lse(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, SCALE, 64, 64,
                                   True)
    delta = (do.astype(np.float32) * np.asarray(o).astype(np.float32)).sum(
        -1, keepdims=True)
    return q, k, v, do, np.array(lse), delta


def _jax_grads(q, k, v, do, lse, delta, causal):
    return [np.asarray(t) for t in pa._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, do, lse, delta)), causal, SCALE,
        64, 64, True)]


def _port_grads(q, k, v, do, lse, delta, causal, split):
    return [t.numpy() for t in attention.flash_bwd_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v, do, lse, delta)), causal,
        SCALE, split)]


def _readings(got, want):
    g, w = got.astype(np.float64), want.astype(np.float64)
    diff = np.abs(g - w)
    return (diff.max() / np.abs(w).max(),
            np.sqrt(np.square(diff).mean() / np.square(w).mean()))


@pytest.mark.parametrize("m", MAGNITUDES)
@pytest.mark.parametrize("causal", [False, True])
def test_float16_split_matches_jax_backward_at_every_magnitude(causal, m):
    args = _inputs(causal, m)
    want = _jax_grads(*args, causal)
    got = _port_grads(*args, causal, "kernel")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == np.float16
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        assert np.abs(b).max() > 0, name
        max_rel, rms_rel = _readings(a, b)
        assert max_rel <= MAX_REL and rms_rel <= RMS_REL, \
            f"{name} at dO 2^{m}: max_rel {max_rel:.3e} rms_rel {rms_rel:.3e}"


@pytest.mark.parametrize("causal", [False, True])
def test_plain_float16_split_fails_small_gradients(causal):
    """Why the row exponent exists: two plain float16 terms of dS (the
    bfloat16 sweeps' split) put a dS of dO ~ 2^-10 into float16's
    subnormals, and dq and dk read over the rms limit."""
    args = _inputs(causal, -10)
    want = _jax_grads(*args, causal)
    got = _port_grads(*args, causal, "two_term")
    for name, a, b in zip(("dq", "dk"), got, want):
        assert _readings(a, b)[1] > RMS_REL, name


def test_bfloat16_split_is_the_two_term_one():
    """bfloat16's sweeps keep their split: no shift, no exponent."""
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 96, 32).astype(np.float32))
                   .bfloat16() for _ in range(4))
    o, lse = attention.flash_forward_lse_ref(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True) * 1e-3
    kernel = attention.flash_bwd_split_ref(q, k, v, do * 1e-3, lse, delta,
                                           True, None, "kernel")
    plain = attention.flash_bwd_split_ref(q, k, v, do * 1e-3, lse, delta,
                                          True, None, "two_term")
    assert all(torch.equal(a, b) for a, b in zip(kernel, plain))


def test_row_exponent_runs_down_keeps_zero_tiles_and_clamps():
    """Per row and 64-column tile: the largest |x| so far lands in
    [2^14, 2^15); a tile of zeros keeps the exponent; +-56 bound it."""
    x = torch.zeros((1, 3, 192))
    x[0, 0, 5] = 3.0                   # 2^1.58: e = 13
    x[0, 0, 70] = 1.0                  # smaller: e stays 13
    x[0, 0, 130] = 1000.0              # 2^9.97: e = 5
    x[0, 1, 64:128] = 2.0 ** -100      # tiny: the ceiling 56
    x[0, 2, 0] = 2.0 ** 100            # huge: the floor -56
    e = attention._row_exponents(x)
    assert e.dtype == torch.int32 and e.shape == x.shape
    assert e[0, 0, :64].eq(13).all() and e[0, 0, 64:128].eq(13).all()
    assert e[0, 0, 128:].eq(5).all()
    assert e[0, 1].eq(56).all() and e[0, 2].eq(-56).all()
    scaled = (x * attention._pow2(e)).abs().amax(-1)
    assert 2.0 ** 14 <= scaled[0, 0] < 2.0 ** 15


def _round_to_zero32(x):
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    away = f.double().abs() > x.abs()
    return (f.view(torch.int32) - away.int()).view(torch.float32)


@pytest.mark.parametrize("reversed_tiles,within", [(False, False),
                                                  (True, True)])
def test_dkv_query_tile_order_under_truncating_accumulation(reversed_tiles,
                                                            within):
    """Why float16's dk/dv sweep takes its query tiles last to first: the
    tensor cores add each 16-deep product into the f32 accumulator rounding
    toward zero, and under causal a key row's terms fall with the query's
    distance, so summed first to last the small tail is cut at the large
    head's precision. A model of that (dv of the first 256 keys at T 2048,
    d 128: P * 2^15 split in two float16 terms as the kernel splits it,
    eight 16-deep products a 64-query tile) reads rms_rel 8.2e-5 first to
    last and 2.7e-5 last to first, against float16's 6.25e-5."""
    rng = np.random.RandomState(0)
    t, d, keys = 2048, 128, 256
    q, k, do = (torch.from_numpy(rng.randn(t, d)).half().double()
                for _ in range(3))
    s = (q @ k.T / np.sqrt(d)).masked_fill(
        ~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(s, -1)[:, :keys]
    shifted = (p * 2.0 ** 15).float()
    hi = shifted.half().double()
    terms = (hi, (shifted.double() - hi).half().double())
    acc = torch.zeros((keys, d), dtype=torch.float32)
    tiles = range(t // 64 - 1, -1, -1) if reversed_tiles else range(t // 64)
    for qt in tiles:
        for term in terms:
            for kb in range(4):
                rows = slice(64 * qt + 16 * kb, 64 * qt + 16 * kb + 16)
                acc = _round_to_zero32(acc.double()
                                       + term[rows].T @ do[rows])
    got = (acc.double() * 2.0 ** -15).half().double()
    ref = (p.T @ do).half().double()
    rms_rel = ((got - ref).square().mean()
               / ref.square().mean()).sqrt().item()
    assert (rms_rel <= RMS_REL) == within, rms_rel
