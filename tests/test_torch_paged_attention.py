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


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated in PyTorch (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------
# Sizes for the emulation: the kernel's pieces (256 positions) and tiles (64)
# are scaled down with T so a lane's prefix crosses several of each.
EMU_S, EMU_H, EMU_D, EMU_T = 4, 2, 16, 96
EMU_PIECE, EMU_TILE = 32, 32
# bf16 outputs held to chip_smoke.py's limits relative to their size (phase
# 6): max |err| / max |ref| and rms(err) / rms(ref)
BF16_MAX_REL, BF16_RMS_REL = 1e-2, 5e-4
# float16's: bfloat16's scaled by its step, 2^-11 against 2^-8
# (chip_smoke.py :: limits16)
F16_MAX_REL, F16_RMS_REL = BF16_MAX_REL / 8, BF16_RMS_REL / 8
# the bounds of a row's power-of-two exponent on the float16-over-int8
# route (csrc/paged_attention.cu: kShiftMin, kShiftMax)
SHIFT_MIN, SHIFT_MAX = -60, 60


def _combine(m, l, acc):
    """The split route's second kernel: pieces' (max, normaliser,
    accumulator) along the last axis of m and l (and the second last of
    acc), weighted by exp(m_p - M) in piece order (0 for a piece with no
    live position, m = -inf)."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    return (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]


def _emulate(q, k, v, lens, layer, k_scale=None, v_scale=None, terms=2,
             t16=torch.bfloat16, shift=None):
    """The kernel's arithmetic on (S, C, H, D) q, in f32: S scaled by
    k_scale per position (column) after q . code on int8 slabs; C <= 16
    (the split route): fixed pieces of EMU_PIECE positions from 0, each a
    softmax of its own (max m, normaliser l, accumulator), combined in
    piece order with weights exp(m_p - M); C > 16 (the tensor-core route):
    an online softmax over EMU_TILE-position tiles, P' = P v_scale folded
    per position after l sums P, and P' entering P'.V as `terms` terms of
    q's 16-bit type `t16` (hi + lo, or hi alone). `shift` (by default what
    the kernel does: float16 over int8): P' enters as P' 2^e, e = the least
    so far of the exponent that puts the tile's largest v_scale in
    [2^14, 2^15), within [SHIFT_MIN, SHIFT_MAX] (one e a lane: it depends
    on the lane's scales alone); a fall of e rescales the accumulator by
    2^(e_new - e_old), and the division by l 2^e undoes it."""
    S, C, H, D = q.shape
    T = k.shape[2]
    quant = k_scale is not None
    if shift is None:
        shift = quant and t16 == torch.float16
    kk, vv = k[:S, layer].float(), v[:S, layer].float()   # codes on int8
    ones = torch.ones(S, T)
    ks = k_scale[:S, layer] if quant else ones
    vs = v_scale[:S, layer] if quant else ones
    s = torch.einsum("schd,sthd->shct", q.float(), kk) \
        * ks[:, None, None, :] * (1.0 / D ** 0.5)
    pos = torch.arange(T)
    lim = torch.as_tensor(lens).long()[:, None] + torch.arange(C)[None]
    live = (pos[None, None] <= lim[:, :, None])[:, None]     # (S, 1, C, T)
    s = s.masked_fill(~live, float("-inf"))
    if C <= 16:
        n = -(-T // EMU_PIECE)
        pad = n * EMU_PIECE - T
        sp = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        sp = sp.reshape(S, H, C, n, EMU_PIECE)
        m = sp.amax(-1)                                       # (S, H, C, n)
        p = torch.exp(sp - m[..., None]).nan_to_num(0.0)      # empty: 0
        l = p.sum(-1)
        vsp = torch.nn.functional.pad(vs, (0, pad)).reshape(S, 1, 1, n,
                                                            EMU_PIECE)
        vvp = torch.nn.functional.pad(vv, (0, 0, 0, 0, 0, pad)).reshape(
            S, n, EMU_PIECE, H, D)
        acc = torch.einsum("shcnt,snthd->shcnd", p * vsp, vvp)
        return _combine(m, l, acc).permute(0, 2, 1, 3)
    m = torch.full((S, H, C), float("-inf"))
    l = torch.zeros(S, H, C)
    acc = torch.zeros(S, H, C, D)
    e = torch.full((S, 1, 1), float(SHIFT_MAX))
    for t0 in range(0, T, EMU_TILE):
        st = s[..., t0:t0 + EMU_TILE]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        vt = vs[:, None, None, t0:t0 + EMU_TILE]
        pp = p * vt
        if shift:
            mv = vt.amax(-1)                                  # (S, 1, 1)
            want = (15 - torch.frexp(mv).exponent).clamp(SHIFT_MIN,
                                                         SHIFT_MAX)
            e_new = torch.where(mv > 0, torch.minimum(e, want.float()), e)
            alpha = alpha * torch.exp2(e_new - e)
            e = e_new
            pp = pp * torch.exp2(e)[..., None]
        hi = pp.to(t16).float()
        pq = hi + (pp - hi).to(t16).float() if terms == 2 else hi
        acc = acc * alpha[..., None] + torch.einsum(
            "shct,sthd->shcd", pq, vv[:, t0:t0 + EMU_TILE])
        m = m_new
    if shift:
        l = l * torch.exp2(e)
    return (acc / l[..., None]).permute(0, 2, 1, 3)


def _emu_inputs(C, kv, seed, t16=torch.bfloat16, q_mul=1.0,
                v_scale=(0.002, 0.022)):
    """16-bit q of type `t16` (the tensor-core route's operand; `q_mul`
    spreads the scores: 8 gives a peaked softmax, scores spread ~8 sigma),
    a slab of that type or int8 codes with per-position scales (k_scale in
    [0.002, 0.022], v_scale log-uniform over the `v_scale` range), ragged
    lengths with 0, T - C and prefixes across several pieces; T is EMU_T,
    or C + 128 for a longer chunk."""
    rng = np.random.RandomState(seed)
    T = max(EMU_T, C + 128)
    shape = (EMU_S + 1, L, T, EMU_H, EMU_D)
    q = torch.from_numpy((rng.randn(EMU_S, C, EMU_H, EMU_D) * q_mul).astype(
        np.float32)).to(t16).float()
    lens = np.array([0, 37, T - C, 70 - min(C, 40)], dtype=np.int32)
    if kv == "int8":
        k = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy((rng.rand(*shape[:3]) * 0.02 + 0.002)
                              .astype(np.float32))
        lo, hi = np.log(v_scale[0]), np.log(v_scale[1])
        vs = torch.from_numpy(np.exp(rng.uniform(lo, hi, shape[:3]))
                              .astype(np.float32))
        return q, k, v, lens, dict(k_scale=ks, v_scale=vs)
    k = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(t16)
    v = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(t16)
    return q, k, v, lens, {}


def _jax_ref(q, k, v, lens, layer, sc):
    """The JAX package's paged_attention_ref on the same values (bf16 slabs
    handed over as the f32 values they hold)."""
    jk, jv = ((jnp.asarray(x.numpy()) if x.dtype == torch.int8
               else jnp.asarray(x.float().numpy())) for x in (k, v))
    want = jfused.paged_attention_ref(
        jnp.asarray(q.numpy()), jk, jv, jnp.asarray(lens), layer,
        **{n: jnp.asarray(t.numpy()) for n, t in sc.items()})
    return torch.from_numpy(np.array(want))


def _rel(got, want):
    d = got - want
    return ((d.abs().max() / want.abs().max()).item(),
            (d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item())


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("C", [1, 4, 40])
def test_kernel_arithmetic_emulated_matches_jax_reference(C, kv):
    """C 1 and 4 (split: fixed pieces and their combine, f32 throughout)
    agree with the JAX reference to f32 summation order (1e-5 absolute,
    2e-5 relative and absolute on int8 slabs, whose values reach 2.5); C 40
    (the tensor-core route: S scaled by k_scale per position, v_scale
    folded into P after the normaliser, P' in two bf16 terms) to the bf16
    limits chip_smoke.py holds the kernel's bf16 outputs to."""
    q, k, v, lens, sc = _emu_inputs(C, kv, seed=100 + C)
    assert kernels.paged_route(torch.bfloat16, k.dtype, EMU_D, C) == (
        "split" if C <= 16 else "wgmma")
    got = _emulate(q, k, v, lens, 1, **sc)
    want = _jax_ref(q, k, v, lens, 1, sc)
    if C <= 16:
        tol = INT8_TOL if kv == "int8" else dict(rtol=0, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    else:
        max_rel, rms_rel = _rel(got, want)
        assert max_rel <= BF16_MAX_REL and rms_rel <= BF16_RMS_REL / 10, \
            (max_rel, rms_rel)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_one_bf16_term_of_p_misses_the_rms_limit(kv):
    """P' in one bf16 term parts from the f32 P by up to 2^-9 relative a
    position, and the output then misses the 5e-4 rms limit: the reason the
    tensor-core route keeps two terms (hi + lo)."""
    q, k, v, lens, sc = _emu_inputs(40, kv, seed=140)
    want = _jax_ref(q, k, v, lens, 1, sc)
    one = _rel(_emulate(q, k, v, lens, 1, terms=1, **sc), want)[1]
    two = _rel(_emulate(q, k, v, lens, 1, terms=2, **sc), want)[1]
    assert one > BF16_RMS_REL > 10 * two, (one, two)


# float16 q over a float16 or an int8 slab on the tensor cores: (kv, C,
# q_mul, v_scale range); q_mul 8 is a peaked softmax, and the v_scale
# ranges reach 1e-4 (under float16's normal range once P < 0.6) and 10
F16_CASES = [(kv, C, q_mul, vsr)
             for kv in ("float16", "int8") for C in (17, 40, 256)
             for q_mul in (1.0, 8.0)
             for vsr in (((0.002, 0.022), (1e-4, 1e-4), (1e-4, 10.0))
                         if kv == "int8" else ((0.002, 0.022),))]


@pytest.mark.parametrize("kv,C,q_mul,vsr", F16_CASES,
                         ids=[f"{kv}-C{C}-q{q:g}-vs{a:g}-{b:g}"
                              for kv, C, q, (a, b) in F16_CASES])
def test_float16_route_emulated_matches_jax_reference(kv, C, q_mul, vsr):
    """The tensor-core route's float16 arithmetic (P' in two float16 terms;
    over int8, P' shifted by the row's power of two) against the JAX
    reference within float16's limits (chip_smoke.py :: limits16), at flat
    and peaked softmaxes and v_scale from 1e-4 to 10."""
    q, k, v, lens, sc = _emu_inputs(C, kv, seed=170 + C,
                                    t16=torch.float16, q_mul=q_mul,
                                    v_scale=vsr)
    assert kernels.paged_route(torch.float16, k.dtype, EMU_D, C) == "wgmma"
    got = _emulate(q, k, v, lens, 1, t16=torch.float16, **sc)
    max_rel, rms_rel = _rel(got, _jax_ref(q, k, v, lens, 1, sc))
    assert max_rel <= F16_MAX_REL and rms_rel <= F16_RMS_REL, \
        (max_rel, rms_rel)


@pytest.mark.parametrize("kv", ["float16", "int8"])
def test_one_float16_term_of_p_misses_the_rms_limit(kv):
    """P' in one float16 term parts from the f32 P by up to 2^-12 relative a
    position, and at a flat softmax the output then misses float16's
    6.25e-5 rms limit: the reason the float16 route keeps two terms."""
    q, k, v, lens, sc = _emu_inputs(40, kv, seed=141, t16=torch.float16)
    want = _jax_ref(q, k, v, lens, 1, sc)
    one = _rel(_emulate(q, k, v, lens, 1, terms=1, t16=torch.float16,
                        **sc), want)[1]
    two = _rel(_emulate(q, k, v, lens, 1, terms=2, t16=torch.float16,
                        **sc), want)[1]
    assert one > F16_RMS_REL > 10 * two, (one, two)


@pytest.mark.parametrize("q_mul", [1.0, 8.0])
def test_unshifted_float16_p_misses_the_limits_at_small_v_scale(q_mul):
    """Over int8 at v_scale 1e-4, P' = P v_scale lies under float16's
    normal range (6.1e-5) everywhere: unshifted, its lo term underflows
    and the output misses the rms limit; shifted by the row's power of two
    (what the kernel does) it meets both limits."""
    q, k, v, lens, sc = _emu_inputs(40, "int8", seed=142,
                                    t16=torch.float16, q_mul=q_mul,
                                    v_scale=(1e-4, 1e-4))
    want = _jax_ref(q, k, v, lens, 1, sc)
    plain = _rel(_emulate(q, k, v, lens, 1, t16=torch.float16, shift=False,
                          **sc), want)
    shifted = _rel(_emulate(q, k, v, lens, 1, t16=torch.float16, **sc),
                   want)
    assert plain[1] > F16_RMS_REL, plain
    assert shifted[0] <= F16_MAX_REL and shifted[1] <= F16_RMS_REL / 10, \
        shifted


def test_bfloat16_route_takes_no_shift():
    """bfloat16 has f32's exponent range: its route's P' is not shifted,
    and the emulation with the shift forced on gives the same output to
    rounding (the two differ only where bf16 would round a shifted value
    differently, which powers of two never make it do)."""
    q, k, v, lens, sc = _emu_inputs(40, "int8", seed=143,
                                    v_scale=(1e-4, 10.0))
    plain = _emulate(q, k, v, lens, 1, **sc)
    assert torch.equal(plain, _emulate(q, k, v, lens, 1, shift=False, **sc))
    forced = _emulate(q, k, v, lens, 1, shift=True, **sc)
    assert torch.allclose(forced, plain, rtol=1e-6, atol=0)


def test_split_combine_of_one_piece_is_the_plain_quotient():
    """A lane whose live prefix fits one piece: the later pieces ran with no
    live position (m = -inf, l = 0, acc = 0), the combine's weights are
    exp(0) = 1 and exp(-inf) = 0, and the output is that piece's acc / l
    bit for bit."""
    rng = np.random.RandomState(160)
    m = torch.tensor([[1.25, float("-inf"), float("-inf")]])
    l = torch.tensor([[float(rng.rand() * 30 + 1), 0.0, 0.0]])
    acc = torch.zeros(1, 3, EMU_D)
    acc[0, 0] = torch.from_numpy(rng.randn(EMU_D).astype(np.float32))
    assert torch.equal(_combine(m, l, acc)[0], acc[0, 0] / l[0, 0])
