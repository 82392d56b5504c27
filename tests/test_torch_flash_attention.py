"""PyTorch port: flash attention (`ops.attention`) against the JAX package's
`ops/pallas_attention.py`.

The same numpy inputs, made from a seed, go through the JAX function with
its Pallas kernels in interpret mode (as tests/test_attention.py runs them)
and through the port on the CPU, where `flash_attention` runs the same
`torch.autograd.Function` over the kernels' plain versions:
  * `flash_attention` values and gradients against the JAX
    `flash_attention(..., interpret=True)` (forward B6, backward B7/B8);
  * `flash_forward_lse_ref` against `_flash_forward_lse` (o and lse);
  * `flash_bwd_dq_ref` / `flash_bwd_dkv_ref` against `_flash_backward`,
    from the same lse and delta;
  * a ragged T = 100 against the JAX `_reference`.

Tolerances: float32 on both sides, sums in other orders (blockwise online
softmax against one softmax): 1e-4 on values, 2e-4 on gradients. The JAX
package's own tests hold its kernels against float64 at 2e-3.

A CUDA tensor never reaches the plain versions: on a machine without
`nvcc` the kernel path raises. The card itself is exercised by
`chip_smoke.py` (phases 6 and 7).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_attention as pa

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.ops import attention, kernels

torch.set_num_threads(1)

VAL_TOL = 1e-4
GRAD_TOL = 2e-4


def _qkv(bh, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(bh, tq, d) * 0.5).astype(np.float32)
    k = (rng.randn(bh, tk, d) * 0.5).astype(np.float32)
    v = (rng.randn(bh, tk, d) * 0.5).astype(np.float32)
    g = rng.randn(bh, tq, d).astype(np.float32)      # the output cotangent
    return q, k, v, g


def _jax_value_and_grads(fn, q, k, v, g):
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port_value_and_grads(q, k, v, g, causal):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = attention.flash_attention(*ts, causal=causal)
    grads = torch.autograd.grad(o, ts, torch.tensor(g))
    return o.detach().numpy(), [t.numpy() for t in grads]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# (tq, tk, d, causal, JAX block size or None for its own choice)
CASES = [(t, t, d, c, None) for t in (128, 256) for d in (32, 64)
         for c in (False, True)] + [
    (128, 256, 32, True, None),      # Tq < Tk, end-aligned causal
    (128, 256, 64, False, None),
    (256, 128, 64, True, 64),        # Tq > Tk: rows 0..127 see no key
]


@pytest.mark.parametrize("tq,tk,d,causal,block", CASES)
def test_flash_attention_matches_jax_kernels(tq, tk, d, causal, block):
    q, k, v, g = _qkv(2, tq, tk, d, seed=tq + tk + d + causal)
    want_o, want_g = _jax_value_and_grads(
        lambda a, b, c: pa.flash_attention(a, b, c, causal=causal,
                                           block_q=block, block_k=block,
                                           interpret=True), q, k, v, g)
    got_o, got_g = _port_value_and_grads(q, k, v, g, causal)
    _close(got_o, want_o, VAL_TOL, "o")
    for a, b, name in zip(got_g, want_g, "qkv"):
        _close(a, b, GRAD_TOL, f"d{name}")


def test_rows_that_see_no_key_give_zero_and_no_gradient():
    """Tq > Tk causal: the first Tq - Tk rows output 0, carry the LSE
    sentinel and get no gradient (the JAX kernel agrees where its block
    skip covers them: blocks of 64 in the parametrized case above)."""
    q, k, v, g = _qkv(2, 96, 40, 32, seed=3)
    got_o, (dq, dk, dv) = _port_value_and_grads(q, k, v, g, True)
    assert not got_o[:, :56].any() and not dq[:, :56].any()
    assert got_o[:, 56:].any() and dq[:, 56:].any()
    _, lse = attention.flash_forward_lse_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), True)
    assert (lse[:, :56] == -1e30).all() and (lse[:, 56:] > -1e29).all()


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_reference(causal):
    """T = 100 is no multiple of any tile: the JAX package takes its einsum
    `_reference` there; the port's kernels mask the tail tile."""
    q, k, v, g = _qkv(2, 100, 100, 32, seed=11 + causal)
    want_o, want_g = _jax_value_and_grads(
        lambda a, b, c: pa._reference(a, b, c, 1.0 / np.sqrt(32), causal),
        q, k, v, g)
    got_o, got_g = _port_value_and_grads(q, k, v, g, causal)
    _close(got_o, want_o, VAL_TOL, "o")
    for a, b, name in zip(got_g, want_g, "qkv"):
        _close(a, b, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("tq,tk,causal", [(128, 128, False),
                                          (128, 128, True),
                                          (128, 256, True)])
def test_plain_versions_match_each_jax_kernel(tq, tk, causal):
    """Each kernel's plain version against its own TPU kernel (interpret
    mode), the backward ones from the same lse and delta."""
    d, scale = 64, 0.125
    q, k, v, g = _qkv(2, tq, tk, d, seed=21 + causal)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o_j, lse_j = pa._flash_forward_lse(jq, jk, jv, causal, scale, 64, 64,
                                       True)
    o_5 = pa._flash_forward_kernel(jq, jk, jv, causal, scale, 64, 64, True)
    tq_, tk_, tv_, tg_ = (torch.tensor(a) for a in (q, k, v, g))
    o_p, lse_p = attention.flash_forward_lse_ref(tq_, tk_, tv_, causal,
                                                 scale)
    _close(o_p.numpy(), np.asarray(o_j), VAL_TOL, "B6 o")
    _close(lse_p.numpy(), np.asarray(lse_j), VAL_TOL, "B6 lse")
    _close(attention.flash_attention_ref(tq_, tk_, tv_, causal,
                                         scale).numpy(),
           np.asarray(o_5), VAL_TOL, "B5 o")
    lse = np.asarray(lse_j)
    delta = (g * np.asarray(o_j)).sum(-1, keepdims=True).astype(np.float32)
    dq_j, dk_j, dv_j = pa._flash_backward(jq, jk, jv, jg, jnp.asarray(lse),
                                          jnp.asarray(delta), causal, scale,
                                          64, 64, True)
    args = (tq_, tk_, tv_, tg_, torch.tensor(lse), torch.tensor(delta),
            causal, scale)
    dq_p = attention.flash_bwd_dq_ref(*args)
    dk_p, dv_p = attention.flash_bwd_dkv_ref(*args)
    _close(dq_p.numpy(), np.asarray(dq_j), GRAD_TOL, "B7 dq")
    _close(dk_p.numpy(), np.asarray(dk_j), GRAD_TOL, "B8 dk")
    _close(dv_p.numpy(), np.asarray(dv_j), GRAD_TOL, "B8 dv")


def test_bf16_keeps_dtype_and_computes_in_f32():
    q, k, v, _ = _qkv(2, 64, 64, 32, seed=31)
    qb, kb, vb = (torch.tensor(a).bfloat16() for a in (q, k, v))
    out = attention.flash_attention(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16
    f32 = attention.flash_attention_ref(qb.float(), kb.float(), vb.float(),
                                        True)
    torch.testing.assert_close(out, f32.bfloat16(), rtol=0, atol=0)
    mixed = attention.flash_attention(qb, torch.tensor(k), vb)
    assert mixed.dtype == torch.float32          # the widest input's dtype


# ---------------------------------------------------------------------------
# the card's path: CUDA tensors launch the kernels or raise
# ---------------------------------------------------------------------------
class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the dispatch and
    the wrappers' checks can be driven without one."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(*arrays):
    return [torch.tensor(a).as_subclass(_CudaLooking) for a in arrays]


def _plain(t):
    return t.as_subclass(torch.Tensor)


@pytest.fixture
def no_plain_versions(monkeypatch):
    """The plain versions raise if anything calls them."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("flash_attention_ref", "flash_forward_lse_ref",
                 "flash_bwd_dq_ref", "flash_bwd_dkv_ref"):
        monkeypatch.setattr(attention, name, refuse)


def test_cuda_tensor_without_nvcc_raises(monkeypatch, tmp_path,
                                         no_plain_versions):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD", str(tmp_path / "build"))
    isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: isfile(p) and not str(p).endswith("nvcc"))
    q, k, v, _ = _qkv(2, 64, 64, 32, seed=41)
    kernels.reset_launch_counts()
    with pytest.raises(MXNetError, match="nvcc not found"):
        attention.flash_attention(*_cuda_looking(q, k, v))
    qg, kg, vg = _cuda_looking(q, k, v)
    qg.requires_grad_(True)
    with pytest.raises(MXNetError, match="nvcc not found"):
        attention.flash_attention(qg, kg, vg)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(),
                                                    0)


def test_cuda_wrappers_check_their_inputs():
    q, k, v, _ = _qkv(2, 64, 64, 32, seed=42)
    lse = np.zeros((2, 64, 1), np.float32)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.flash_fwd_cuda(*(torch.tensor(a) for a in (q, k, v)),
                               False, 0.1, True)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.flash_bwd_dq_cuda(*(torch.tensor(a) for a in (q, k, v, q,
                                                               lse, lse)),
                                  False, 0.1)
    qc, kc, vc = _cuda_looking(q, k, v)
    with pytest.raises(MXNetError, match="contiguous"):
        kernels.flash_fwd_cuda(qc.transpose(1, 2).contiguous().transpose(1, 2),
                               kc, vc, False, 0.1, True)
    # every head dim is taken (d > 256 in 128-column slices); k and v of
    # another head dim than q are not
    _, kw, vw = _cuda_looking(*_qkv(2, 64, 64, 264, seed=44)[:3])
    with pytest.raises(MXNetError, match="do not serve q"):
        kernels.flash_fwd_cuda(qc, kw, vw, False, 0.1, True)
    with pytest.raises(MXNetError, match="one dtype"):
        kernels.flash_fwd_cuda(qc, kc.bfloat16(), vc, False, 0.1, True)
    lc, dc = _cuda_looking(lse, lse[:, :32])
    with pytest.raises(MXNetError, match="delta"):
        kernels.flash_bwd_dkv_cuda(qc, kc, vc, qc, lc, dc, False, 0.1)


def _counting_fakes(monkeypatch, calls):
    """Replace the CUDA wrappers with fakes that record the call and
    return the plain version's result, as CUDA-looking tensors."""
    def fwd(q, k, v, causal, scale, with_lse):
        calls.append(("fwd_lse" if with_lse else "fwd"))
        o, lse = attention.flash_forward_lse_ref(
            _plain(q), _plain(k), _plain(v), causal, scale)
        o, lse = (t.as_subclass(_CudaLooking) for t in (o, lse))
        return (o, lse) if with_lse else o

    def dq(q, k, v, do, lse, delta, causal, scale):
        calls.append("dq")
        return attention.flash_bwd_dq_ref(
            *(_plain(t) for t in (q, k, v, do, lse, delta)), causal,
            scale).as_subclass(_CudaLooking)

    def dkv(q, k, v, do, lse, delta, causal, scale):
        calls.append("dkv")
        return tuple(t.as_subclass(_CudaLooking)
                     for t in attention.flash_bwd_dkv_ref(
                         *(_plain(t) for t in (q, k, v, do, lse, delta)),
                         causal, scale))
    monkeypatch.setattr(kernels, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(kernels, "flash_bwd_dq_cuda", dq)
    monkeypatch.setattr(kernels, "flash_bwd_dkv_cuda", dkv)


def test_dispatch_runs_b5_alone_without_grad_and_b6_b7_b8_with(monkeypatch):
    """The custom_vjp's split: the primal kernel when nothing is recorded,
    the LSE forward and both backward sweeps when a gradient is."""
    calls = []
    _counting_fakes(monkeypatch, calls)
    q, k, v, g = _qkv(2, 64, 64, 32, seed=43)
    qc, kc, vc = _cuda_looking(q, k, v)
    attention.flash_attention(qc, kc, vc, causal=True)
    with torch.no_grad():
        qc.requires_grad_(True)
        attention.flash_attention(qc, kc, vc)
    assert calls == ["fwd", "fwd"]
    calls.clear()
    o = attention.flash_attention(qc, kc, vc, causal=True)
    grads = torch.autograd.grad(o, (qc,), torch.tensor(g))
    assert calls == ["fwd_lse", "dq", "dkv"]
    _, want = _port_value_and_grads(q, k, v, g, True)
    np.testing.assert_allclose(_plain(grads[0]).numpy(), want[0], rtol=0,
                               atol=0)
