"""PyTorch port: the NHWC average pool (B2 forward, B3 backward) around its
CUDA kernels, on the CPU.

  * `kernels.pool_route`, the one rule that picks both passes' kernel and
    vector width, at the flagship and off-flagship shapes, and the route
    and vector a wrapper launches (a stand-in for the built library
    records the launch arguments: no card or `nvcc` here);
  * float16 through `fused.avg_pool2d`, forward and gradient, against the
    JAX package's op with its Pallas kernels in interpret mode;
  * the wrappers take float16, the pool's and the others' (ROADMAP C3);
  * `chip_smoke.py`'s phase-4 rule for the pool forward: it must refuse
    three planted bfloat16 faults and pass a sum taken in another order.

Tolerances: float16 forwards on both sides sum in f32 and round once, so
they may part by one float16 step (2^-10 relative) where the two sums'
orders straddle a rounding point; the gradient is one f32 multiply and one
rounding on both sides, so it is compared bit for bit.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.ops import fused, kernels

from test_torch_coverage import _cuda
from test_torch_fused_ops import POOLS

torch.set_num_threads(1)

F16_TOL = dict(rtol=2 ** -10, atol=2 ** -24)


@pytest.mark.parametrize("ph,pw,c,dtype,aligned,want", [
    (7, 7, 2048, torch.bfloat16, True, ("window", 8)),     # ResNet-50
    (7, 7, 2048, torch.float32, True, ("window", 4)),
    (7, 7, 2048, torch.float16, True, ("window", 8)),
    (2, 2, 256, torch.bfloat16, True, ("per_output", 8)),
    (2, 2, 256, torch.float32, True, ("per_output", 4)),
    (2, 2, 12, torch.bfloat16, True, ("per_output", 1)),
    (7, 7, 12, torch.float16, True, ("window", 1)),
    (2, 2, 12, torch.float32, True, ("per_output", 4)),
    (2, 2, 10, torch.float32, True, ("per_output", 1)),
    (2, 2, 256, torch.bfloat16, False, ("per_output", 1)),
    (4, 4, 8, torch.bfloat16, True, ("per_output", 8)),    # 16 positions
    (1, 17, 8, torch.bfloat16, True, ("window", 8)),       # 17 positions
    (14, 14, 16, torch.float32, True, ("window", 4)),
])
def test_pool_route(ph, pw, c, dtype, aligned, want):
    assert kernels.pool_route(ph, pw, c, dtype, aligned) == want


class _FakeLib:
    """Records each pooling launch's (dtype code, route code, vector) in
    place of the built library."""

    def __init__(self):
        self.calls = []

    def mx_avg_pool2d_fwd(self, dtype, route, vec, *rest):
        self.calls.append(("fwd", dtype, route, vec))
        return 0

    def mx_avg_pool2d_bwd(self, dtype, route, vec, *rest):
        self.calls.append(("bwd", dtype, route, vec))
        return 0

    def mx_scale_shift_act(self, dtype, act, *rest):
        self.calls.append(("apply", dtype, act))
        return 0

    def mx_flash_fwd(self, dtype, device, d, with_lse, *rest):
        self.calls.append(("flash_fwd", dtype, d, with_lse))
        return 0

    def mx_flash_fwd_wgmma(self, dtype, device, d, with_lse, *rest):
        self.calls.append(("flash_fwd_wgmma", dtype, d, with_lse))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "_load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kernels.reset_launch_counts()
    yield lib
    kernels.reset_launch_counts()


@pytest.mark.parametrize("shape,pool,dtype,offset,want", [
    ((2, 7, 7, 64), (7, 7), torch.bfloat16, 0, (1, 0, 8)),
    ((2, 7, 7, 64), (7, 7), torch.float16, 0, (2, 0, 8)),
    ((2, 8, 8, 12), (2, 2), torch.float32, 0, (0, 1, 4)),
    ((2, 8, 8, 12), (2, 2), torch.bfloat16, 0, (1, 1, 1)),
    ((2, 8, 8, 64), (2, 2), torch.bfloat16, 1, (1, 1, 1)),   # unaligned
])
def test_wrappers_launch_the_route_pool_route_names(shape, pool, dtype,
                                                    offset, want, fake_lib):
    n, h, w, c = shape
    ph, pw = pool
    flat = torch.zeros(n * h * w * c + offset, dtype=dtype)
    x = _cuda(flat[offset:].view(shape))
    kernels.avg_pool2d_fwd_cuda(x, ph, pw)
    kernels.avg_pool2d_bwd_cuda(_cuda(torch.zeros(
        (n, h // ph, w // pw, c), dtype=dtype)), h, w, ph, pw)
    assert fake_lib.calls[0] == ("fwd",) + want
    # the backward's buffers are fresh, so aligned
    bwd_vec = want[2] if offset == 0 else 8
    assert fake_lib.calls[1] == ("bwd",) + want[:2] + (bwd_vec,)
    counts = kernels.launch_counts()
    assert counts["avg_pool2d_fwd"] == counts["avg_pool2d_bwd"] == 1


@pytest.mark.parametrize("shape,pool", POOLS,
                         ids=["global7x7", "2x3", "1x1"])
def test_float16_pool_and_gradient_match_jax(shape, pool):
    """fused.avg_pool2d in float16 on the CPU (the plain versions a CUDA
    float16 tensor's kernels are held against) against the JAX op through
    its Pallas kernels in float16."""
    rng = np.random.RandomState(15)
    x = rng.randn(*shape).astype(np.float32)
    xj = jnp.asarray(x, jnp.float16)
    want, vjp = jax.vjp(
        lambda a: jfused.avg_pool2d(a, pool, interpret=True), xj)
    dy = rng.randn(*want.shape).astype(np.float32)
    (wgrad,) = vjp(jnp.asarray(dy, jnp.float16))
    xt = torch.tensor(x).half().requires_grad_(True)
    got = fused.avg_pool2d(xt, pool)
    got.backward(torch.tensor(dy).half())
    assert got.dtype == torch.float16 and xt.grad.dtype == torch.float16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **F16_TOL)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(wgrad))


def test_pool_wrappers_take_float16_and_refuse_other_types(fake_lib):
    x16 = _cuda(torch.zeros((2, 4, 4, 8), dtype=torch.float16))
    assert kernels.avg_pool2d_fwd_cuda(x16, 2, 2).dtype == torch.float16
    assert kernels.avg_pool2d_bwd_cuda(
        _cuda(torch.zeros((2, 2, 2, 8), dtype=torch.float16)), 4, 4, 2,
        2).dtype == torch.float16
    assert [c[1] for c in fake_lib.calls] == [2, 2]
    for dtype in (torch.float64, torch.int32, torch.int8):
        bad = _cuda(torch.zeros((2, 4, 4, 8), dtype=dtype))
        with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
            kernels.avg_pool2d_fwd_cuda(bad, 2, 2)
        with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
            kernels.avg_pool2d_bwd_cuda(bad, 8, 8, 2, 2)


def test_other_kernels_keep_refusing_float16(fake_lib):
    """float16 is no longer the pool's alone (ROADMAP C3, closed): the apply
    and flash wrappers launch it with the one dtype table's code (2; the
    flash forward at d = 64 on its tensor-core entry), and keep refusing
    float64 before any launch."""
    x = _cuda(torch.zeros((4, 8), dtype=torch.float16))
    assert kernels.scale_shift_act_cuda(
        x, None, _cuda(torch.zeros(8)), None, "relu").dtype == torch.float16
    q = _cuda(torch.zeros((2, 4, 64), dtype=torch.float16))
    assert kernels.flash_fwd_cuda(q, q, q, False, 0.125,
                                  False).dtype == torch.float16
    assert fake_lib.calls == [("apply", 2, kernels.ACT_CODES["relu"]),
                              ("flash_fwd_wgmma", 2, 64, 0)]
    x64 = _cuda(torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        kernels.scale_shift_act_cuda(x64, None, _cuda(torch.zeros(8)), None,
                                     "relu")
    q64 = _cuda(torch.zeros((2, 4, 64), dtype=torch.float64))
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        kernels.flash_fwd_cuda(q64, q64, q64, False, 0.125, False)
    assert len(fake_lib.calls) == 2


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RULE_SHAPES = [((4, 7, 7, 64), (7, 7)), ((2, 8, 12, 16), (2, 2))]


def _pool_input(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.tensor(x).to(dtype)


def _reordered(x, ph, pw):
    """The mean with the window summed last position first, in f32."""
    n, h, w, c = x.shape
    win = x.float().reshape(n, h // ph, ph, w // pw, pw, c).flip(2, 4)
    total = torch.zeros((n, h // ph, w // pw, c))
    for i in range(ph):
        for j in range(pw):
            total = total + win[:, :, i, :, j]
    return (total / (ph * pw)).to(x.dtype)


@pytest.mark.parametrize("shape,pool", RULE_SHAPES, ids=["global", "2x2"])
@pytest.mark.parametrize("fault", ["truncating store", "divisor ph*pw - 1",
                                   "dropped window position"])
def test_phase4_pool_rule_refuses_planted_faults(shape, pool, fault):
    cs = _load_chip_smoke()
    x = _pool_input(shape, torch.bfloat16, seed=21)
    ref = fused.avg_pool2d_ref(x, pool)
    bad = cs.pool_planted_faults(x, *pool)[fault]
    assert bad.shape == ref.shape and bad.dtype == torch.bfloat16
    assert not cs.pool_fwd_err(bad, ref, torch.bfloat16)[1]


@pytest.mark.parametrize("shape,pool", RULE_SHAPES, ids=["global", "2x2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_phase4_pool_rule_passes_a_reordered_sum(shape, pool, dtype):
    cs = _load_chip_smoke()
    x = _pool_input(shape, dtype, seed=22)
    ref = fused.avg_pool2d_ref(x, pool)
    err, ok, read = cs.pool_fwd_err(_reordered(x, *pool), ref, dtype)
    assert ok, (err, read)
    nan = ref.clone()
    nan.view(-1)[0] = float("nan")
    assert not cs.pool_fwd_err(nan, ref, dtype)[1]
