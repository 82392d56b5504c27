"""PyTorch port: the fused ops' plain versions and autograd Functions
against the JAX package's fused ops, which run their Pallas kernels in
interpret mode here (`interpret=True`, as tests/test_fused_ops.py does).

The same numpy inputs go to both; values and gradients (through
`jax.value_and_grad` on the JAX side, through the port's
`torch.autograd.Function`s on the other) are compared. On the CPU every
port op takes its plain version, and no kernel is launched; the CUDA
wrappers refuse CPU tensors. The kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions there).

Tolerances: float32 on both sides with only the order of sums (the batch
moments, the column sums of the backward) differing: 1e-5 relative and
absolute. bfloat16 outputs: both sides compute in f32 and round once, so
they agree to one bf16 rounding step (2^-7 relative).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu.ops import pallas_kernels as PK
from incubator_mxnet_tpu.ops import registry as jregistry
from incubator_mxnet_tpu import amp as jamp
import incubator_mxnet_tpu.numpy_extension  # noqa: F401  (registers npx ops)

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch.ops import fused, kernels

from torch_port_utils import jax_amp_restored

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
ACTS = list(fused.FUSABLE_ACTS)
SHAPE = (2, 4, 4, 16)               # NHWC; the kernel's (M, C) = (32, 16)


def _rand(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a, grad=True):
    return torch.tensor(a, requires_grad=grad)


def _apply_inputs(seed):
    rng = np.random.RandomState(seed)
    c = SHAPE[-1]
    return dict(x=_rand(rng, SHAPE), scale=1.0 + _rand(rng, (c,), 0.3),
                shift=_rand(rng, (c,), 0.5), res=_rand(rng, SHAPE),
                ct=_rand(rng, SHAPE))


def _jax_apply(arity, act, x, scale, shift, res):
    if arity == "bias":
        return jfused.bias_act(x, shift, act_type=act, axis=-1,
                               interpret=True)
    return jfused.norm_act_residual(
        x, scale, shift, res if arity == "residual" else None,
        act_type=act, axis=-1, interpret=True)


def _port_apply(arity, act, x, scale, shift, res):
    if arity == "bias":
        return fused.bias_act(x, shift, act_type=act, axis=-1)
    return fused.norm_act_residual(
        x, scale, shift, res if arity == "residual" else None,
        act_type=act, axis=-1)


@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("arity", ["bias", "scale", "residual"])
def test_apply_and_its_gradient_match_jax(arity, act):
    """B1 with each arity and activation: output and the gradients of
    sum(out * ct) for x, scale, shift and the residual."""
    d = _apply_inputs(seed=ACTS.index(act) + 10 * len(arity))
    ct = d.pop("ct")
    names = ["x", "scale", "shift", "res"]

    def f(x, scale, shift, res):
        out = _jax_apply(arity, act, x, scale, shift, res)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True)(
        *[jnp.asarray(d[n]) for n in names])
    ts = {n: _t(d[n]) for n in names}
    kernels.reset_launch_counts()
    got = _port_apply(arity, act, *[ts[n] for n in names])
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    used = {"bias": ["x", "shift"], "scale": ["x", "scale", "shift"],
            "residual": names}[arity]
    for n, g in zip(names, grads):
        if n in used:
            np.testing.assert_allclose(ts[n].grad.numpy(), np.asarray(g),
                                       err_msg=n, **TOL)
        else:
            assert ts[n].grad is None, n
    assert kernels.scale_shift_act_launches == 0


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_apply_bf16_matches_pallas_kernel(act):
    """bf16 in and out: the plain version against the Pallas kernel
    itself, from the same bf16 inputs."""
    d = _apply_inputs(seed=90)
    x = d["x"].reshape(-1, SHAPE[-1])
    r = d["res"].reshape(-1, SHAPE[-1])
    want = PK.apply_scale_shift_act(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(d["scale"]),
        jnp.asarray(d["shift"]), jnp.asarray(r, jnp.bfloat16), act,
        interpret=True)
    got = fused.apply_ref(torch.tensor(x).bfloat16(),
                          torch.tensor(d["scale"]), torch.tensor(d["shift"]),
                          torch.tensor(r).bfloat16(), act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_bn_inference_and_gradient_match_jax():
    rng = np.random.RandomState(3)
    c = SHAPE[-1]
    vals = [_rand(rng, SHAPE), 1 + _rand(rng, (c,), 0.2),
            _rand(rng, (c,), 0.2), _rand(rng, (c,), 0.2),
            1 + np.abs(_rand(rng, (c,), 0.2))]
    ct = _rand(rng, SHAPE)

    def f(x, g, b):
        out = jfused.bn_inference(x, g, b, jnp.asarray(vals[3]),
                                  jnp.asarray(vals[4]), act_type="relu",
                                  interpret=True)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        *[jnp.asarray(v) for v in vals[:3]])
    ts = [_t(v) for v in vals[:3]]
    got = fused.bn_inference(*ts, torch.tensor(vals[3]),
                             torch.tensor(vals[4]), act_type="relu")
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("act,residual", [(None, False), ("relu", True)],
                         ids=["plain", "relu_res"])
def test_batch_norm_stats_and_gradients_match_jax(act, residual, training):
    """The fused batch_norm: output, new running mean and var (the JAX
    stats protocol), and the gradients for x, gamma, beta and the
    residual, which flow through the batch moments."""
    rng = np.random.RandomState(4)
    c = SHAPE[-1]
    x = _rand(rng, SHAPE, 2.0) + 0.5
    gamma, beta = 1 + _rand(rng, (c,), 0.2), _rand(rng, (c,), 0.2)
    rm, rv = _rand(rng, (c,), 0.2), 1 + np.abs(_rand(rng, (c,), 0.2))
    res = _rand(rng, SHAPE) if residual else None
    ct = _rand(rng, SHAPE)

    def f(x, g, b, r):
        out, nm, nv = jfused.batch_norm(
            x, g, b, jnp.asarray(rm), jnp.asarray(rv), momentum=0.9,
            eps=1e-5, training=training, axis=-1, act_type=act,
            residual=r, interpret=True)
        return jnp.sum(out * ct), (out, nm, nv)

    jres = None if res is None else jnp.asarray(res)
    (_, (want, wnm, wnv)), grads = jax.value_and_grad(
        f, (0, 1, 2) + ((3,) if residual else ()), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jres)
    ts = [_t(x), _t(gamma), _t(beta)] + ([_t(res)] if residual else [])
    got, nm, nv = fused.batch_norm(
        ts[0], ts[1], ts[2], torch.tensor(rm), torch.tensor(rv),
        momentum=0.9, eps=1e-5, training=training, axis=-1, act_type=act,
        residual=ts[3] if residual else None)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(nm.numpy(), np.asarray(wnm), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(wnv), **TOL)
    assert not nm.requires_grad and not nv.requires_grad
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


POOLS = [((2, 7, 7, 16), (7, 7)), ((2, 8, 12, 16), (2, 3)),
         ((1, 4, 4, 8), (1, 1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pool", POOLS,
                         ids=["global7x7", "2x3", "1x1"])
def test_avg_pool2d_and_gradient_match_jax(shape, pool, dtype):
    """B2 forward and its gradient (B3's plain version inside the port's
    Function) against the JAX op through its Pallas kernels."""
    rng = np.random.RandomState(5)
    x = _rand(rng, shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(
        lambda a: jfused.avg_pool2d(a, pool, interpret=True), xj)
    dy = _rand(rng, want.shape)
    (wgrad,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    got = fused.avg_pool2d(xt, pool)
    got.backward(torch.tensor(dy).to(tdt))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    assert got.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(wgrad, np.float32), **tol)


@pytest.mark.parametrize("shape,pool", POOLS[:2], ids=["global7x7", "2x3"])
def test_avg_pool2d_bwd_plain_matches_pallas_kernel(shape, pool):
    n, h, w, c = shape
    ph, pw = pool
    dy = _rand(np.random.RandomState(6), (n, h // ph, w // pw, c))
    want = PK.avg_pool2d_bwd(jnp.asarray(dy), h, w, ph, pw, interpret=True)
    got = fused.avg_pool2d_bwd_ref(torch.tensor(dy), h, w, ph, pw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: they launch or
    raise."""
    x = torch.zeros(4, 8)
    row = torch.zeros(8)
    kernels.reset_launch_counts()
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.scale_shift_act_cuda(x, row, row, None, "relu")
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.avg_pool2d_fwd_cuda(torch.zeros(1, 2, 2, 8), 2, 2)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.avg_pool2d_bwd_cuda(torch.zeros(1, 1, 1, 8), 2, 2, 2, 2)
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}


def test_apply_refuses_channels_first_on_cuda_only():
    """A channels-first apply runs the plain version on the CPU (as the
    JAX package falls back there) and has no kernel path on the card."""
    d = _apply_inputs(seed=7)
    x = torch.tensor(d["x"]).permute(0, 3, 1, 2)
    out = fused.norm_act_residual(x, torch.tensor(d["scale"]),
                                  torch.tensor(d["shift"]), None, "relu",
                                  axis=1)
    want = fused.apply_ref(x, torch.tensor(d["scale"]),
                           torch.tensor(d["shift"]), None, "relu", 1)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported fused activation"):
        fused.bias_act(x, torch.zeros(16), act_type="softsign")


def test_layout_copies_are_counted():
    fused.reset_layout_copies()
    t = torch.zeros(2, 3, 4, 8)
    assert fused.contiguous_counted(t) is t
    v = fused.contiguous_counted(t.permute(0, 2, 1, 3))
    assert v.is_contiguous() and fused.layout_copies() == 1
    fused.reset_layout_copies()
    assert fused.layout_copies() == 0


@pytest.mark.parametrize("name", [
    "convolution", "fully_connected", "batch_norm", "pooling", "activation",
    "relu", "add", "log_softmax", "pick", "sum", "mean", "reshape",
    "fused_batch_norm", "fused_avg_pool2d", "fused_bias_act",
    "fused_norm_act_residual", "fused_bn_inference"])
@jax_amp_restored()
def test_amp_policy_matches_jax_dispatch(name):
    """Under bf16 AMP the port casts each op to the dtype the JAX
    package's dispatch picks (name lists first, then the op's class)."""
    cls = {"fused_batch_norm": "unsafe", "fused_avg_pool2d": "safe",
           "fused_bias_act": "safe", "fused_norm_act_residual": "unsafe",
           "fused_bn_inference": "unsafe"}.get(name, "neutral")
    try:
        info = jregistry.get_op("npx." + name)
    except Exception:
        info = None
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        want = jregistry._amp_dtype(name, info)
        got = tamp.op_dtype(name, cls)
    finally:
        jamp.uninit()
        tamp.uninit()
    assert got == want
