"""PyTorch port: the input path's augment (crop, mirror, 1/255, mean/std,
cast) against the JAX package's `ops.fused.image_augment`, on the CPU.

The JAX function draws its crop offsets and mirror bits from
`jax.random` (key split into crop / mirror keys, the crop key split into y
/ x); the test recomputes those draws with the same split order and hands
them to the port's `_augment_apply`, the function the CUDA kernel
(`ops/csrc/image_augment.cu`) is held against on the card. Tolerances:
float32 out within 1e-6 (relative and absolute; XLA and PyTorch round the
same four ops), bfloat16 / float16 out at most one step of the type
apart; the gradient of a float input within 1e-6 of `jax.grad`.

The port draws from a `torch.Generator` seeded by the (epoch seed, batch)
key instead of `jax.random`: a deliberate difference, pinned here as a
deterministic function of the key.
"""
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.ops import fused, kernels

from test_torch_coverage import _cuda

torch.set_num_threads(1)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STEP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _jax_draws(key, n, h, w, crop_hw, rand_mirror):
    """The draws `jfused.image_augment` makes, in its split order."""
    kc, km = jax.random.split(jnp.asarray(key))
    y0 = x0 = flips = None
    if crop_hw is not None and (h, w) != tuple(crop_hw):
        ch, cw = crop_hw
        ky, kx = jax.random.split(kc)
        y0 = np.asarray(jax.random.randint(ky, (n,), 0, h - ch + 1))
        x0 = np.asarray(jax.random.randint(kx, (n,), 0, w - cw + 1))
    if rand_mirror:
        flips = np.asarray(jax.random.bernoulli(km, 0.5, (n,)))
    return y0, x0, flips


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(
        np.asarray(a, dtype) if dtype else np.asarray(a))


def _images(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, shape).astype(np.uint8)
    return u8 if kind == "uint8" else (u8 / 255.0).astype(np.float32)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    step = STEP[dtype]
    if step == 0.0:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    scale = np.maximum(np.abs(want), 2.0 ** -14)
    assert (np.abs(got - want) <= step * scale * 1.0001).all(), \
        float(np.abs(got - want).max())


CASES = [(kind, out, crop, mirror, norm)
         for kind in ("uint8", "float32")
         for out in ("float32", "bfloat16", "float16")
         for crop, mirror, norm in ((None, False, True), (None, True, True),
                                    ((6, 5), True, True),
                                    ((6, 5), False, False))]


@pytest.mark.parametrize("kind,out,crop,mirror,norm", CASES,
                         ids=[f"{k}-{o}-{'crop' if c else 'full'}-"
                              f"{'mirror' if m else 'plain'}-"
                              f"{'norm' if n else 'raw'}"
                              for k, o, c, m, n in CASES])
def test_plain_augment_matches_jax_on_its_draws(kind, out, crop, mirror,
                                                norm):
    n, h, w = 4, 8, 7
    x = _images(kind, (n, h, w, 3))
    key = np.array([11, 3], np.uint32)
    mean, std = (MEAN, STD) if norm else (None, None)
    want = jfused.image_augment(jnp.asarray(x), key, mean=mean, std=std,
                                crop_hw=crop, rand_mirror=mirror,
                                out_dtype=out)
    y0, x0, flips = _jax_draws(key, n, h, w, crop, mirror)
    got = fused._augment_apply(torch.from_numpy(x), _t(y0, np.int32),
                               _t(x0, np.int32), _t(flips), crop, mean,
                               std, getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), out)


def test_gradient_of_a_float_input_matches_jax_grad():
    n, h, w, crop = 3, 9, 8, (6, 5)
    x = _images("float32", (n, h, w, 3), seed=2)
    key = np.array([5, 9], np.uint32)
    ct = np.random.RandomState(3).randn(n, 6, 5, 3).astype(np.float32)

    def jloss(v):
        out = jfused.image_augment(v, key, mean=MEAN, std=STD, crop_hw=crop,
                                   rand_mirror=True)
        return (out * ct).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    y0, x0, flips = _jax_draws(key, n, h, w, crop, True)
    xt = torch.from_numpy(x).requires_grad_()
    out = fused._augment_apply(xt, _t(y0, np.int32), _t(x0, np.int32),
                               _t(flips), crop, MEAN, STD, torch.float32)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_offsets_outside_the_image_are_read_as_dynamic_slice_starts():
    x = _images("uint8", (2, 6, 6, 3))
    y0 = torch.tensor([-3, 9], dtype=torch.int32)
    x0 = torch.tensor([5, -1], dtype=torch.int32)
    got = fused.image_augment_ref(torch.from_numpy(x), y0, x0, None, (4, 4))
    want = [jax.lax.dynamic_slice(jnp.asarray(x[i]) * (1.0 / 255.0),
                                  (int(y0[i]), int(x0[i]), 0), (4, 4, 3))
            for i in range(2)]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_port_draws_are_a_deterministic_function_of_the_key():
    """The deliberate difference: the port's draws come from a generator
    seeded by (epoch seed, batch), not from jax.random."""
    a = fused.augment_draws((7, 2), 16, (40, 40), (32, 32), True, "cpu")
    b = fused.augment_draws((7, 2), 16, (40, 40), (32, 32), True, "cpu")
    c = fused.augment_draws((7, 3), 16, (40, 40), (32, 32), True, "cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert any(not torch.equal(u, v) for u, v in zip(a, c))
    y0, x0, flips = a
    assert y0.dtype == x0.dtype == torch.int32 and flips.dtype == torch.uint8
    assert int(y0.min()) >= 0 and int(y0.max()) <= 8
    assert set(flips.tolist()) <= {0, 1}
    # no crop and no mirror draw nothing
    assert fused.augment_draws((7, 2), 4, (8, 8), None, False, "cpu") \
        == (None, None, None)
    # they differ from the JAX package's draws from the same key
    jy0, _, jflips = _jax_draws(np.array([7, 2], np.uint32), 16, 40, 40,
                                (32, 32), True)
    assert not (np.array_equal(jy0, y0.numpy())
                and np.array_equal(jflips, flips.numpy().astype(bool)))


def test_image_augment_is_augment_apply_on_its_draws():
    x = torch.from_numpy(_images("uint8", (4, 10, 9, 3)))
    got = fused.image_augment(x, (3, 1), mean=MEAN, std=STD, crop_hw=(8, 8),
                              rand_mirror=True, out_dtype="bfloat16")
    draws = fused.augment_draws((3, 1), 4, (10, 9), (8, 8), True, "cpu")
    want = fused._augment_apply(x, *draws, (8, 8), MEAN, STD,
                                torch.bfloat16)
    assert torch.equal(got, want)


def test_npx_fused_image_augment_takes_ndarrays():
    x = _images("uint8", (2, 5, 5, 3))
    with tmx.cpu():
        got = tmx.npx.fused_image_augment(
            tmx.np.array(x), tmx.np.array(np.array([4, 2], np.uint32)),
            mean=MEAN, std=STD, rand_mirror=True, out_dtype="float16")
    assert isinstance(got, tmx.NDArray) and str(got.dtype) == "float16"
    want = fused.image_augment(torch.from_numpy(x), (4, 2), mean=MEAN,
                               std=STD, rand_mirror=True,
                               out_dtype="float16")
    assert torch.equal(got._t, want)
    # no crop and no mirror: the draws do not matter, so the JAX package's
    # npx op gives the same values
    jgot = jmx.npx.fused_image_augment(
        jmx.np.array(x), jmx.np.array(np.array([4, 2], np.uint32)),
        mean=MEAN, std=STD)
    with tmx.cpu():
        tgot = tmx.npx.fused_image_augment(tmx.np.array(x), [4, 2],
                                           mean=MEAN, std=STD)
    _close(tgot.asnumpy(), jgot.asnumpy(), "float32")


# ---------------------------------------------------------------------------
# the wrapper: arguments, codes and counts, with the launch faked
# ---------------------------------------------------------------------------
class _FakeLib:
    def __init__(self):
        self.calls = []

    def mx_image_augment(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(kernels, "_load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kernels.reset_launch_counts()
    yield lib
    kernels.reset_launch_counts()


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.uint8, torch.bfloat16), (torch.uint8, torch.float32),
    (torch.float32, torch.float16)])
def test_wrapper_passes_the_dtype_codes_and_counts(fake_lib, in_dtype,
                                                   out_dtype):
    x = _cuda(torch.zeros((4, 10, 9, 3), dtype=in_dtype))
    y0 = _cuda(torch.zeros(4, dtype=torch.int32))
    flips = _cuda(torch.zeros(4, dtype=torch.uint8))
    out = kernels.image_augment_cuda(x, y0, y0, flips, (8, 8), MEAN, STD,
                                     out_dtype)
    assert out.shape == (4, 8, 8, 3) and out.dtype == out_dtype
    args = fake_lib.calls[-1]
    assert args[:3] == (kernels.DTYPE_CODES[in_dtype],
                        kernels.DTYPE_CODES[out_dtype], 0)
    assert args[8:13] == (4, 10, 9, 8, 8)
    mean = ctypes.cast(args[13], ctypes.POINTER(ctypes.c_float))
    assert [mean[i] for i in range(3)] == pytest.approx(MEAN)
    assert kernels.launch_counts()["image_augment"] == 1
    assert kernels.launch_counts_by_dtype() == {
        ("image_augment", str(out_dtype).replace("torch.", "")): 1}


def test_cuda_batch_reaches_the_wrapper_never_the_plain_version(fake_lib):
    x = _cuda(torch.zeros((2, 6, 6, 3), dtype=torch.uint8))
    fused._augment_apply(x, None, None, None, None, MEAN, None,
                         torch.float32)
    assert fake_lib.calls[-1][4:7] == (None, None, None)
    assert kernels.launch_counts()["image_augment"] == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib):
    x = _cuda(torch.zeros((2, 6, 6, 3), dtype=torch.uint8))
    with pytest.raises(MXNetError, match="crop 7x6 does not fit"):
        kernels.image_augment_cuda(x, None, None, None, (7, 6), None, None,
                                   torch.float32)
    with pytest.raises(MXNetError, match="needs both y0 and x0"):
        kernels.image_augment_cuda(x, None, None, None, (4, 4), None, None,
                                   torch.float32)
    with pytest.raises(MXNetError, match="uint8 or float32"):
        kernels.image_augment_cuda(x.to(torch.int32), None, None, None,
                                   (6, 6), None, None, torch.float32)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.image_augment_cuda(torch.zeros((2, 6, 6, 3)), None, None,
                                   None, (6, 6), None, None, torch.float32)
    assert kernels.launch_counts()["image_augment"] == 0
    assert kernels.refusal("image_augment", h=6, w=6, ch=6, cw=6) is None


def test_a_crop_larger_than_the_images_is_the_jax_packages_refusal_too():
    x = jnp.zeros((2, 6, 6, 3), jnp.uint8)
    with pytest.raises(Exception):
        jfused.image_augment(x, np.array([1, 2], np.uint32), crop_hw=(7, 6))
    assert kernels.refusal("image_augment", h=6, w=6, ch=7, cw=6) \
        == "crop 7x6 does not fit the images 6x6"
