"""PyTorch port: the input path's augment (crop, mirror, 1/255, mean/std,
cast) against the JAX package's `ops.fused.image_augment`, on the CPU,
over every input type (uint8, int8, int16, int32, int64, bool, float32)
and channel count it serves.

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
    route = "table" if in_dtype == torch.uint8 else "direct"
    assert args[:4] == (kernels.DTYPE_CODES[in_dtype],
                        kernels.DTYPE_CODES[out_dtype],
                        kernels._AUGMENT_ROUTES[route], 0)
    assert args[5] == x.numel() * x.element_size()
    assert args[10:18] == (4, 10, 9, 3, 8, 8, 3, 3)
    mean = ctypes.cast(args[18], ctypes.POINTER(ctypes.c_float))
    assert [mean[i] for i in range(3)] == pytest.approx(MEAN)
    assert args[19] == args[21] == 3 and args[22] is None
    assert kernels.launch_counts()["image_augment"] == 1
    assert kernels.launch_counts()[f"image_augment_{route}"] == 1
    assert kernels.launch_counts_by_dtype() == {
        ("image_augment", str(out_dtype).replace("torch.", "")): 1}


def test_cuda_batch_reaches_the_wrapper_never_the_plain_version(fake_lib):
    x = _cuda(torch.zeros((2, 6, 6, 3), dtype=torch.uint8))
    fused._augment_apply(x, None, None, None, None, MEAN, None,
                         torch.float32)
    assert fake_lib.calls[-1][6:9] == (None, None, None)
    assert kernels.launch_counts()["image_augment"] == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib):
    x = _cuda(torch.zeros((2, 6, 6, 3), dtype=torch.uint8))
    y0 = _cuda(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(MXNetError, match="crop 7x6 does not fit"):
        kernels.image_augment_cuda(x, None, None, None, (7, 6), None, None,
                                   torch.float32)
    with pytest.raises(MXNetError, match="needs both y0 and x0"):
        kernels.image_augment_cuda(x, None, None, None, (4, 4), None, None,
                                   torch.float32)
    # a crop that cuts reads 3 channels: the JAX package's dynamic_slice
    # refuses one channel too
    with pytest.raises(MXNetError, match="reads the first 3 channels"):
        kernels.image_augment_cuda(x[..., :1].contiguous(), y0, y0, None,
                                   (4, 4), None, None, torch.float32)
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


# ---------------------------------------------------------------------------
# C11-C13: every type and channel count the JAX package serves
# ---------------------------------------------------------------------------
def _typed(kind, shape, seed=0):
    """Pixels of `kind` from a seed, over the type's range (int64 past
    int32's, which JAX with 64-bit types off wraps to int32)."""
    rng = np.random.RandomState(seed)
    if kind == "bool":
        return rng.randint(0, 2, shape).astype(bool)
    if kind == "float32":
        return _images("float32", shape, seed)
    if kind == "int64":
        return rng.randint(-2 ** 40, 2 ** 40, shape, dtype=np.int64)
    info = np.iinfo(kind)
    return rng.randint(info.min, int(info.max) + 1, shape,
                       dtype=np.int64).astype(kind)


def _jax_and_port(x, crop, mirror, mean, std, out, key=(11, 3)):
    key = np.array(key, np.uint32)
    want = jfused.image_augment(jnp.asarray(x), key, mean=mean, std=std,
                                crop_hw=crop, rand_mirror=mirror,
                                out_dtype=out)
    n, h, w = x.shape[:3]
    y0, x0, flips = _jax_draws(key, n, h, w, crop, mirror)
    got = fused._augment_apply(torch.from_numpy(x), _t(y0, np.int32),
                               _t(x0, np.int32), _t(flips), crop, mean,
                               std, getattr(torch, out))
    return got, np.asarray(want.astype(jnp.float32))


def _equal(got, want):
    """Bit for bit: both run the same rounded ops in the same order."""
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


DTYPE_CASES = [(kind, out, setting)
               for kind in ("bool", "int8", "int16", "int32", "int64")
               for out in ("float32", "bfloat16", "float16")
               for setting in ("full-norm", "crop-mirror-norm", "raw")]


@pytest.mark.parametrize("kind,out,setting", DTYPE_CASES,
                         ids=[f"{k}-{o}-{s}" for k, o, s in DTYPE_CASES])
def test_every_integer_and_bool_type_matches_jax(kind, out, setting):
    """C11 (bool read as 0 / 1, not scaled) and int64 (narrowed to int32
    as JAX does); int8-int32 show the CPU side of C12."""
    x = _typed(kind, (3, 8, 7, 3), seed=len(kind))
    crop, mirror = ((6, 5), True) if setting.startswith("crop") \
        else (None, False)
    mean, std = (MEAN, STD) if setting.endswith("norm") else (None, None)
    got, want = _jax_and_port(x, crop, mirror, mean, std, out)
    _equal(got, want)


CHANNEL_CASES = [
    # (C, crop, mean, std): the channels read and their broadcast
    (1, None, MEAN, STD), (1, None, (0.5,), (0.25,)), (1, None, None, None),
    (1, (8, 7), MEAN, None), (1, None, 0.5, STD),
    (4, None, (0.5,), (0.25,)), (4, None, None, None),
    (4, None, (0.1, 0.2, 0.3, 0.4), 0.5),
    (4, (6, 5), MEAN, STD), (4, (6, 5), (0.5,), None),
    (4, (6, 5), None, None), (5, (8, 6), MEAN, (0.2,)),
    (3, None, 0.5, 0.25)]


@pytest.mark.parametrize("c,crop,mean,std", CHANNEL_CASES,
                         ids=[f"C{c}-{'cut' if cr and cr != (8, 7) else 'full'}"
                              f"-m{'-' if m is None else np.size(m)}"
                              f"-s{'-' if s is None else np.size(s)}-{i}"
                              for i, (c, cr, m, s) in
                              enumerate(CHANNEL_CASES)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_every_channel_count_matches_jax(c, crop, mean, std, out):
    """C12's CPU side and C13: all C channels read where nothing is cut,
    the first 3 under a crop that cuts, broadcast with mean and std as
    numpy broadcasts (a scalar too)."""
    x = _typed("uint8", (3, 8, 7, c), seed=c)
    got, want = _jax_and_port(x, crop, True, mean, std, out)
    _equal(got, want)


REFUSED = [(1, (6, 5), None, "reads the first 3 channels"),
           (2, (6, 5), MEAN, "reads the first 3 channels"),
           (2, None, MEAN, "do not broadcast"),
           (4, (6, 5), (0.1, 0.2, 0.3, 0.4), "do not broadcast"),
           (3, None, (0.1, 0.2), "do not broadcast"),
           (3, (9, 7), None, "does not fit")]


@pytest.mark.parametrize("c,crop,mean,match", REFUSED)
def test_the_port_refuses_what_the_jax_package_refuses(c, crop, mean,
                                                       match):
    """C13: a crop that cuts on fewer than 3 channels is dynamic_slice's
    TypeError in the JAX package; mean / std that do not broadcast its
    ValueError. The plain version, the gradient path and the table
    (`kernels.refusal`) refuse them alike."""
    x = _typed("uint8", (2, 8, 7, c), seed=1)
    with pytest.raises((TypeError, ValueError)):
        jfused.image_augment(jnp.asarray(x), np.array([1, 2], np.uint32),
                             mean=mean, crop_hw=crop)
    y0 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(MXNetError, match=match):
        fused._augment_apply(torch.from_numpy(x), y0, y0, None, crop, mean,
                             None)
    with pytest.raises(MXNetError, match=match):
        fused._augment_apply(torch.from_numpy(x).float().requires_grad_(),
                             y0, y0, None, crop, mean, None)
    h, w = crop or (8, 7)
    assert match in kernels.refusal(
        "image_augment", h=8, w=7, ch=h, cw=w, c=c,
        lm=None if mean is None else len(mean), ls=None)


def test_cut_crop_refusal_is_the_jax_packages_type_error():
    x = np.zeros((2, 5, 6, 1), np.uint8)
    with pytest.raises(TypeError, match="out of range"):
        jfused.image_augment(jnp.asarray(x), np.array([1, 2], np.uint32),
                             crop_hw=(3, 4))
    assert kernels.refusal("image_augment", h=5, w=6, ch=3, cw=4, c=1) \
        == "a crop that cuts reads the first 3 channels; the images have 1"
    # the same crop on 3 channels, or the whole image on 1, is served
    assert kernels.refusal("image_augment", h=5, w=6, ch=3, cw=4, c=3) \
        is None
    assert kernels.refusal("image_augment", h=5, w=6, ch=5, cw=6, c=1) \
        is None


@pytest.mark.parametrize("c,crop", [(1, None), (4, (6, 5)), (3, (6, 5))])
def test_gradient_through_channels_matches_jax_grad(c, crop):
    """The float input's backward: summed over the channels a 1-channel
    image broadcast to, scattered into the first 3 under a cut."""
    n, h, w = 2, 8, 7
    x = _typed("float32", (n, h, w, c), seed=5)
    key = np.array([5, 9], np.uint32)
    cout = 3
    ct = np.random.RandomState(3).randn(
        n, *(crop or (h, w)), cout).astype(np.float32)

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


# ---------------------------------------------------------------------------
# the table route's exactness, emulated in plain torch
# ---------------------------------------------------------------------------
TABLE_CASES = [(kind, out, norm)
               for kind in ("uint8", "int8", "bool")
               for out in ("float32", "bfloat16", "float16")
               for norm in ("imagenet", "none", "broadcast")]


@pytest.mark.parametrize("kind,out,norm", TABLE_CASES,
                         ids=[f"{k}-{o}-{n}" for k, o, n in TABLE_CASES])
def test_gathered_table_is_the_plain_version_bit_for_bit(kind, out, norm):
    """The kernel's "table" route builds table[c][v] by the plain
    version's rounded ops for each of the 256 patterns v and gathers it at
    each pixel's byte: the gather equals `image_augment_ref` bit for bit
    (a 1-channel image under a 3-entry mean in "broadcast")."""
    c = 1 if norm == "broadcast" else 3
    mean, std = {"imagenet": (MEAN, STD), "none": (None, None),
                 "broadcast": (MEAN, (0.5,))}[norm]
    x = torch.from_numpy(_typed(kind, (4, 9, 8, c), seed=7))
    y0 = torch.tensor([0, 2, -1, 5], dtype=torch.int32)
    x0 = torch.tensor([1, 0, 3, -2], dtype=torch.int32)
    flips = torch.tensor([1, 0, 1, 1], dtype=torch.uint8)
    crop = (7, 6) if c == 3 else None
    dt = getattr(torch, out)
    want = fused.image_augment_ref(x, y0, x0, flips, crop, mean, std, dt)
    table = fused.augment_table_ref(x.dtype, 3, mean, std, dt)
    assert table.shape == (3, 256) and table.dtype == dt
    # the pixel bytes the kernel reads: cut, mirrored, broadcast
    b = x.view(torch.uint8) if x.dtype != torch.bool else x.to(torch.uint8)
    if crop:
        rows = fused._start(y0, 9, 7)[:, None] + torch.arange(7)
        cols = fused._start(x0, 8, 6)[:, None] + torch.arange(6)
        b = b[torch.arange(4)[:, None, None], rows[:, :, None],
              cols[:, None, :], :3]
    b = torch.where(flips.bool()[:, None, None, None], b.flip(2), b)
    b = b.expand(*b.shape[:3], 3).long()
    got = table[torch.arange(3), b]
    assert torch.equal(got, want)
    # an entry one unit in the last place off is refused
    bad = table.clone()
    v = int(b[0, 0, 0, 1])
    bad[1, v] = torch.nextafter(bad[1, v].float(), torch.tensor(
        float("inf"))).to(dt) if dt == torch.float32 else \
        (bad[1, v].view(torch.int16) + 1).view(dt)
    assert not torch.equal(bad[torch.arange(3), b], want)


# ---------------------------------------------------------------------------
# C12 on the card's side: every new type and channel case reaches the
# kernel, never the plain version (the launch faked)
# ---------------------------------------------------------------------------
WRAPPER_TYPES = [(torch.bool, torch.bool, "table"),
                 (torch.int8, torch.int8, "table"),
                 (torch.int16, torch.int16, "direct"),
                 (torch.int32, torch.int32, "direct"),
                 (torch.int64, torch.int32, "direct"),
                 (torch.float32, torch.float32, "direct")]


@pytest.mark.parametrize("dtype,passed,route", WRAPPER_TYPES)
def test_cuda_batch_of_each_type_reaches_the_kernel(fake_lib, monkeypatch,
                                                    dtype, passed, route):
    monkeypatch.setattr(fused, "image_augment_ref", None)   # never called
    x = _cuda(torch.zeros((2, 6, 6, 3), dtype=dtype))
    out = fused._augment_apply(x, None, None, None, None, MEAN, STD,
                               torch.bfloat16)
    assert out.shape == (2, 6, 6, 3) and out.dtype == torch.bfloat16
    args = fake_lib.calls[-1]
    assert args[0] == kernels.DTYPE_CODES[passed]
    assert args[2] == kernels._AUGMENT_ROUTES[route]
    assert kernels.launch_counts()["image_augment"] == 1
    assert kernels.launch_counts()[f"image_augment_{route}"] == 1


WRAPPER_CHANNELS = [
    # (C, crop, mean, std, (cr, cout, lm, ls), route)
    (1, None, MEAN, STD, (1, 3, 3, 3), "table"),
    (1, None, (0.5,), None, (1, 1, 1, 0), "table"),
    (4, None, (0.5,), (0.25,), (4, 4, 1, 1), "table"),
    (4, (4, 5), MEAN, STD, (3, 3, 3, 3), "table"),
    (5, None, None, None, (5, 5, 0, 0), "direct"),
    (1, None, tuple(0.01 * i for i in range(70)), None, (1, 70, 70, 0),
     "direct")]


@pytest.mark.parametrize("c,crop,mean,std,chans,route", WRAPPER_CHANNELS)
def test_wrapper_passes_channels_and_broadcast(fake_lib, monkeypatch, c,
                                               crop, mean, std, chans,
                                               route):
    far = []
    monkeypatch.setattr(kernels, "_device_floats",
                        lambda v, dev: far.append(v) or torch.tensor(v))
    x = _cuda(torch.zeros((2, 6, 7, c), dtype=torch.uint8))
    y0 = _cuda(torch.zeros(2, dtype=torch.int32)) if crop else None
    out = kernels.image_augment_cuda(x, y0, y0, None, crop or (6, 7), mean,
                                     std, torch.float16)
    args = fake_lib.calls[-1]
    cr, cout, lm, ls = chans
    assert out.shape == (2, *(crop or (6, 7)), cout)
    assert args[13] == c and args[16:18] == (cr, cout)
    assert (args[19], args[21]) == (lm, ls)
    assert args[2] == kernels._AUGMENT_ROUTES[route]
    if lm > kernels.AUGMENT_PARAM_CHANNELS:
        # past 64 entries the whole of mean then std goes by the card
        assert far == [list(mean)] and args[22] is not None
        assert len(args[18]) == kernels.AUGMENT_PARAM_CHANNELS
    else:
        assert far == [] and args[22] is None


def test_unaligned_view_is_staged_like_any_batch(fake_lib):
    """A view one byte into its buffer takes the table route: the kernel
    copies the 16-byte chunks that cover each span and the tensor's first
    and last bytes one by one; only a pixel too wide to stage goes
    "scalar"."""
    flat = torch.zeros(2 * 6 * 6 * 3 + 1, dtype=torch.uint8)
    x = _cuda(flat[1:].view(2, 6, 6, 3))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    kernels.image_augment_cuda(x, None, None, None, (6, 6), MEAN, STD,
                               torch.float32)
    assert fake_lib.calls[-1][2] == kernels._AUGMENT_ROUTES["table"]
    assert fake_lib.calls[-1][4] == x.data_ptr()
    wide = _cuda(torch.zeros((1, 2, 2, 3100), dtype=torch.float32))
    kernels.image_augment_cuda(wide, None, None, None, (2, 2), (0.5,),
                               None, torch.float32)
    assert fake_lib.calls[-1][2] == kernels._AUGMENT_ROUTES["scalar"]
    assert kernels.launch_counts()["image_augment_table"] == 1
    assert kernels.launch_counts()["image_augment_scalar"] == 1
